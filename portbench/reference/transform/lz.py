"""LZ inverse (transform/LZCodec.go, LZX layout); LZX shares it."""

from __future__ import annotations

import struct

from ..format import FormatError

IDS = (3, 16)


def _length(src: bytes, i: int) -> tuple[int, int]:
    b = src[i]
    if b < 254:
        return b, 1
    if b == 254:
        return 254 + (src[i + 1] << 8) + src[i + 2], 3
    return 255 + (src[i + 1] << 16) + (src[i + 2] << 8) + src[i + 3], 4


def inverse(src: bytes) -> bytearray:
    """Sections: 13-byte header (three little-endian section sizes and a
    flags byte), literals, tokens, distances, match length escapes."""
    src = bytes(src)
    count = len(src)
    if count < 13:
        raise FormatError("LZ block too short")
    lit_end = struct.unpack_from("<I", src, 0)[0]
    tk = lit_end
    m = tk + struct.unpack_from("<I", src, 4)[0]
    ml = m + struct.unpack_from("<I", src, 8)[0]
    if max(tk, m, ml) > count:
        raise FormatError("LZ sections")
    min_match = ((src[12] >> 1) & 7) + 2
    max_dist = (1 << 24) - 2 if src[12] & 1 else (1 << 16) - 2
    s = 13
    out = bytearray()
    rep0 = rep1 = count
    while True:
        if tk >= count:
            raise FormatError("LZ token past the end")
        token = src[tk]
        tk += 1
        if token >= 32:
            if token >= 0xE0:
                n, used = _length(src, s)
                s += used
                n += 7
            else:
                n = token >> 5
            if s + n > count:
                raise FormatError("LZ literals")
            out += src[s:s + n]
            s += n
            if s >= lit_end:
                break
        f = token & 0x18
        if f == 0:
            n = token & 3
            dist = rep0 if token & 4 == 0 else rep1
            if n == 3:
                extra, used = _length(src, ml)
                ml += used
                n += extra
        else:
            n = token & 7
            if n == 7:
                extra, used = _length(src, ml)
                ml += used
                n += extra
            dist = src[m]
            m += 1
            if f >= 0x10:
                dist = (dist << 8) | src[m]
                m += 1
                if f == 0x18:
                    dist = (dist << 8) | src[m]
                    m += 1
        n += min_match
        rep1, rep0 = rep0, dist
        ref = len(out) - dist
        if ref < 0 or dist > max_dist:
            raise FormatError("LZ distance")
        if dist >= n:
            out += out[ref:ref + n]
        else:
            piece = out[ref:]
            out += (piece * (n // dist + 1))[:n]
    if s != lit_end:
        raise FormatError("LZ literals left over")
    return out
