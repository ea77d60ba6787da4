"""ANS order 1 (entropy/ANSRangeCodec.go): 4 MiB chunks, 4 states over quarters."""

from __future__ import annotations

from ..format import Bits, FormatError
from ..freqs import read_alphabet, read_frequencies, slots

IDS = (8,)

ANS_TOP = 1 << 15
ANS1_CHUNK = 16384 << 8


def decode(bits: Bits, length: int) -> bytearray:
    if length <= 32:
        return bytearray(bits.read_bytes(length))
    out = bytearray(length)
    for start in range(0, length, ANS1_CHUNK):
        end = min(start + ANS1_CHUNK, length)
        lr = 8 + bits.read(3)
        if lr > 16:
            raise FormatError("ANS log range")
        mask = (1 << lr) - 1
        f2s, freq, cum = [], [], []
        any_symbol = False
        for _ in range(256):
            alphabet = read_alphabet(bits)
            if alphabet:
                any_symbol = True
                f = read_frequencies(bits, alphabet, lr)
                t, c = slots(f, lr)
            else:
                f, t, c = [0] * 256, bytes(1 << lr), [0] * 257
            # a symbol's frequency is held below the scale (DecSymbol.reset)
            freq.append([min(x, mask) for x in f])
            f2s.append(t)
            cum.append(c)
        if not any_symbol:
            raise FormatError("empty ANS header")
        out[start:end] = _ans1_chunk(bits, end - start, lr, f2s, freq, cum)
    return out


def _ans1_chunk(bits: Bits, n: int, lr: int, f2s, freq, cum) -> bytearray:
    size = 0
    for k in range(5):
        b = bits.read(8)
        size |= (b & (0x7F if k < 4 else 0x0F)) << (7 * k)
        if b < 128:
            break
    states = [bits.read(32) for _ in range(4)]
    if size > max(2 * n, 256):
        raise FormatError("ANS chunk size")
    buf = bits.read_bytes(size) + bytes(64)
    out = bytearray(n)
    mask = (1 << lr) - 1
    quarter = (n & ~3) >> 2
    p = 0
    st0, st1, st2, st3 = states
    pv0 = pv1 = pv2 = pv3 = 0
    for i in range(quarter):
        c = f2s[pv3][st3 & mask]
        out[3 * quarter + i] = c
        st3 = freq[pv3][c] * (st3 >> lr) + (st3 & mask) - cum[pv3][c]
        if st3 < ANS_TOP:
            st3 = (st3 << 16) | (buf[p] << 8) | buf[p + 1]
            p += 2
        pv3 = c
        c = f2s[pv2][st2 & mask]
        out[2 * quarter + i] = c
        st2 = freq[pv2][c] * (st2 >> lr) + (st2 & mask) - cum[pv2][c]
        if st2 < ANS_TOP:
            st2 = (st2 << 16) | (buf[p] << 8) | buf[p + 1]
            p += 2
        pv2 = c
        c = f2s[pv1][st1 & mask]
        out[quarter + i] = c
        st1 = freq[pv1][c] * (st1 >> lr) + (st1 & mask) - cum[pv1][c]
        if st1 < ANS_TOP:
            st1 = (st1 << 16) | (buf[p] << 8) | buf[p + 1]
            p += 2
        pv1 = c
        c = f2s[pv0][st0 & mask]
        out[i] = c
        st0 = freq[pv0][c] * (st0 >> lr) + (st0 & mask) - cum[pv0][c]
        if st0 < ANS_TOP:
            st0 = (st0 << 16) | (buf[p] << 8) | buf[p + 1]
            p += 2
        pv0 = c
    tail = n - 4 * quarter
    out[4 * quarter:] = buf[p:p + tail]
    return out
