"""Range (entropy/RangeCodec.go): 32 KiB chunks, 60-bit state, 28-bit reads."""

from __future__ import annotations

from ..format import M64, Bits, FormatError
from ..freqs import read_alphabet, read_frequencies, slots

IDS = (4,)

RANGE_CHUNK = 1 << 15
TOP_RANGE = 0x0FFFFFFFFFFFFFFF
BOTTOM_RANGE = 0xFFFF
RANGE_MASK = 0x0FFFFFFF00000000


def decode(bits: Bits, length: int) -> bytearray:
    out = bytearray(length)
    data = bits.data
    for start in range(0, length, RANGE_CHUNK):
        end = min(start + RANGE_CHUNK, length)
        alphabet = read_alphabet(bits)
        if not alphabet:
            raise FormatError("empty range alphabet")
        lr = 8 + bits.read(3)
        if len(alphabet) == 1:
            out[start:end] = bytes((alphabet[0],)) * (end - start)
            continue
        freqs = read_frequencies(bits, alphabet, lr)
        f2s, cum = slots(freqs, lr)
        nslots = len(f2s)
        rng, low, code = TOP_RANGE, 0, bits.read(60)
        pos = bits.pos
        for i in range(start, end):
            rng >>= lr
            q = ((code - low) & M64) // rng
            if q >= nslots:
                raise FormatError("range state")
            s = f2s[q]
            c = cum[s]
            low = (low + c * rng) & M64
            rng = (rng * (cum[s + 1] - c)) & M64
            while True:
                if (low ^ (low + rng)) & RANGE_MASK:
                    if rng > BOTTOM_RANGE:
                        break
                    rng = (-low) & BOTTOM_RANGE
                e = pos + 28
                last = (e + 7) >> 3
                word = (int.from_bytes(data[pos >> 3:last], "big") >> ((last << 3) - e)) & 0xFFFFFFF
                pos = e
                code = ((code << 28) | word) & M64
                rng = (rng << 28) & M64
                low = (low << 28) & M64
            out[i] = s
        if (pos + 7) >> 3 > len(data):
            raise FormatError("range payload cut short")
        bits.pos = pos
    return out
