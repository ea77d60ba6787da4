"""The bit reader and the error that the reference's decoders share."""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


class FormatError(ValueError):
    """The stream breaks the format."""


class Bits:
    """Reads a byte string MSB-first, from a bit position."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        last = (end + 7) >> 3
        if last > len(self.data):
            raise FormatError("read past the end of the stream")
        v = int.from_bytes(self.data[pos >> 3:last], "big")
        self.pos = end
        return (v >> ((last << 3) - end)) & ((1 << n) - 1)

    def read_bytes(self, n: int) -> bytes:
        """`n` whole bytes from the current bit position."""
        return take_bits(self.data, self._advance(8 * n), 8 * n)

    def _advance(self, nbits: int) -> int:
        pos = self.pos
        if (pos + nbits + 7) >> 3 > len(self.data):
            raise FormatError("read past the end of the stream")
        self.pos = pos + nbits
        return pos


def take_bits(data: bytes, pos: int, nbits: int) -> bytes:
    """The `nbits` bits at bit `pos` as bytes, the last byte padded low."""
    nbytes = (nbits + 7) >> 3
    first, k = pos >> 3, pos & 7
    if k == 0:
        out = bytearray(data[first:first + nbytes])
    else:
        src = np.frombuffer(data[first:first + nbytes + 1], dtype=np.uint8).astype(np.uint16)
        if len(src) < nbytes + 1:
            src = np.concatenate([src, np.zeros(nbytes + 1 - len(src), np.uint16)])
        out = bytearray((((src[:-1] << k) | (src[1:] >> (8 - k))) & 0xFF).astype(np.uint8))
    if nbits & 7:
        out[-1] &= (0xFF << (8 - (nbits & 7))) & 0xFF
    return bytes(out)
