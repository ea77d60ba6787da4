"""XXHash32 (hash/XXHash32.go), the block checksum of the cells' streams."""

from __future__ import annotations

import struct

from .format import M32

MAGIC = 0x4B414E5A            # "KANZ", the seed of a block's checksum

P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def xxhash32(data: bytes, seed: int = MAGIC) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed & M32, (seed - P1) & M32]
        stripes = n // 16
        words = struct.unpack_from(f"<{4 * stripes}I", data)
        for lane in range(4):
            a = v[lane]
            for w in words[lane::4]:
                a = (a + w * P2) & M32
                a = (((a << 13) | (a >> 19)) & M32) * P1 & M32
            v[lane] = a
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M32
        i = 16 * stripes
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    while i + 4 <= n:
        h = (_rotl((h + struct.unpack_from("<I", data, i)[0] * P3) & M32, 17) * P4) & M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * P5) & M32, 11) * P1) & M32
        i += 1
    h ^= h >> 15
    h = (h * P2) & M32
    h ^= h >> 13
    h = (h * P3) & M32
    return h ^ (h >> 16)
