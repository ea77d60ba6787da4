"""XXHash32/64 block checksums (pure-Python fallback).

Semantics match the reference port (v2/hash/XXHash32.go, XXHash64.go) of Yann
Collet's xxHash, including one reference-specific quirk that is load-bearing
for bit-exact checksums: the 64-bit lane merge uses the *32-bit* rotate
amounts ((v1<<1)|(v1>>31) etc., v2/hash/XXHash64.go:72-73) instead of true
64-bit rotates. We replicate it exactly.

The native C++ library (kanzi_tpu_torch.native) provides the fast path; this module
is the always-available reference implementation used for small inputs and as
a correctness oracle in tests.
"""

from __future__ import annotations

import struct

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

_P32_1 = 2654435761
_P32_2 = 2246822519
_P32_3 = 3266489917
_P32_4 = 668265263
_P32_5 = 374761393

_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _round32(acc: int, val: int) -> int:
    acc = (acc + val * _P32_2) & _M32
    return (_rotl32(acc, 13) * _P32_1) & _M32


def xxhash32(data: bytes, seed: int) -> int:
    end = len(data)
    n = 0
    if end >= 16:
        v1 = (seed + _P32_1 + _P32_2) & _M32
        v2 = (seed + _P32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P32_1) & _M32
        nstripes = end // 16
        vals = struct.unpack_from(f"<{nstripes * 4}I", data)
        for i in range(0, nstripes * 4, 4):
            v1 = _round32(v1, vals[i])
            v2 = _round32(v2, vals[i + 1])
            v3 = _round32(v3, vals[i + 2])
            v4 = _round32(v4, vals[i + 3])
        n = nstripes * 16
        h32 = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
    else:
        h32 = (seed + _P32_5) & _M32

    h32 = (h32 + end) & _M32
    while n + 4 <= end:
        h32 = (h32 + struct.unpack_from("<I", data, n)[0] * _P32_3) & _M32
        h32 = (_rotl32(h32, 17) * _P32_4) & _M32
        n += 4
    while n < end:
        h32 = (h32 + data[n] * _P32_5) & _M32
        h32 = (_rotl32(h32, 11) * _P32_1) & _M32
        n += 1

    h32 ^= h32 >> 15
    h32 = (h32 * _P32_2) & _M32
    h32 ^= h32 >> 13
    h32 = (h32 * _P32_3) & _M32
    return h32 ^ (h32 >> 16)


def _round64(acc: int, val: int) -> int:
    acc = (acc + val * _P64_2) & _M64
    acc = ((acc << 31) | (acc >> 33)) & _M64
    return (acc * _P64_1) & _M64


def _merge64(acc: int, val: int) -> int:
    acc ^= _round64(0, val)
    return (acc * _P64_1 + _P64_4) & _M64


def xxhash64(data: bytes, seed: int) -> int:
    end = len(data)
    n = 0
    if end >= 32:
        v1 = (seed + _P64_1 + _P64_2) & _M64
        v2 = (seed + _P64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P64_1) & _M64
        nstripes = end // 32
        vals = struct.unpack_from(f"<{nstripes * 4}Q", data)
        for i in range(0, nstripes * 4, 4):
            v1 = _round64(v1, vals[i])
            v2 = _round64(v2, vals[i + 1])
            v3 = _round64(v3, vals[i + 2])
            v4 = _round64(v4, vals[i + 3])
        n = nstripes * 32
        # reference quirk: 32-bit rotate amounts on 64-bit lanes
        h64 = (((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25)) +
               ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14))) & _M64
        h64 = _merge64(h64, v1)
        h64 = _merge64(h64, v2)
        h64 = _merge64(h64, v3)
        h64 = _merge64(h64, v4)
    else:
        h64 = (seed + _P64_5) & _M64

    h64 = (h64 + end) & _M64
    while n + 8 <= end:
        h64 ^= _round64(0, struct.unpack_from("<Q", data, n)[0])
        h64 = (((h64 << 27) | (h64 >> 37)) & _M64) * _P64_1 + _P64_4
        h64 &= _M64
        n += 8
    while n + 4 <= end:
        h64 ^= (struct.unpack_from("<I", data, n)[0] * _P64_1) & _M64
        h64 = (((h64 << 23) | (h64 >> 41)) & _M64) * _P64_2 + _P64_3
        h64 &= _M64
        n += 4
    while n < end:
        h64 = (h64 + data[n] * _P64_5) & _M64
        h64 = (((h64 << 11) | (h64 >> 53)) & _M64) * _P64_1
        h64 &= _M64
        n += 1

    h64 ^= h64 >> 33
    h64 = (h64 * _P64_2) & _M64
    h64 ^= h64 >> 29
    h64 = (h64 * _P64_3) & _M64
    return h64 ^ (h64 >> 32)
