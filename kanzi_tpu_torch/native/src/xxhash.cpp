// XXHash32/64 block checksums. Semantics match kanzi_tpu_torch/xxhash.py (the
// Python oracle), including the reference's 32-bit rotate quirk in the
// 64-bit lane merge (v2/hash/XXHash64.go:72-73).

#include "kz.h"

namespace kz {

static constexpr u32 P32_1 = 2654435761u, P32_2 = 2246822519u,
                     P32_3 = 3266489917u, P32_4 = 668265263u, P32_5 = 374761393u;
static constexpr u64 P64_1 = 0x9E3779B185EBCA87ull, P64_2 = 0xC2B2AE3D27D4EB4Full,
                     P64_3 = 0x165667B19E3779F9ull, P64_4 = 0x85EBCA77C2B2AE63ull,
                     P64_5 = 0x27D4EB2F165667C5ull;

static inline u32 rotl32(u32 x, int n) { return (x << n) | (x >> (32 - n)); }

static inline u32 le32(const u8* p) {
    u32 v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline u64 le64(const u8* p) {
    u64 v;
    std::memcpy(&v, p, 8);
    return v;
}

static inline u32 round32(u32 acc, u32 val) {
    return rotl32(acc + val * P32_2, 13) * P32_1;
}

u32 xxhash32(const u8* data, i64 end, u32 seed) {
    u32 h32;
    i64 n = 0;
    if (end >= 16) {
        u32 v1 = seed + P32_1 + P32_2, v2 = seed + P32_2, v3 = seed, v4 = seed - P32_1;
        for (; n + 16 <= end; n += 16) {
            v1 = round32(v1, le32(data + n));
            v2 = round32(v2, le32(data + n + 4));
            v3 = round32(v3, le32(data + n + 8));
            v4 = round32(v4, le32(data + n + 12));
        }
        h32 = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h32 = seed + P32_5;
    }
    h32 += (u32)end;
    for (; n + 4 <= end; n += 4) h32 = rotl32(h32 + le32(data + n) * P32_3, 17) * P32_4;
    for (; n < end; n++) h32 = rotl32(h32 + data[n] * P32_5, 11) * P32_1;
    h32 ^= h32 >> 15;
    h32 *= P32_2;
    h32 ^= h32 >> 13;
    h32 *= P32_3;
    return h32 ^ (h32 >> 16);
}

static inline u64 round64(u64 acc, u64 val) {
    acc += val * P64_2;
    acc = (acc << 31) | (acc >> 33);
    return acc * P64_1;
}

static inline u64 merge64(u64 acc, u64 val) {
    acc ^= round64(0, val);
    return acc * P64_1 + P64_4;
}

u64 xxhash64(const u8* data, i64 end, u64 seed) {
    u64 h64;
    i64 n = 0;
    if (end >= 32) {
        u64 v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed, v4 = seed - P64_1;
        for (; n + 32 <= end; n += 32) {
            v1 = round64(v1, le64(data + n));
            v2 = round64(v2, le64(data + n + 8));
            v3 = round64(v3, le64(data + n + 16));
            v4 = round64(v4, le64(data + n + 24));
        }
        // reference quirk: 32-bit rotate amounts on 64-bit lanes
        h64 = ((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25)) +
              ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14));
        h64 = merge64(h64, v1);
        h64 = merge64(h64, v2);
        h64 = merge64(h64, v3);
        h64 = merge64(h64, v4);
    } else {
        h64 = seed + P64_5;
    }
    h64 += (u64)end;
    for (; n + 8 <= end; n += 8) {
        h64 ^= round64(0, le64(data + n));
        h64 = ((h64 << 27) | (h64 >> 37)) * P64_1 + P64_4;
    }
    for (; n + 4 <= end; n += 4) {
        h64 ^= (u64)le32(data + n) * P64_1;
        h64 = ((h64 << 23) | (h64 >> 41)) * P64_2 + P64_3;
    }
    for (; n < end; n++) {
        h64 += data[n] * P64_5;
        h64 = ((h64 << 11) | (h64 >> 53)) * P64_1;
    }
    h64 ^= h64 >> 33;
    h64 *= P64_2;
    h64 ^= h64 >> 29;
    h64 *= P64_3;
    return h64 ^ (h64 >> 32);
}

}  // namespace kz
