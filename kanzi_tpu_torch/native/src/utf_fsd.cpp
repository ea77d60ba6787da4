// UTF codec (codepoint aliasing) and FSD/MM codec (fixed-step delta).
//
// Format specs: reference v2/transform/UTFCodec.go, FSDCodec.go.
// UTF: replaces up to 32768 distinct UTF-8 codepoints with 1-2 byte aliases
// ranked by frequency; header = [start][adjust][2-byte count][3 bytes per
// symbol]. FSD: picks a stride in {1,2,3,4,8,16} by XOR-histogram entropy
// sampling, then delta (zigzag + 0xFF escape) or XOR coding.

#include <algorithm>
#include <memory>

#include "kz.h"

namespace kz {

void computeHistogram(const u8* block, i64 len, i32* freqs);
int detectSimpleType(i64 count, const i32* freqs0);
int getMagicType(const u8* src, i64 len);

enum { DT_UNDEFINED = 0, DT_MULTIMEDIA = 2, DT_BIN = 7, DT_UTF8 = 8 };

// ---------------------------------------------------------------------------
// UTF
// ---------------------------------------------------------------------------
static const u8 UTF_SIZES[256] = {
    // 0x00-0x7F: 1; 0x80-0xC1: 0; 0xC2-0xDF: 2; 0xE0-0xEF: 3; 0xF0-0xF4: 4
    1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1, 1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
    1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1, 1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
    1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1, 1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
    1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1, 1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,0,2,2,2,2,2,2,2,2,2,2,2,2,2,2, 2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,
    3,3,3,3,3,3,3,3,3,3,3,3,3,3,3,3, 4,4,4,4,4,0,0,0,0,0,0,0,0,0,0,0,
};

static int packUTF(const u8* in, u32* out) {
    int s = UTF_SIZES[in[0]];
    switch (s) {
        case 1:
            *out = in[0];
            break;
        case 2:
            *out = (1u << 19) | ((u32)in[0] << 8) | in[1];
            break;
        case 3:
            *out = (2u << 19) | (((u32)in[0] & 0x0F) << 12) |
                   (((u32)in[1] & 0x3F) << 6) | ((u32)in[2] & 0x3F);
            break;
        case 4:
            *out = (4u << 19) | (((u32)in[0] & 0x07) << 18) |
                   (((u32)in[1] & 0x3F) << 12) | (((u32)in[2] & 0x3F) << 6) |
                   ((u32)in[3] & 0x3F);
            break;
        default:
            *out = 0;
            s = 0;
    }
    return s;
}

// bsVersion < 4 alias packing (UTFCodec.go:548-575): length stored as
// (size-1) in bits 21+, no sz==3 gap
static int unpackUTF0(u32 in, u8* out) {
    int s = (int)(in >> 21) + 1;
    switch (s) {
        case 1:
            out[0] = (u8)in;
            break;
        case 2:
            out[0] = (u8)(in >> 8);
            out[1] = (u8)in;
            break;
        case 3:
            out[0] = (u8)(((in >> 12) & 0x0F) | 0xE0);
            out[1] = (u8)(((in >> 6) & 0x3F) | 0x80);
            out[2] = (u8)((in & 0x3F) | 0x80);
            break;
        case 4:
            out[0] = (u8)(((in >> 18) & 0x07) | 0xF0);
            out[1] = (u8)(((in >> 12) & 0x3F) | 0x80);
            out[2] = (u8)(((in >> 6) & 0x3F) | 0x80);
            out[3] = (u8)((in & 0x3F) | 0x80);
            break;
        default:
            s = 0;
    }
    return s;
}

static int unpackUTF1(u32 in, u8* out) {
    u32 sz = in >> 19;
    if (sz == 0) {
        out[0] = (u8)in;
        return 1;
    }
    if (sz == 1) {
        out[0] = (u8)(in >> 8);
        out[1] = (u8)in;
        return 2;
    }
    if (sz == 2) {
        out[0] = (u8)(((in >> 12) & 0x0F) | 0xE0);
        out[1] = (u8)(((in >> 6) & 0x3F) | 0x80);
        out[2] = (u8)((in & 0x3F) | 0x80);
        return 3;
    }
    if (sz >= 4 && sz <= 7) {
        out[0] = (u8)(((in >> 18) & 0x07) | 0xF0);
        out[1] = (u8)(((in >> 12) & 0x3F) | 0x80);
        out[2] = (u8)(((in >> 6) & 0x3F) | 0x80);
        out[3] = (u8)((in & 0x3F) | 0x80);
        return 4;
    }
    return 0;
}

// partial UTF-8 validation (reference validateUTF :393-519)
static bool validateUTF(const u8* block, i64 count) {
    std::vector<i32> freqs0v(256, 0);
    std::unique_ptr<i32[][256]> freqs1(new i32[256][256]);
    std::memset(freqs1.get(), 0, 256 * 256 * sizeof(i32));
    i32* freqs0 = freqs0v.data();
    u8 prv = 0;
    for (i64 i = 0; i < count; i++) {
        u8 cur = block[i];
        freqs0[cur]++;
        freqs1[prv][cur]++;
        prv = cur;
    }
    i64 sum = freqs0[0xC0] + freqs0[0xC1];
    for (int i = 0xF5; i < 256; i++) sum += freqs0[i];
    if (sum != 0) return false;

    i64 sum2 = 0;
    for (int i = 0; i < 256; i++) {
        if (i < 0xA0 || i > 0xBF) sum += freqs1[0xE0][i];
        if (i < 0x80 || i > 0x9F) sum += freqs1[0xED][i];
        if (i < 0x90 || i > 0xBF) sum += freqs1[0xF0][i];
        if (i < 0x80 || i > 0x8F) sum += freqs1[0xF4][i];
        if (i < 0x80 || i > 0xBF) {
            for (int j = 0xC2; j <= 0xDF; j++) sum += freqs1[j][i];
            for (int j = 0xE1; j <= 0xEC; j++) sum += freqs1[j][i];
            sum += freqs1[0xF1][i];
            sum += freqs1[0xF2][i];
            sum += freqs1[0xF3][i];
            sum += freqs1[0xEE][i];
            sum += freqs1[0xEF][i];
        } else {
            sum2 += freqs0[i];
        }
        if (sum != 0) return false;
    }
    return sum2 >= count / 8;
}

int utfForward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (count < 1024) return 1;
    if (cap < (i64)count + 8192) return 1;

    bool mustValidate = true;
    int dt = ctx.dataType;
    if (dt != DT_UNDEFINED && dt != DT_UTF8) return 1;
    mustValidate = dt != DT_UTF8;

    int start = 0;
    u32 first4 = ((u32)src[0] << 24) | ((u32)src[1] << 16) | ((u32)src[2] << 8) | src[3];
    if ((first4 & 0x00FFFFFF) == 0x00EFBBBF) {
        start = 3;
    } else {
        while (start < 4 && UTF_SIZES[src[start]] == 0) start++;
    }

    if (mustValidate && !validateUTF(src + start, count - 4 - start)) return 1;
    ctx.dataType = DT_UTF8;

    // per-thread pooled + hugepage-advised: 16 MB of random codepoint
    // counting per UTF block; the zero-fill is the per-call semantics
    static thread_local std::vector<i32> aliasMapPool;
    i32* aliasMap = hugePoolGrow(aliasMapPool, (size_t)1 << 22);
    std::memset(aliasMap, 0, ((size_t)1 << 22) * sizeof(i32));
    struct SD {
        i32 sym, freq;
    };
    std::vector<SD> symb(32768);
    int n = 0;

    for (i32 i = start; i < count - 4;) {
        u32 val;
        int s = packUTF(src + i, &val);
        bool res = s != 0;
        res = res && (s != 3 || (src[i + 2] & 0xC0) == 0x80);
        res = res && (s != 4 ||
                      ((((u16)src[i + 2] << 8) | src[i + 3]) & 0xC0C0) == 0x8080);
        if (aliasMap[val] == 0) {
            if (n < 32768) symb[n].sym = (i32)val;
            n++;
            res = res && (n < 32768);
        }
        if (!res) return 1;
        aliasMap[val]++;
        i += s;
    }
    if (n == 0) return 1;

    i64 maxTarget = count - count / 10;
    if (3 * (i64)n + 6 >= maxTarget) return 1;

    for (int i = 0; i < n; i++) symb[i].freq = aliasMap[symb[i].sym];
    std::stable_sort(symb.begin(), symb.begin() + n, [](const SD& a, const SD& b) {
        if (a.freq != b.freq) return a.freq < b.freq;
        return a.sym < b.sym;
    });

    i64 dstIdx = 2;
    dst[dstIdx++] = (u8)(n >> 8);
    dst[dstIdx++] = (u8)n;
    i64 estimate = dstIdx + 6;
    for (int i = 0; i < n; i++) {
        int r = n - 1 - i;
        i32 s = symb[r].sym;
        dst[dstIdx] = (u8)(s >> 16);
        dst[dstIdx + 1] = (u8)(s >> 8);
        dst[dstIdx + 2] = (u8)s;
        dstIdx += 3;
        if (i < 128) {
            estimate += symb[r].freq;
            aliasMap[s] = i;
        } else {
            estimate += 2 * (i64)symb[r].freq;
            aliasMap[s] = 0x10080 | ((i << 1) & 0xFF00) | (i & 0x7F);
        }
    }
    if (estimate >= maxTarget) return 1;
    // `estimate` deliberately mirrors the reference's formula
    // (UTFCodec.go:204-224), which excludes the 3n symbol-map bytes — so
    // the real emission can exceed `cap` even when the estimate check
    // passes (the reference then panics its whole block when dst is
    // exactly MaxEncodedLen; found by the randomized differential fuzz).
    // The exact final size is computable up front: estimate already
    // counts the per-occurrence payload bytes, so add the map bytes and
    // a small tail bound and bail to skip — any emission that could
    // touch cap is far above maxTarget and would be skipped by the final
    // check anyway, so this changes no skip decision.
    if (estimate + 3 * (i64)n + 16 > cap) return 1;

    for (int i = 0; i < start; i++) dst[dstIdx++] = src[i];
    i32 srcIdx = start;
    while (srcIdx < count - 4) {
        u32 val;
        srcIdx += packUTF(src + srcIdx, &val);
        i32 alias = aliasMap[val];
        dst[dstIdx++] = (u8)alias;
        dst[dstIdx] = (u8)(alias >> 8);
        dstIdx += alias >> 16;
    }
    dst[0] = (u8)start;
    dst[1] = (u8)(srcIdx - (count - 4));
    while (srcIdx < count) dst[dstIdx++] = src[srcIdx++];

    if (dstIdx >= maxTarget) return 1;
    *outLen = (i32)dstIdx;
    return 0;
}

int utfInverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (count < 4) throw Error("UTF inverse: block too small");
    int start = src[0] & 0x03;
    int adjust = src[1] & 0x03;
    int n = ((int)src[2] << 8) + src[3];
    if (n == 0 || n >= 32768 || 4 + 3 * n > count)
        throw Error("UTF inverse: invalid map size");
    bool isV3 = ctx.bsVersion > 0 && ctx.bsVersion < 4;  // UTFCodec.go:296

    struct Sym {
        u8 value[4];
        u8 length;
    };
    std::vector<Sym> m(32768);
    i64 srcIdx = 4;
    for (int i = 0; i < n; i++) {
        u32 s = ((u32)src[srcIdx] << 16) | ((u32)src[srcIdx + 1] << 8) | src[srcIdx + 2];
        int sl = isV3 ? unpackUTF0(s, m[i].value) : unpackUTF1(s, m[i].value);
        if (sl == 0) throw Error("UTF inverse: invalid alias");
        m[i].length = (u8)sl;
        srcIdx += 3;
    }

    i64 srcEnd = count - 4 + adjust;
    i64 dstIdx = 0;
    i64 dstEnd = cap - 4;
    if (dstEnd < 0) throw Error("UTF inverse: output too small");
    if (srcEnd < srcIdx || srcEnd > count || srcIdx + start > count)
        throw Error("UTF inverse: invalid data");

    for (int i = 0; i < start; i++) dst[dstIdx++] = src[srcIdx++];

    while (srcIdx < srcEnd && dstIdx < dstEnd) {
        int alias = src[srcIdx++];
        if (alias >= 128) {
            if (srcIdx >= srcEnd) throw Error("UTF inverse: invalid data");
            alias = ((int)src[srcIdx] << 7) + (alias & 0x7F);
            srcIdx++;
        }
        const Sym& s = m[alias];
        std::memcpy(dst + dstIdx, s.value, 4);
        dstIdx += s.length;
    }

    if (srcIdx < srcEnd || dstIdx > cap - count + srcEnd)
        throw Error("UTF inverse: invalid data");
    for (i64 i = srcEnd; i < count; i++) dst[dstIdx++] = src[srcIdx++];

    *outLen = (i32)dstIdx;
    return 0;
}

// ---------------------------------------------------------------------------
// FSD
// ---------------------------------------------------------------------------
static constexpr u8 FSD_ESCAPE = 0xFF;

// zigzag1[127 + d] encodes delta d in [-127..127]; zigzag2 is the inverse
static u8 FSD_ZIGZAG1[256];
static int FSD_ZIGZAG2[256];
static bool fsdInit = [] {
    for (int i = 0; i < 256; i++) {
        int d = i - 127;
        FSD_ZIGZAG1[i] = (u8)(d >= 0 ? 2 * d : -2 * d - 1);
        FSD_ZIGZAG2[i] = (i & 1) ? -((i + 1) / 2) : i / 2;
    }
    FSD_ZIGZAG1[255] = 255;  // delta 128 (unused; escape path)
    return true;
}();

i32 firstOrderEntropy1024(i64 blockLen, const i32* histo);

int fsdForward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    i64 dstEnd = (i64)count + std::max(count >> 4, 64);
    if (cap < dstEnd) return 1;
    if (count < 1024) return 1;

    int dt = ctx.dataType;
    if (dt != DT_UNDEFINED && dt != DT_MULTIMEDIA && dt != DT_BIN) return 1;

    int magic = getMagicType(src, count);
    switch ((u32)magic) {
        case 0x424Du: case 0x52494646u: case 0x5034u: case 0x5035u:
        case 0x5036u: case 0:
            break;
        default:
            return 1;
    }

    i32 count10 = count / 10;
    i32 count5 = 2 * count10;
    const u8* in[3] = {src, src + 2 * count5, src + 4 * count5};
    std::unique_ptr<i32[][256]> histo(new i32[7][256]);
    std::memset(histo.get(), 0, 7 * 256 * sizeof(i32));

    for (i32 i = count10; i < count5; i++) {
        for (int k = 0; k < 3; k++) {
            u8 b = in[k][i];
            histo[0][b]++;
            histo[1][b ^ in[k][i - 1]]++;
            histo[2][b ^ in[k][i - 2]]++;
            histo[3][b ^ in[k][i - 3]]++;
            histo[4][b ^ in[k][i - 4]]++;
            histo[5][b ^ in[k][i - 8]]++;
            histo[6][b ^ in[k][i - 16]]++;
        }
    }

    i32 ent[7];
    int minIdx = 0;
    for (int i = 0; i < 7; i++) {
        ent[i] = firstOrderEntropy1024(3 * count10, histo[i]);
        if (ent[i] < ent[minIdx]) minIdx = i;
    }

    if (ent[minIdx] >= ent[0]) {
        ctx.dataType = detectSimpleType(3 * count10, histo[0]);
        return 1;
    }
    ctx.dataType = DT_MULTIMEDIA;

    static const int distances[7] = {0, 1, 2, 3, 4, 8, 16};
    int dist = distances[minIdx];
    i32 largeDeltas = 0;
    for (i32 i = 2 * count5; i < 3 * count5; i++) {
        i32 delta = (i32)src[i] - (i32)src[i - dist];
        if (delta < -127 || delta > 127) largeDeltas++;
    }

    u8 mode = (largeDeltas > (count5 >> 5)) ? 1 : 0;  // 1 = XOR coding
    dst[0] = mode;
    dst[1] = (u8)dist;
    i32 srcIdx = 0;
    i64 dstIdx = 2;
    for (int i = 0; i < dist; i++) dst[dstIdx++] = src[srcIdx++];

    if (mode == 0) {
        while (srcIdx < count && dstIdx < dstEnd - 1) {
            i32 delta = 127 + (i32)src[srcIdx] - (i32)src[srcIdx - dist];
            if (delta >= 0 && delta < 255) {
                dst[dstIdx++] = FSD_ZIGZAG1[delta];
                srcIdx++;
                continue;
            }
            dst[dstIdx] = FSD_ESCAPE;
            dst[dstIdx + 1] = src[srcIdx] ^ src[srcIdx - dist];
            srcIdx++;
            dstIdx += 2;
        }
    } else {
        while (srcIdx < count) {
            dst[dstIdx++] = src[srcIdx] ^ src[srcIdx - dist];
            srcIdx++;
        }
    }
    if (srcIdx != count) return 1;

    // verify the transform actually helps
    std::memset(histo[0], 0, 256 * sizeof(i32));
    const u8* out1 = dst + 1 * count5;
    const u8* out2 = dst + 3 * count5;
    for (i32 i = 0; i < count10; i++) {
        histo[0][out1[i]]++;
        histo[0][out2[i]]++;
    }
    if (firstOrderEntropy1024(count5, histo[0]) >= ent[0]) return 1;

    *outLen = (i32)dstIdx;
    return 0;
}

int fsdInverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    (void)ctx;
    if (count < 2) throw Error("FSD inverse: block too small");
    u8 mode = src[0];
    int dist = src[1];
    if (dist < 1 || (dist > 4 && dist != 8 && dist != 16))
        throw Error("FSD inverse: invalid distance");

    i64 srcEnd = count, dstEnd = cap;
    i64 srcIdx = 2, dstIdx = 0;
    if (srcEnd - srcIdx < dist) throw Error("FSD inverse: invalid data");
    if (dstEnd < dist) throw Error("FSD inverse: output too small");
    for (int i = 0; i < dist; i++) dst[dstIdx++] = src[srcIdx++];

    if (mode == 0) {
        while (srcIdx < srcEnd && dstIdx < dstEnd) {
            if (src[srcIdx] != FSD_ESCAPE) {
                dst[dstIdx] = (u8)((int)dst[dstIdx - dist] + FSD_ZIGZAG2[src[srcIdx]]);
                srcIdx++;
                dstIdx++;
                continue;
            }
            srcIdx++;
            if (srcIdx >= srcEnd) throw Error("FSD inverse: invalid data");
            dst[dstIdx] = src[srcIdx] ^ dst[dstIdx - dist];
            srcIdx++;
            dstIdx++;
        }
    } else if (mode == 1) {
        while (srcIdx < srcEnd && dstIdx < dstEnd) {
            dst[dstIdx] = src[srcIdx] ^ dst[dstIdx - dist];
            dstIdx++;
            srcIdx++;
        }
    } else {
        throw Error("FSD inverse: invalid mode");
    }
    if (srcIdx != srcEnd) throw Error("FSD inverse: output too small");
    *outLen = (i32)dstIdx;
    return 0;
}

}  // namespace kz
