// Alias codec (PACK/DNA): replaces 2-byte digrams with absent 1-byte values,
// or bit-packs blocks with tiny alphabets (4->1 or 2->1 nibble packing).
//
// Format spec: reference v2/transform/AliasCodec.go.
// Header: [n0 byte][0/1 trailing flag][n0 x (sym_hi, sym_lo, alias)] for
// digram mode; [n0][present symbols][adjust][packed] for small alphabets.
// DNA mode (packOnlyDNA) vetoes unless the data type is (detected) DNA.

#include <algorithm>

#include "kz.h"

namespace kz {

enum {
    DT_UNDEFINED = 0, DT_TEXT = 1, DT_MULTIMEDIA = 2, DT_EXE = 3,
    DT_NUMERIC = 4, DT_BASE64 = 5, DT_DNA = 6, DT_BIN = 7, DT_UTF8 = 8,
    DT_SMALL_ALPHABET = 9,
};

void computeHistogram(const u8* block, i64 len, i32* freqs);

static constexpr int ALIAS_MIN_BLOCKSIZE = 1024;

// order-1 digram histogram with prev=0 seed for the first byte
// (matches v2/internal/Global.go:304-341 lane semantics)
static void computeHistogramO1(const u8* block, i64 len, i32* freqs) {
    std::memset(freqs, 0, 65536 * sizeof(i32));
    u32 prv = 0;
    for (i64 i = 0; i < len; i++) {
        freqs[(prv << 8) | block[i]]++;
        prv = block[i];
    }
}

int detectSimpleType(i64 count, const i32* freqs0) {
    // reference: v2/internal/Global.go:346-419
    if (count == 0) return DT_UNDEFINED;
    static const u8 DNA_SYMS[] = "acgntuACGNTU\"";
    static const u8 NUM_SYMS[] = "0123456789+-*/=,.:; ";
    static const u8 B64_SYMS[] =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    i64 sum = 0;
    for (int i = 0; i < 12; i++) sum += freqs0[DNA_SYMS[i]];
    if (sum > count - count / 12) return DT_DNA;
    sum = 0;
    for (int i = 0; i < 20; i++) sum += freqs0[NUM_SYMS[i]];
    if (sum == count) return DT_NUMERIC;
    sum = 0;
    for (int i = 0; i < 64; i++) sum += freqs0[B64_SYMS[i]];
    if (sum + freqs0[0x3D] == count) return DT_BASE64;
    int present = 0;
    for (int i = 0; i < 256; i++)
        if (freqs0[i] > 0) present++;
    if (present == 256) return DT_BIN;
    if (present <= 4) return DT_SMALL_ALPHABET;
    return DT_UNDEFINED;
}

int aliasForward(const u8* src, i32 count, u8* dst, i64 dstCap, Ctx& ctx,
                 i32* outLen) {
    if ((i64)count + 1024 > dstCap) return 1;
    if (count < ALIAS_MIN_BLOCKSIZE) return 1;

    int dt = ctx.dataType;
    bool onlyDNA = ctx.packOnlyDNA != 0;
    if (dt == DT_MULTIMEDIA || dt == DT_UTF8 || dt == DT_EXE || dt == DT_BIN)
        return 1;
    if (onlyDNA && dt != DT_UNDEFINED && dt != DT_DNA) return 1;

    i32 freqs0[256];
    computeHistogram(src, count, freqs0);
    int n0 = 0;
    int absent[256];
    for (int i = 0; i < 256; i++)
        if (freqs0[i] == 0) absent[n0++] = i;
    if (n0 < 16) return 1;

    if (dt == DT_UNDEFINED) {
        dt = detectSimpleType(count, freqs0);
        if (dt != DT_UNDEFINED) ctx.dataType = dt;
        if (dt != DT_DNA && onlyDNA) return 1;
    }

    int srcIdx = 0, dstIdx = 0;

    if (n0 >= 240) {
        // small alphabet: pack bits
        dst[0] = (u8)n0;
        if (n0 == 255) {
            // one symbol
            dst[1] = src[0];
            u32 c = (u32)count;
            std::memcpy(dst + 2, &c, 4);
            srcIdx = count;
            dstIdx = 6;
        } else {
            u8 map8[256] = {0};
            srcIdx = 0;
            dstIdx = 1;
            int j = 0;
            for (int i = 0; i < 256; i++) {
                if (freqs0[i] != 0) {
                    dst[dstIdx++] = (u8)i;
                    map8[i] = (u8)j;
                    j++;
                }
            }
            if (n0 >= 252) {
                // 4 symbols or less: pack 4 -> 1
                int c3 = count & 3;
                dst[dstIdx++] = (u8)c3;
                std::memcpy(dst + dstIdx, src + srcIdx, c3);
                srcIdx += c3;
                dstIdx += c3;
                while (srcIdx < count) {
                    dst[dstIdx++] = (u8)((map8[src[srcIdx]] << 6) |
                                         (map8[src[srcIdx + 1]] << 4) |
                                         (map8[src[srcIdx + 2]] << 2) |
                                         map8[src[srcIdx + 3]]);
                    srcIdx += 4;
                }
            } else {
                // 16 symbols or less: pack 2 -> 1
                dst[dstIdx++] = (u8)(count & 1);
                if (count & 1) dst[dstIdx++] = src[srcIdx++];
                while (srcIdx < count) {
                    dst[dstIdx++] = (u8)((map8[src[srcIdx]] << 4) |
                                         map8[src[srcIdx + 1]]);
                    srcIdx += 2;
                }
            }
        }
    } else {
        // digram aliasing
        std::vector<i32> freqs1(65536);
        computeHistogramO1(src, count, freqs1.data());
        struct SD {
            int val, freq;
        };
        std::vector<SD> symb;
        symb.reserve(4096);
        for (int i = 0; i < 65536; i++)
            if (freqs1[i] != 0) symb.push_back({i, freqs1[i]});
        int n1 = (int)symb.size();
        if (n0 > n1) {
            n0 = n1;
            if (n0 < 16) return 1;
        }
        // sort by decreasing freq, ties by decreasing value (stable)
        std::stable_sort(symb.begin(), symb.end(), [](const SD& a, const SD& b) {
            if (a.freq != b.freq) return a.freq > b.freq;
            return a.val > b.val;
        });

        std::vector<i16> map16(65536);
        for (int i = 0; i < 65536; i++) map16[i] = (i16)(0x100 | (i >> 8));

        i64 savings = 0;
        dst[0] = (u8)n0;
        dst[1] = 0;
        srcIdx = 0;
        dstIdx = 2;
        for (int i = 0; i < n0; i++) {
            savings += symb[i].freq;
            int idx = symb[i].val;
            map16[idx] = (i16)(0x200 | absent[i]);
            dst[dstIdx] = (u8)(idx >> 8);
            dst[dstIdx + 1] = (u8)idx;
            dst[dstIdx + 2] = (u8)absent[i];
            dstIdx += 3;
        }
        if (savings < count / 20) return 1;

        int srcEnd = count - 1;
        while (srcIdx < srcEnd) {
            i16 alias = map16[((int)src[srcIdx] << 8) | src[srcIdx + 1]];
            dst[dstIdx++] = (u8)alias;
            srcIdx += alias >> 8;
        }
        if (srcIdx != count) {
            dst[1] = 1;
            dst[dstIdx++] = src[srcIdx++];
        }
    }

    if (dstIdx >= count) return 1;
    *outLen = dstIdx;
    return 0;
}

int aliasInverse(const u8* src, i32 count, u8* dst, i64 dstCap, Ctx& ctx,
                 i32* outLen) {
    if (count < 2) throw Error("Alias inverse: block too small");
    int n = src[0];
    if (n < 16) throw Error("Alias inverse: invalid slot count");

    int srcIdx = 0;
    i64 dstIdx = 0;

    if (n >= 240) {
        int srcEnd = count;
        n = 256 - n;
        srcIdx = 1;
        if (n == 1) {
            u8 val = src[1];
            u32 oSize;
            std::memcpy(&oSize, src + 2, 4);
            if ((i64)oSize > dstCap) throw Error("Alias inverse: invalid output size");
            std::memset(dst, val, oSize);
            srcIdx = srcEnd;
            dstIdx = oSize;
        } else {
            u8 idx2symb[16] = {0};
            for (int i = 0; i < n; i++) idx2symb[i] = src[srcIdx++];
            int adjust = src[srcIdx++];
            if (adjust > 3) throw Error("Alias inverse: invalid data");
            if (n <= 4) {
                u32 decodeMap[256];
                for (int i = 0; i < 256; i++) {
                    u32 val = idx2symb[(i >> 0) & 3];
                    val = (val << 8) | idx2symb[(i >> 2) & 3];
                    val = (val << 8) | idx2symb[(i >> 4) & 3];
                    val = (val << 8) | idx2symb[(i >> 6) & 3];
                    decodeMap[i] = val;
                }
                if (dstIdx + adjust > dstCap) throw Error("Alias inverse: overflow");
                std::memcpy(dst + dstIdx, src + srcIdx, adjust);
                srcIdx += adjust;
                dstIdx += adjust;
                if (dstIdx + 4 * (i64)(srcEnd - srcIdx) > dstCap)
                    throw Error("Alias inverse: overflow");
                while (srcIdx < srcEnd) {
                    std::memcpy(dst + dstIdx, &decodeMap[src[srcIdx]], 4);
                    srcIdx++;
                    dstIdx += 4;
                }
            } else {
                u16 decodeMap[256];
                for (int i = 0; i < 256; i++) {
                    u16 val = idx2symb[i & 0x0F];
                    val = (u16)((val << 8) | idx2symb[i >> 4]);
                    decodeMap[i] = val;
                }
                if (adjust != 0) {
                    dst[dstIdx++] = src[srcIdx++];
                }
                if (dstIdx + 2 * (i64)(srcEnd - srcIdx) > dstCap)
                    throw Error("Alias inverse: overflow");
                while (srcIdx < srcEnd) {
                    u16 val = decodeMap[src[srcIdx++]];
                    std::memcpy(dst + dstIdx, &val, 2);
                    dstIdx += 2;
                }
            }
        }
    } else {
        std::vector<i32> map16(256);
        int srcEnd = count - src[1];
        srcIdx = 2;
        for (int i = 0; i < 256; i++) map16[i] = 0x10000 | i;
        for (int i = 0; i < n; i++) {
            map16[src[srcIdx + 2]] = 0x20000 | src[srcIdx] | ((i32)src[srcIdx + 1] << 8);
            srcIdx += 3;
        }
        while (srcIdx < srcEnd) {
            i32 val = map16[src[srcIdx++]];
            if (dstIdx + 2 > dstCap) throw Error("Alias inverse: overflow");
            dst[dstIdx] = (u8)val;
            dst[dstIdx + 1] = (u8)(val >> 8);
            dstIdx += val >> 16;
        }
        if (src[1] != 0) {
            if (dstIdx >= dstCap) throw Error("Alias inverse: overflow");
            dst[dstIdx++] = src[srcIdx++];
        }
    }

    *outLen = (i32)dstIdx;
    return 0;
}

}  // namespace kz
