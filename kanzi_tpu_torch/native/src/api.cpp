// Flat C API for the kanzi_tpu_torch native runtime (consumed via ctypes).
//
// Entropy encoders return the exact bit length of the payload (>= 0) or a
// negative error code; the payload always starts byte-aligned within the
// block frame. Transforms return 0 (ok), 1 (skip) or negative (fatal).

#include <cstdio>

#include "entropy_common.h"

namespace kz {
void huffmanEncode(OBS& obs, const u8* block, i64 len);
void huffmanDecode(IBS& ibs, u8* block, i64 len, int bsVersion);
void ansEncode(OBS& obs, const u8* block, i64 len, int order);
void ansDecode(IBS& ibs, u8* block, i64 len, int order, int bsVersion);
void rangeEncode(OBS& obs, const u8* block, i64 len);
void rangeDecode(IBS& ibs, u8* block, i64 len, int bsVersion);
void fpaqEncode(OBS& obs, const u8* block, i64 len);
void fpaqDecode(IBS& ibs, u8* block, i64 len, int bsVersion);
void binaryEncode(OBS& obs, const u8* block, i64 len, int predictor, const Ctx& ctx);
void binaryDecode(IBS& ibs, u8* block, i64 len, int predictor, const Ctx& ctx);
u32 xxhash32(const u8* data, i64 len, u32 seed);
u64 xxhash64(const u8* data, i64 len, u64 seed);
int transformForward(int ttype, const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen);
int transformInverse(int ttype, const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen);
}  // namespace kz

using namespace kz;

// entropy codec ids (must match kanzi_tpu_torch.entropy registry)
enum {
    ET_NONE = 0, ET_HUFFMAN = 1, ET_FPAQ = 2, ET_PAQ = 3, ET_RANGE = 4,
    ET_ANS0 = 5, ET_CM = 6, ET_TPAQ = 7, ET_ANS1 = 8, ET_TPAQX = 9,
};

extern "C" {

int64_t kz_entropy_encode(int etype, const uint8_t* src, int64_t n,
                          uint8_t* dst, int64_t dstCap, Ctx* ctx) {
    try {
        OBS obs(dst, dstCap);
        switch (etype) {
            case ET_NONE:
                obs.writeArray(src, (u64)n * 8);
                break;
            case ET_HUFFMAN:
                huffmanEncode(obs, src, n);
                break;
            case ET_ANS0:
                ansEncode(obs, src, n, 0);
                break;
            case ET_ANS1:
                ansEncode(obs, src, n, 1);
                break;
            case ET_RANGE:
                rangeEncode(obs, src, n);
                break;
            case ET_FPAQ:
                fpaqEncode(obs, src, n);
                break;
            case ET_CM:
                binaryEncode(obs, src, n, 0, *ctx);
                break;
            case ET_TPAQ:
                binaryEncode(obs, src, n, 1, *ctx);
                break;
            case ET_TPAQX:
                binaryEncode(obs, src, n, 2, *ctx);
                break;
            default:
                return -2;
        }
        u64 written = obs.written();
        obs.close();
        return (int64_t)written;
    } catch (const std::exception& e) {
        std::snprintf(nullptr, 0, "%s", e.what());
        return -1;
    }
}

int64_t kz_entropy_decode(int etype, const uint8_t* src, int64_t srcLen,
                          uint8_t* dst, int64_t outLen, Ctx* ctx) {
    try {
        IBS ibs(src, srcLen);
        switch (etype) {
            case ET_NONE:
                ibs.readArray(dst, (u64)outLen * 8);
                break;
            case ET_HUFFMAN:
                huffmanDecode(ibs, dst, outLen, ctx->bsVersion);
                break;
            case ET_ANS0:
                ansDecode(ibs, dst, outLen, 0, ctx->bsVersion);
                break;
            case ET_ANS1:
                ansDecode(ibs, dst, outLen, 1, ctx->bsVersion);
                break;
            case ET_RANGE:
                rangeDecode(ibs, dst, outLen, ctx->bsVersion);
                break;
            case ET_FPAQ:
                fpaqDecode(ibs, dst, outLen, ctx->bsVersion);
                break;
            case ET_CM:
                binaryDecode(ibs, dst, outLen, 0, *ctx);
                break;
            case ET_TPAQ:
                binaryDecode(ibs, dst, outLen, 1, *ctx);
                break;
            case ET_TPAQX:
                binaryDecode(ibs, dst, outLen, 2, *ctx);
                break;
            default:
                return -2;
        }
        return (int64_t)ibs.read();  // bits consumed
    } catch (const std::exception&) {
        return -1;
    }
}

int kz_transform_forward(int ttype, const uint8_t* src, int32_t n, uint8_t* dst,
                         int64_t cap, Ctx* ctx, int32_t* outLen) {
    try {
        return transformForward(ttype, src, n, dst, cap, *ctx, outLen);
    } catch (const std::exception&) {
        return -1;
    }
}

int kz_transform_inverse(int ttype, const uint8_t* src, int32_t n, uint8_t* dst,
                         int64_t cap, Ctx* ctx, int32_t* outLen) {
    try {
        return transformInverse(ttype, src, n, dst, cap, *ctx, outLen);
    } catch (const std::exception&) {
        return -1;
    }
}

uint32_t kz_xxhash32(const uint8_t* data, int64_t len, uint32_t seed) {
    return xxhash32(data, len, seed);
}

uint64_t kz_xxhash64(const uint8_t* data, int64_t len, uint64_t seed) {
    return xxhash64(data, len, seed);
}

}  // extern "C"
