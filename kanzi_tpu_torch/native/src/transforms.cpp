// Transform dispatcher for the native runtime.
// Return contract: 0 = ok, 1 = skip (forward veto), negative = fatal.

#include "kz.h"

namespace kz {

// transform ids (match kanzi_tpu_torch.transforms registry)
enum {
    TT_NONE = 0, TT_BWT = 1, TT_BWTS = 2, TT_LZ = 3, TT_RLT = 5, TT_ZRLT = 6,
    TT_MTFT = 7, TT_RANK = 8, TT_EXE = 9, TT_DICT = 10, TT_ROLZ = 11,
    TT_ROLZX = 12, TT_SRT = 13, TT_LZP = 14, TT_MM = 15, TT_LZX = 16,
    TT_UTF = 17, TT_PACK = 18, TT_DNA = 19,
};

int lzxForward(const u8*, i32, u8*, i64, Ctx&, i32*, bool extra);
int lzxInverse(const u8*, i32, u8*, i64, i32*);
int lzxInverseV4(const u8*, i32, u8*, i64, i32*);
int lzpForward(const u8*, i32, u8*, i64, i32*);
int lzpInverse(const u8*, i32, u8*, i64, i32*, int bsVersion);
int zrltForward(const u8*, i32, u8*, i64, i32*);
int zrltInverse(const u8*, i32, u8*, i64, i32*);
int rltForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int rltInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int srtForward(const u8*, i32, u8*, i64, i32*);
int srtInverse(const u8*, i32, u8*, i64, i32*);
int sbrtForward(const u8*, i32, u8*, i64, int mode, i32*);
int sbrtInverse(const u8*, i32, u8*, i64, int mode, i32*);
int bwtBlockForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int bwtBlockInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int bwtsForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int bwtsInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int textForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int textInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int utfForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int utfInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int aliasForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int aliasInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int fsdForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int fsdInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int exeForward(const u8*, i32, u8*, i64, Ctx&, i32*);
int exeInverse(const u8*, i32, u8*, i64, Ctx&, i32*);
int rolzForward(const u8*, i32, u8*, i64, Ctx&, i32*, bool extra);
int rolzInverse(const u8*, i32, u8*, i64, Ctx&, i32*, bool extra);

int transformForward(int ttype, const u8* src, i32 n, u8* dst, i64 cap,
                     Ctx& ctx, i32* outLen) {
    if (n == 0) {
        *outLen = 0;
        return 0;
    }
    switch (ttype) {
        case TT_NONE:
            if (cap < n) return -3;
            std::memcpy(dst, src, n);
            *outLen = n;
            return 0;
        case TT_LZ:
            return lzxForward(src, n, dst, cap, ctx, outLen, false);
        case TT_LZX:
            return lzxForward(src, n, dst, cap, ctx, outLen, true);
        case TT_LZP:
            return lzpForward(src, n, dst, cap, outLen);
        case TT_PACK:
        case TT_DNA:
            return aliasForward(src, n, dst, cap, ctx, outLen);
        case TT_ZRLT:
            return zrltForward(src, n, dst, cap, outLen);
        case TT_RLT:
            return rltForward(src, n, dst, cap, ctx, outLen);
        case TT_SRT:
            return srtForward(src, n, dst, cap, outLen);
        case TT_MTFT:
            return sbrtForward(src, n, dst, cap, 1, outLen);
        case TT_RANK:
            return sbrtForward(src, n, dst, cap, 2, outLen);
        case TT_BWT:
            return bwtBlockForward(src, n, dst, cap, ctx, outLen);
        case TT_DICT:
            return textForward(src, n, dst, cap, ctx, outLen);
        case TT_UTF:
            return utfForward(src, n, dst, cap, ctx, outLen);
        case TT_MM:
            return fsdForward(src, n, dst, cap, ctx, outLen);
        case TT_BWTS:
            return bwtsForward(src, n, dst, cap, ctx, outLen);
        case TT_EXE:
            return exeForward(src, n, dst, cap, ctx, outLen);
        case TT_ROLZ:
            return rolzForward(src, n, dst, cap, ctx, outLen, false);
        case TT_ROLZX:
            return rolzForward(src, n, dst, cap, ctx, outLen, true);
        default:
            return -2;
    }
}

int transformInverse(int ttype, const u8* src, i32 n, u8* dst, i64 cap,
                     Ctx& ctx, i32* outLen) {
    if (n == 0) {
        *outLen = 0;
        return 0;
    }
    switch (ttype) {
        case TT_NONE:
            if (cap < n) return -3;
            std::memcpy(dst, src, n);
            *outLen = n;
            return 0;
        case TT_LZ:
        case TT_LZX:
            if (ctx.bsVersion > 0 && ctx.bsVersion < 6)
                return lzxInverseV4(src, n, dst, cap, outLen);
            return lzxInverse(src, n, dst, cap, outLen);
        case TT_LZP:
            return lzpInverse(src, n, dst, cap, outLen, ctx.bsVersion);
        case TT_PACK:
        case TT_DNA:
            return aliasInverse(src, n, dst, cap, ctx, outLen);
        case TT_ZRLT:
            return zrltInverse(src, n, dst, cap, outLen);
        case TT_RLT:
            return rltInverse(src, n, dst, cap, ctx, outLen);
        case TT_SRT:
            return srtInverse(src, n, dst, cap, outLen);
        case TT_MTFT:
            return sbrtInverse(src, n, dst, cap, 1, outLen);
        case TT_RANK:
            return sbrtInverse(src, n, dst, cap, 2, outLen);
        case TT_BWT:
            return bwtBlockInverse(src, n, dst, cap, ctx, outLen);
        case TT_DICT:
            return textInverse(src, n, dst, cap, ctx, outLen);
        case TT_UTF:
            return utfInverse(src, n, dst, cap, ctx, outLen);
        case TT_MM:
            return fsdInverse(src, n, dst, cap, ctx, outLen);
        case TT_BWTS:
            return bwtsInverse(src, n, dst, cap, ctx, outLen);
        case TT_EXE:
            return exeInverse(src, n, dst, cap, ctx, outLen);
        case TT_ROLZ:
            return rolzInverse(src, n, dst, cap, ctx, outLen, false);
        case TT_ROLZX:
            return rolzInverse(src, n, dst, cap, ctx, outLen, true);
        default:
            return -2;
    }
}

}  // namespace kz
