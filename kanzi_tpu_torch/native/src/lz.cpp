// LZ77 codec family: LZX (modified-LZ4-style, 4-section output) and LZP
// (hash-predicted single position).
//
// Format spec: reference v2/transform/LZCodec.go.
// LZX output layout: [13-byte header: 3 little-endian u32 section sizes +
// flags byte][literals (with embedded literal-length escapes)][tokens]
// [distances][extra match lengths]. Token = 3-bit litLen | 2-3-bit flag |
// 3-2-bit mLen. Two repeat distances; min match 4 (6 for DNA); max distance
// 2^24-2 (2^16-2 for small inputs).
//
// The hash-table update pattern during match skips is bitstream-visible
// (it changes future match choices), so it is replicated exactly.

#include "kz.h"

namespace kz {

// DataType ids (match kanzi_tpu_torch.internal.DataType)
enum { DT_UNDEFINED = 0, DT_DNA = 6, DT_SMALL_ALPHABET = 9 };

static constexpr u64 LZX_HASH_SEED = 0x1E35A7BD;
static constexpr int LZX_HASH_LOG1 = 16;
static constexpr int LZX_HASH_LOG2 = 19;
static constexpr int LZX_MAX_DISTANCE1 = (1 << 16) - 2;
static constexpr int LZX_MAX_DISTANCE2 = (1 << 24) - 2;
static constexpr int LZX_MIN_MATCH4 = 4;
static constexpr int LZX_MIN_MATCH6 = 6;
static constexpr int LZX_MAX_MATCH = 65535 + 254 + LZX_MIN_MATCH4;
static constexpr int LZX_MIN_BLOCK_LENGTH = 24;

static constexpr u32 LZP_HASH_SEED = 0x7FEB352D;
static constexpr int LZP_HASH_LOG = 16;
static constexpr int LZP_HASH_SHIFT = 32 - LZP_HASH_LOG;
static constexpr int LZP_MIN_MATCH64 = 64;
static constexpr u8 LZP_MATCH_FLAG = 0xFC;
static constexpr int LZP_MIN_BLOCK_LENGTH = 128;

static inline u64 le64(const u8* p) {
    u64 v;
    std::memcpy(&v, p, 8);
    return v;
}

static inline u32 le32(const u8* p) {
    u32 v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline void putLe32(u8* p, u32 v) { std::memcpy(p, &v, 4); }

static inline u32 lzxHash(const u8* p, bool extra) {
    if (extra)
        return (u32)(((le64(p) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG2));
    return (u32)(((le64(p) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG1));
}

static int emitLengthLZ(u8* block, int length) {
    if (length < 254) {
        block[0] = (u8)length;
        return 1;
    }
    if (length < 65536 + 254) {
        length -= 254;
        block[0] = 254;
        block[1] = (u8)(length >> 8);
        block[2] = (u8)length;
        return 3;
    }
    length -= 255;
    block[0] = 255;
    block[1] = (u8)(length >> 16);
    block[2] = (u8)(length >> 8);
    block[3] = (u8)length;
    return 4;
}

static int readLengthLZ(const u8* block, int* consumed);

// Bounds-checked variant for the inverse paths: a length escape near the
// end of a hostile payload must not read past it.
static int readLengthLZBounded(const u8* src, int idx, int count, int* consumed) {
    if (idx >= count) throw Error("LZCodec inverse: invalid length offset");
    int b0 = src[idx];
    int need = b0 < 254 ? 1 : (b0 == 254 ? 3 : 4);
    if (idx + need > count) throw Error("LZCodec inverse: truncated length");
    return readLengthLZ(src + idx, consumed);
}

static int readLengthLZ(const u8* block, int* consumed) {
    int res = block[0];
    if (res < 254) {
        *consumed = 1;
        return res;
    }
    if (res == 254) {
        res += (block[1] << 8) + block[2];
        *consumed = 3;
        return res;
    }
    res += (block[1] << 16) + (block[2] << 8) + block[3];
    *consumed = 4;
    return res;
}

static int findMatchLZX(const u8* src, int srcIdx, int ref, int maxMatch) {
    int bestLen = 0;
    while (bestLen + 8 <= maxMatch) {
        u64 diff = le64(src + srcIdx + bestLen) ^ le64(src + ref + bestLen);
        if (diff != 0) {
            bestLen += __builtin_ctzll(diff) >> 3;
            break;
        }
        bestLen += 8;
    }
    return bestLen;
}

// returns 0 ok, 1 skip
static inline i64 lzMaxEncodedLen(i32 srcLen) {
    return srcLen <= 1024 ? srcLen + 16 : srcLen + srcLen / 64;
}

int lzxForward(const u8* src, i32 count, u8* dst, i64 dstCap, Ctx& ctx,
               i32* outLen, bool extra) {
    if (lzMaxEncodedLen(count) > dstCap) return 1;
    if (count < LZX_MIN_BLOCK_LENGTH) return 1;

    const int hashLog = extra ? LZX_HASH_LOG2 : LZX_HASH_LOG1;
    std::vector<i32> hashes((size_t)1 << hashLog, 0);

    int minBufSize = std::max(count / 5, 256);
    std::vector<u8> mLenBuf(minBufSize + 16);
    std::vector<u8> mBuf(minBufSize + 16);
    std::vector<u8> tkBuf(minBufSize + 16);

    const int srcEnd = count - 16 - 2;
    int maxDist = LZX_MAX_DISTANCE2;
    dst[12] = 1;
    if (srcEnd < 4 * LZX_MAX_DISTANCE1) {
        maxDist = LZX_MAX_DISTANCE1;
        dst[12] = 0;
    }

    int minMatch = LZX_MIN_MATCH4;
    if (ctx.dataType == DT_DNA)
        minMatch = LZX_MIN_MATCH6;
    else if (ctx.dataType == DT_SMALL_ALPHABET)
        return 1;

    dst[12] |= (u8)(((minMatch - 2) & 0x07) << 1);
    int srcIdx = 0, dstIdx = 13, anchor = 0;
    size_t mLenIdx = 0, mIdx = 0, tkIdx = 0;
    int repd[2] = {count, count};
    int repdIdx = 0;
    int srcInc = 0;

    auto ensure = [](std::vector<u8>& v, size_t idx) {
        if (idx + 8 >= v.size()) v.resize(v.size() + v.size() / 2 + 16);
    };

    while (srcIdx < srcEnd) {
        int bestLen = 0;
        u32 h0 = lzxHash(src + srcIdx, extra);
        int ref0 = hashes[h0];
        hashes[h0] = srcIdx;
        u64 p = le64(src + srcIdx);
        int srcIdx1 = srcIdx + 1;
        int maxMatch = std::min(srcEnd - srcIdx1, LZX_MAX_MATCH);
        int ref = srcIdx1 - repd[repdIdx];
        int minRef = std::max(srcIdx - maxDist, 0);

        // repeat distances first
        if (ref > minRef && (u32)(p >> 8) == le32(src + ref)) {
            bestLen = findMatchLZX(src, srcIdx1, ref, maxMatch);
        } else {
            ref = srcIdx1 - repd[repdIdx ^ 1];
            if (ref > minRef && (u32)(p >> 8) == le32(src + ref))
                bestLen = findMatchLZX(src, srcIdx1, ref, maxMatch);
        }

        if (bestLen < minMatch) {
            ref = ref0;
            bool found = false;
            if (ref > minRef && (u32)p == le32(src + ref)) {
                bestLen = findMatchLZX(src, srcIdx, ref,
                                       std::min(srcEnd - srcIdx, LZX_MAX_MATCH));
                found = bestLen >= minMatch;
            }
            if (!found) {
                srcIdx = srcIdx1 + (srcInc >> 6);
                srcInc++;
                repdIdx = 0;
                continue;
            }
            // checkNext
            if (ref != srcIdx - repd[0] && ref != srcIdx - repd[1]) {
                u32 h1 = lzxHash(src + srcIdx1, extra);
                int ref1 = hashes[h1];
                hashes[h1] = srcIdx1;
                if (ref1 > minRef + 1 &&
                    le32(src + srcIdx1 + bestLen - 3) == le32(src + ref1 + bestLen - 3)) {
                    int bestLen1 = findMatchLZX(src, srcIdx1, ref1, maxMatch);
                    if (bestLen1 >= bestLen) {
                        ref = ref1;
                        bestLen = bestLen1;
                        srcIdx = srcIdx1;
                    }
                }
                if (extra) {
                    int srcIdx2 = srcIdx1 + 1;
                    u32 h2 = lzxHash(src + srcIdx2, extra);
                    int ref2 = hashes[h2];
                    hashes[h2] = srcIdx2;
                    if (ref2 > minRef + 2 &&
                        le32(src + srcIdx2 + bestLen - 3) == le32(src + ref2 + bestLen - 3)) {
                        int bestLen2 = findMatchLZX(
                            src, srcIdx2, ref2,
                            std::min(srcEnd - srcIdx2, LZX_MAX_MATCH));
                        if (bestLen2 >= bestLen) {
                            ref = ref2;
                            bestLen = bestLen2;
                            srcIdx = srcIdx2;
                        }
                    }
                }
            }
            // extend backwards
            while (srcIdx > anchor && ref > minRef && src[srcIdx - 1] == src[ref - 1]) {
                bestLen++;
                ref--;
                srcIdx--;
            }
            if (bestLen > LZX_MAX_MATCH) {
                srcIdx += bestLen - LZX_MAX_MATCH;
                ref += bestLen - LZX_MAX_MATCH;
                bestLen = LZX_MAX_MATCH;
            }
        } else {
            // repeat-distance match starting at srcIdx1
            if (src[srcIdx] == src[ref - 1] && bestLen < LZX_MAX_MATCH) {
                bestLen++;
                ref--;
            } else {
                srcIdx++;
                u32 h1 = lzxHash(src + srcIdx, extra);
                hashes[h1] = srcIdx;
            }
        }

        // emit match
        srcInc = 0;
        int dist = srcIdx - ref;
        int mLen = bestLen - minMatch;
        int token, mLenTh;
        if (dist == repd[0]) {
            token = 0x00;
            mLenTh = 3;
        } else if (dist == repd[1]) {
            token = 0x04;
            mLenTh = 3;
        } else {
            mLenTh = 7;
            ensure(mBuf, mIdx);
            if (dist >= 256) {
                if (dist >= 65536) {
                    mBuf[mIdx] = (u8)(dist >> 16);
                    mBuf[mIdx + 1] = (u8)(dist >> 8);
                    mIdx += 2;
                    token = 0x18;
                } else {
                    mBuf[mIdx] = (u8)(dist >> 8);
                    mIdx++;
                    token = 0x10;
                }
            } else {
                token = 0x08;
            }
            mBuf[mIdx] = (u8)dist;
            mIdx++;
        }

        if (mLen >= mLenTh) {
            token += mLenTh;
            ensure(mLenBuf, mLenIdx);
            mLenIdx += emitLengthLZ(mLenBuf.data() + mLenIdx, mLen - mLenTh);
        } else {
            token += mLen;
        }

        repd[1] = repd[0];
        repd[0] = dist;
        repdIdx = 1;
        int litLen = srcIdx - anchor;

        ensure(tkBuf, tkIdx);
        if (litLen == 0) {
            tkBuf[tkIdx++] = (u8)token;
        } else {
            if (litLen >= 7) {
                if (litLen >= 1 << 24) return 1;  // too many literals -> skip
                tkBuf[tkIdx++] = (u8)((7 << 5) | token);
                if (dstIdx + 4 > dstCap) return 1;
                dstIdx += emitLengthLZ(dst + dstIdx, litLen - 7);
            } else {
                tkBuf[tkIdx++] = (u8)((litLen << 5) | token);
            }
            if (dstIdx + litLen > dstCap) return 1;
            std::memcpy(dst + dstIdx, src + anchor, litLen);
            dstIdx += litLen;
        }

        // fill hash table over the matched region (order is format-visible)
        anchor = srcIdx + bestLen;
        while (srcIdx + 4 < anchor) {
            srcIdx += 4;
            u64 v = le64(src + srcIdx - 3);
            if (extra) {
                hashes[(u32)((((v >> 0) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG2))] = srcIdx - 3;
                hashes[(u32)((((v >> 8) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG2))] = srcIdx - 2;
                hashes[(u32)((((v >> 16) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG2))] = srcIdx - 1;
                hashes[(u32)((((v >> 24) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG2))] = srcIdx - 0;
            } else {
                hashes[(u32)((((v >> 0) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG1))] = srcIdx - 3;
                hashes[(u32)((((v >> 8) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG1))] = srcIdx - 2;
                hashes[(u32)((((v >> 16) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG1))] = srcIdx - 1;
                hashes[(u32)((((v >> 24) << 24) * LZX_HASH_SEED) >> (64 - LZX_HASH_LOG1))] = srcIdx - 0;
            }
        }
        srcIdx++;
        while (srcIdx < anchor) {
            hashes[lzxHash(src + srcIdx, extra)] = srcIdx;
            srcIdx++;
        }
    }

    // last literals
    int litLen = count - anchor;
    if ((i64)dstIdx + litLen + (i64)tkIdx + (i64)mIdx >= count) return 1;  // no compression
    if (litLen >= 7) {
        tkBuf[tkIdx++] = (u8)(7 << 5);
        dstIdx += emitLengthLZ(dst + dstIdx, litLen - 7);
    } else {
        tkBuf[tkIdx++] = (u8)(litLen << 5);
    }
    std::memcpy(dst + dstIdx, src + anchor, litLen);
    dstIdx += litLen;

    putLe32(dst + 0, (u32)dstIdx);
    putLe32(dst + 4, (u32)tkIdx);
    putLe32(dst + 8, (u32)mIdx);
    if (dstIdx + (i64)tkIdx + (i64)mIdx + (i64)mLenIdx > dstCap) return 1;
    std::memcpy(dst + dstIdx, tkBuf.data(), tkIdx);
    dstIdx += tkIdx;
    std::memcpy(dst + dstIdx, mBuf.data(), mIdx);
    dstIdx += mIdx;
    std::memcpy(dst + dstIdx, mLenBuf.data(), mLenIdx);
    dstIdx += mLenIdx;

    if (dstIdx > count - count / 100) return 1;  // no compression
    *outLen = dstIdx;
    return 0;
}

// Legacy v<6 inverse: token = 3-bit litLen | 1-bit dist-extra | 4-bit mLen,
// 2-entry minMatch table selected by header bits, rep-distances via mLen=15
// (reference v2/transform/LZCodec.go:780-941)
int lzxInverseV4(const u8* src, i32 count, u8* dst, i64 dstCap, i32* outLen) {
    if (count < 13) throw Error("LZCodec inverse: invalid data");
    i64 tkIdx64 = (i64)le32(src);
    i64 mIdx64 = tkIdx64 + (i64)le32(src + 4);
    i64 mLenIdx64 = mIdx64 + (i64)le32(src + 8);
    if (tkIdx64 > count || mIdx64 > count || mLenIdx64 > count)
        throw Error("LZCodec inverse: invalid data");
    int tkIdx = (int)tkIdx64, mIdx = (int)mIdx64, mLenIdx = (int)mLenIdx64;

    const int srcEnd = tkIdx - 13;
    const int mFlag = src[12] & 0x01;
    const i64 dstEnd = dstCap - 16;
    int maxDist = (mFlag == 0) ? LZX_MAX_DISTANCE1 : LZX_MAX_DISTANCE2;
    static const int minMatches[4] = {4, 9, 6, 6};
    const int minMatch = minMatches[(src[12] >> 1) & 0x03];

    int srcIdx = 13;
    i64 dstIdx = 0;
    int repd0 = 0, repd1 = 0;

    while (true) {
        if (tkIdx >= count) throw Error("LZCodec inverse: invalid token offset");
        int token = src[tkIdx++];
        if (token >= 32) {
            int litLen;
            if (token >= 0xE0) {
                int c;
                litLen = 7 + readLengthLZBounded(src, srcIdx, count, &c);
                srcIdx += c;
            } else {
                litLen = token >> 5;
            }
            if (dstIdx + litLen > dstCap || srcIdx + litLen > count)
                throw Error("LZCodec inverse: invalid literals");
            std::memcpy(dst + dstIdx, src + srcIdx, litLen);
            srcIdx += litLen;
            dstIdx += litLen;
            if (srcIdx >= srcEnd + 13) break;
        }

        int mLen = token & 0x0F;
        int dist;
        if (mLen == 15) {
            int c;
            mLen = minMatch + readLengthLZBounded(src, mLenIdx, count, &c);
            mLenIdx += c;
            dist = (token & 0x10) == 0 ? repd0 : repd1;
        } else {
            if (mLen == 14) {
                int c;
                mLen = 14 + minMatch + readLengthLZBounded(src, mLenIdx, count, &c);
                mLenIdx += c;
            } else {
                mLen += minMatch;
            }
            if (mIdx >= count) throw Error("LZCodec inverse: invalid data");
            dist = src[mIdx++];
            if (mFlag != 0) {
                if (mIdx >= count) throw Error("LZCodec inverse: invalid data");
                dist = (dist << 8) | src[mIdx++];
            }
            if (token & 0x10) {
                if (mIdx >= count) throw Error("LZCodec inverse: invalid data");
                dist = (dist << 8) | src[mIdx++];
            }
        }

        repd1 = repd0;
        repd0 = dist;
        i64 mEnd = dstIdx + mLen;
        i64 ref = dstIdx - dist;
        if (ref < 0 || dist > maxDist || mEnd > dstEnd)
            throw Error("LZCodec inverse: invalid distance decoded");
        if (dist >= 16) {
            while (true) {
                std::memcpy(dst + dstIdx, dst + ref, 16);
                ref += 16;
                dstIdx += 16;
                if (dstIdx >= mEnd) break;
            }
        } else {
            for (int i = 0; i < mLen; i++) dst[dstIdx + i] = dst[ref + i];
        }
        dstIdx = mEnd;
    }

    if (srcIdx != srcEnd + 13) throw Error("LZCodec inverse failed");
    *outLen = (i32)dstIdx;
    return 0;
}

int lzxInverse(const u8* src, i32 count, u8* dst, i64 dstCap, i32* outLen) {
    if (count < 13) throw Error("LZCodec inverse: invalid data");

    // hostile 32-bit section sizes: accumulate in 64 bits before validating
    i64 tkIdx64 = (i64)le32(src);
    i64 mIdx64 = tkIdx64 + (i64)le32(src + 4);
    i64 mLenIdx64 = mIdx64 + (i64)le32(src + 8);
    if (tkIdx64 > count || mIdx64 > count || mLenIdx64 > count)
        throw Error("LZCodec inverse: invalid data");
    int tkIdx = (int)tkIdx64;
    int mIdx = (int)mIdx64;
    int mLenIdx = (int)mLenIdx64;

    const int srcEnd = tkIdx - 13;
    const int mFlag = src[12] & 0x01;
    const i64 dstEnd = dstCap - 16;
    int maxDist = (mFlag == 0) ? LZX_MAX_DISTANCE1 : LZX_MAX_DISTANCE2;
    const int minMatch = ((src[12] >> 1) & 0x07) + 2;

    int srcIdx = 13;
    i64 dstIdx = 0;
    int repd0 = count, repd1 = count;

    while (true) {
        if (tkIdx >= count) throw Error("LZCodec inverse: invalid token offset");
        int token = src[tkIdx++];
        if (token >= 32) {
            int litLen;
            if (token >= 0xE0) {
                int c;
                litLen = 7 + readLengthLZBounded(src, srcIdx, count, &c);
                srcIdx += c;
            } else {
                litLen = token >> 5;
            }
            if (dstIdx + litLen > dstCap || srcIdx + litLen > count)
                throw Error("LZCodec inverse: invalid literals");
            std::memcpy(dst + dstIdx, src + srcIdx, litLen);
            srcIdx += litLen;
            dstIdx += litLen;
            if (srcIdx >= srcEnd + 13) break;
        }

        int mLen, dist;
        int f = token & 0x18;
        if (f == 0) {
            mLen = token & 0x03;
            if (mLen == 3) {
                int c;
                mLen += minMatch + readLengthLZBounded(src, mLenIdx, count, &c);
                mLenIdx += c;
            } else {
                mLen += minMatch;
            }
            dist = (token & 0x04) == 0 ? repd0 : repd1;
        } else {
            mLen = token & 0x07;
            if (mLen == 7) {
                int c;
                mLen += minMatch + readLengthLZBounded(src, mLenIdx, count, &c);
                mLenIdx += c;
            } else {
                mLen += minMatch;
            }
            if (mIdx + 3 > count && mIdx + (f >= 0x10 ? (f == 0x18 ? 3 : 2) : 1) > count)
                throw Error("LZCodec inverse: invalid distance offset");
            dist = src[mIdx++];
            if (f >= 0x10) {
                dist = (dist << 8) | src[mIdx++];
                if (f == 0x18) dist = (dist << 8) | src[mIdx++];
            }
        }

        repd1 = repd0;
        repd0 = dist;
        i64 mEnd = dstIdx + mLen;
        i64 ref = dstIdx - dist;
        if (ref < 0 || dist > maxDist || mEnd > dstEnd)
            throw Error("LZCodec inverse: invalid distance");

        if (dist >= 16) {
            // non-overlapping 16-byte copies
            i64 r = ref, d = dstIdx;
            while (true) {
                std::memcpy(dst + d, dst + r, 16);
                r += 16;
                d += 16;
                if (d >= mEnd) break;
            }
        } else {
            for (int i = 0; i < mLen; i++) dst[dstIdx + i] = dst[ref + i];
        }
        dstIdx = mEnd;
    }

    if (srcIdx != srcEnd + 13) throw Error("LZCodec inverse failed");
    *outLen = (i32)dstIdx;
    return 0;
}

// ---------------------------------------------------------------------------
// LZP
// ---------------------------------------------------------------------------

int lzpForward(const u8* src, i32 count, u8* dst, i64 dstCap, i32* outLen) {
    if (lzMaxEncodedLen(count) > dstCap) return 1;
    if (count < LZP_MIN_BLOCK_LENGTH) return 1;

    const int srcEnd = count;
    const int dstEnd = count - (count >> 6);
    std::vector<i32> hashes((size_t)1 << LZP_HASH_LOG, 0);

    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
    dst[3] = src[3];
    u32 ctx32 = le32(src);
    int srcIdx = 4, dstIdx = 4;

    while (srcIdx < srcEnd - LZP_MIN_MATCH64 && dstIdx < dstEnd) {
        u32 h = (LZP_HASH_SEED * ctx32) >> LZP_HASH_SHIFT;
        int ref = hashes[h];
        hashes[h] = srcIdx;
        int bestLen = 0;
        if (ref != 0 &&
            le64(src + srcIdx + LZP_MIN_MATCH64 - 8) == le64(src + ref + LZP_MIN_MATCH64 - 8)) {
            // match length scan (8 bytes at a time)
            int maxMatch = srcEnd - srcIdx;
            while (bestLen + 8 <= maxMatch) {
                u64 diff = le64(src + srcIdx + bestLen) ^ le64(src + ref + bestLen);
                if (diff != 0) {
                    bestLen += __builtin_ctzll(diff) >> 3;
                    break;
                }
                bestLen += 8;
            }
        }

        if (bestLen < LZP_MIN_MATCH64) {
            u32 val = src[srcIdx];
            ctx32 = (ctx32 << 8) | val;
            dst[dstIdx++] = src[srcIdx++];
            if (ref != 0 && val == LZP_MATCH_FLAG) dst[dstIdx++] = 0xFF;
            continue;
        }

        srcIdx += bestLen;
        ctx32 = le32(src + srcIdx - 4);
        dst[dstIdx++] = LZP_MATCH_FLAG;
        bestLen -= LZP_MIN_MATCH64;
        while (bestLen >= 254) {
            bestLen -= 254;
            dst[dstIdx++] = 0xFE;
            if (dstIdx >= dstEnd) break;
        }
        dst[dstIdx++] = (u8)bestLen;
    }

    while (srcIdx < srcEnd && dstIdx < dstEnd) {
        u32 h = (LZP_HASH_SEED * ctx32) >> LZP_HASH_SHIFT;
        i32 ref = hashes[h];
        hashes[h] = srcIdx;
        u32 val = src[srcIdx];
        ctx32 = (ctx32 << 8) | val;
        dst[dstIdx++] = src[srcIdx++];
        if (ref != 0 && val == LZP_MATCH_FLAG) dst[dstIdx++] = 0xFF;
    }

    if (srcIdx != count || dstIdx >= dstEnd) return 1;
    *outLen = dstIdx;
    return 0;
}

int lzpInverse(const u8* src, i32 count, u8* dst, i64 dstCap, i32* outLen,
               int bsVersion) {
    if (count < 4) throw Error("LZP inverse: block too small");
    std::vector<i32> hashes((size_t)1 << LZP_HASH_LOG, 0);

    const int srcEnd = count;
    const i64 dstEnd = dstCap;
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
    dst[3] = src[3];
    u32 ctx32 = le32(dst);
    int srcIdx = 4;
    i64 dstIdx = 4;
    bool res = true;
    // bsVersion < 4 streams used a 96-byte minimum match
    // (LZCodec.go:975,1118-1122)
    const int minMatch = (bsVersion > 0 && bsVersion < 4) ? 96 : LZP_MIN_MATCH64;

    while (srcIdx < srcEnd) {
        u32 h = (LZP_HASH_SEED * ctx32) >> LZP_HASH_SHIFT;
        int ref = hashes[h];
        hashes[h] = (i32)dstIdx;

        if (src[srcIdx] != LZP_MATCH_FLAG || ref == 0) {
            if (dstIdx >= dstEnd) { res = false; break; }
            dst[dstIdx] = src[srcIdx];
            ctx32 = (ctx32 << 8) | dst[dstIdx];
            srcIdx++;
            dstIdx++;
            continue;
        }
        srcIdx++;
        if (src[srcIdx] == 0xFF) {
            if (dstIdx >= dstEnd) { res = false; break; }
            dst[dstIdx] = LZP_MATCH_FLAG;
            ctx32 = (ctx32 << 8) | LZP_MATCH_FLAG;
            srcIdx++;
            dstIdx++;
            continue;
        }

        int mLen = minMatch;
        if (src[srcIdx] == 0xFE) {
            while (srcIdx < srcEnd && src[srcIdx] == 0xFE) {
                srcIdx++;
                mLen += 254;
            }
            if (srcIdx >= srcEnd) { res = false; break; }
        }
        mLen += src[srcIdx++];
        i64 mEnd = dstIdx + mLen;
        if (mEnd > dstEnd) { res = false; break; }

        if (ref + mLen < dstIdx) {
            std::memcpy(dst + dstIdx, dst + ref, mLen);
        } else {
            for (int i = 0; i < mLen; i++) dst[dstIdx + i] = dst[ref + i];
        }
        dstIdx += mLen;
        ctx32 = le32(dst + dstIdx - 4);
    }

    if (!res || srcIdx != srcEnd) throw Error("LZP inverse failed");
    *outLen = (i32)dstIdx;
    return 0;
}

}  // namespace kz
