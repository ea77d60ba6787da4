// ROLZ / ROLZX: reduced-offset LZ with per-context position rings.
//
// Format spec: reference v2/transform/ROLZCodec.go.
// Codec 1 (ROLZ): 16 MiB chunks; literals/tokens/lengths/match-indexes are
// entropy-coded with embedded ANS streams into a nested bitstream prefixed
// by four 32-bit section lengths. Codec 2 (ROLZX): literals and matches are
// coded with an embedded binary CM arithmetic coder (9-bit symbols, 2
// context sets, 'balz' lineage) and checks 2^5 ring positions.
// Output: [4-byte big-endian original size][flags][chunks...][4 last bytes].

#include "kz.h"

namespace kz {

void computeHistogram(const u8* block, i64 len, i32* freqs);
int detectSimpleType(i64 count, const i32* freqs0);
void ansEncodeChunked(OBS& obs, const u8* block, i64 len, int order, int chunkSize);
void ansDecodeChunked(IBS& ibs, u8* block, i64 len, int order, int chunkSize,
                      int bsVersion = 6);

enum { DT_UNDEFINED = 0, DT_EXE = 3, DT_DNA = 6, DT_MULTIMEDIA = 2 };

static constexpr int ROLZ_HASH_SIZE = 1 << 16;
static constexpr int ROLZ_MIN_MATCH3 = 3;
static constexpr int ROLZ_MIN_MATCH4 = 4;
static constexpr int ROLZ_MIN_MATCH7 = 7;
static constexpr int ROLZ_MAX_MATCH1 = ROLZ_MIN_MATCH3 + 65535;
static constexpr int ROLZ_MAX_MATCH2 = ROLZ_MIN_MATCH3 + 255;
static constexpr int ROLZ_LOG_POS_CHECKS1 = 4;
static constexpr int ROLZ_LOG_POS_CHECKS2 = 5;
static constexpr i64 ROLZ_CHUNK_SIZE = 16 * 1024 * 1024;
static constexpr u32 ROLZ_HASH_MASK = ~(u32)(ROLZ_CHUNK_SIZE - 1);
static constexpr u32 ROLZ_HASH_SEED = 200002979;
static constexpr int ROLZ_PSCALE = 0xFFFF;
static constexpr u64 ROLZ_TOP = 0x00FFFFFFFFFFFFFFull;
static constexpr u64 RMASK_0_56 = 0x00FFFFFFFFFFFFFFull;
static constexpr u64 RMASK_0_32 = 0x00000000FFFFFFFFull;
enum { ROLZ_MATCH_CTX = 0, ROLZ_LITERAL_CTX = 1 };
enum { ROLZ_MATCH_FLAG = 0, ROLZ_LITERAL_FLAG = 1 };

static inline u16 le16(const u8* p) {
    u16 v;
    std::memcpy(&v, p, 2);
    return v;
}
static inline u32 rle32(const u8* p) {
    u32 v;
    std::memcpy(&v, p, 4);
    return v;
}
static inline u64 rle64(const u8* p) {
    u64 v;
    std::memcpy(&v, p, 8);
    return v;
}

static inline u32 getKey1(const u8* p) { return le16(p); }
static inline u32 getKey2(const u8* p) {
    return (u32)((rle64(p) * ROLZ_HASH_SEED) >> 40) & 0xFFFF;
}
static inline u32 rolzhash(const u8* p) {
    return ((rle32(p) << 8) * ROLZ_HASH_SEED) & ROLZ_HASH_MASK;
}

static i64 emitCopy(u8* buf, i64 dstIdx, i64 ref, int matchLen) {
    if (dstIdx >= ref + matchLen) {
        std::memcpy(buf + dstIdx, buf + ref, matchLen);
        return dstIdx + matchLen;
    }
    while (matchLen != 0) {
        buf[dstIdx++] = buf[ref++];
        matchLen--;
    }
    return dstIdx;
}

static int emitLengthROLZ(u8* block, int len) {
    int idx = 0;
    if (len >= 1 << 7) {
        if (len >= 1 << 14) {
            if (len >= 1 << 21) block[idx++] = (u8)(0x80 | (len >> 21));
            block[idx++] = (u8)(0x80 | (len >> 14));
        }
        block[idx++] = (u8)(0x80 | (len >> 7));
    }
    block[idx] = (u8)(len & 0x7F);
    return idx + 1;
}

static int readLengthROLZ(const u8* lenBuf, int* consumed) {
    u8 next = lenBuf[0];
    int idx = 1;
    int len = next & 0x7F;
    while (next >= 128 && idx < 4) {
        next = lenBuf[idx++];
        len = (len << 7) | (next & 0x7F);
    }
    *consumed = idx;
    return len;
}

// ---------------------------------------------------------------------------
// Codec 1 (ANS sections)
// ---------------------------------------------------------------------------
// Thread-local pooled match tables (hugepage-advised): up to
// ROLZ_HASH_SIZE << 8 u32 (64 MB) of random per-key access, re-zeroed per
// use exactly as the fresh vectors were. The pool is grow-only, so the
// logical length is tracked separately (matchesLen) — per-chunk clears
// must not touch a larger previous allocation.
static std::vector<u32>& rolzMatchesPoolC1() {
    static thread_local std::vector<u32> p;
    return p;
}

static std::vector<u32>& rolzMatchesPoolC2() {
    static thread_local std::vector<u32> p;
    return p;
}

struct RolzC1 {
    std::vector<u32>& matches = rolzMatchesPoolC1();
    size_t matchesLen = 0;

    void resetMatches(size_t n) {
        matchesLen = n;
        hugePoolGrow(matches, n);
        std::memset(matches.data(), 0, n * sizeof(u32));
    }

    void clearMatches() {
        std::memset(matches.data(), 0, matchesLen * sizeof(u32));
    }
    std::vector<i32> counters;
    u32 logPosChecks;
    i32 maskChecks, posChecks;
    int minMatch = ROLZ_MIN_MATCH3;

    explicit RolzC1(u32 lpc) : logPosChecks(lpc) {
        posChecks = 1 << lpc;
        maskChecks = posChecks - 1;
        counters.assign(1 << 16, 0);
    }

    // returns (matchIdx, matchLen) or (-1, -1)
    void findMatch(const u8* buf, i64 bufLen, i64 pos, u32 hash32, i32 counter,
                   const u32* m, int* outIdx, int* outLen) {
        int maxMatch = (int)std::min((i64)ROLZ_MAX_MATCH1, bufLen - pos);
        *outIdx = -1;
        *outLen = -1;
        if (maxMatch < minMatch) return;
        maxMatch -= 8;
        int bestLen = 0;
        int bestIdx = -1;
        const u8* curBuf = buf + pos;

        for (i32 i = counter; i > counter - posChecks; i--) {
            u32 ref = m[i & maskChecks];
            if ((ref & ROLZ_HASH_MASK) != hash32) continue;
            ref &= ~ROLZ_HASH_MASK;
            const u8* refBuf = buf + ref;
            if (refBuf[bestLen] != curBuf[bestLen]) continue;
            int n = 0;
            while (n < maxMatch) {
                u64 diff = rle64(refBuf + n) ^ rle64(curBuf + n);
                if (diff != 0) {
                    n += __builtin_ctzll(diff) >> 3;
                    break;
                }
                n += 8;
            }
            if (n > bestLen) {
                bestIdx = (int)i;
                bestLen = n;
            }
        }
        if (bestLen < minMatch) return;
        *outIdx = (int)counter - bestIdx;
        *outLen = bestLen - minMatch;
    }

    int forward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
        i64 required = count <= 512 ? count + 64 : count;
        if (cap < required) return 1;

        i64 srcEnd = count - 4;
        dst[0] = (u8)(count >> 24);
        dst[1] = (u8)(count >> 16);
        dst[2] = (u8)(count >> 8);
        dst[3] = (u8)count;
        i64 sizeChunk = std::min((i64)count, ROLZ_CHUNK_SIZE);

        i64 startChunk = 0;
        i64 maxEnc = sizeChunk <= 512 ? sizeChunk + 64 : sizeChunk;
        std::vector<u8> litBuf(maxEnc);
        std::vector<u8> lenBuf(sizeChunk / 5 + 8);
        std::vector<u8> mIdxBuf(sizeChunk / 4 + 8);
        std::vector<u8> tkBuf(sizeChunk / 4 + 8);

        std::fill(counters.begin(), counters.end(), 0);
        int litOrder = count < (1 << 17) ? 0 : 1;
        u8 flags = (u8)litOrder;
        minMatch = ROLZ_MIN_MATCH3;
        int delta = 2;

        int dt = ctx.dataType;
        if (dt == DT_UNDEFINED) {
            i32 freqs0[256];
            computeHistogram(src, count, freqs0);
            dt = detectSimpleType(count, freqs0);
            if (dt != DT_UNDEFINED) ctx.dataType = dt;
        }
        if (dt == DT_EXE) {
            delta = 3;
            flags |= 8;
        } else if (dt == DT_DNA) {
            delta = 8;
            minMatch = ROLZ_MIN_MATCH7;
            flags |= 4;
        } else if (dt == DT_MULTIMEDIA) {
            delta = 8;
            minMatch = ROLZ_MIN_MATCH4;
            flags |= 2;
        }

        flags |= (u8)(logPosChecks << 4);
        dst[4] = flags;
        i64 srcIdx = 0;
        i64 dstIdx = 5;

        resetMatches((size_t)ROLZ_HASH_SIZE << logPosChecks);

        while (startChunk < srcEnd) {
            i64 litIdx = 0, lenIdx = 0, mIdx = 0, tkIdx = 0;
            clearMatches();
            i64 endChunk = startChunk + sizeChunk;
            if (endChunk >= srcEnd) {
                endChunk = srcEnd;
                sizeChunk = endChunk - startChunk;
            }
            const u8* buf = src + startChunk;
            srcIdx = 0;
            i64 n = std::min(srcEnd - startChunk, (i64)8);
            for (i64 j = 0; j < n; j++) litBuf[litIdx++] = buf[srcIdx++];

            i64 firstLitIdx = srcIdx;
            int srcInc = 0;

            while (srcIdx < sizeChunk) {
                u32 key = (minMatch == ROLZ_MIN_MATCH3) ? getKey1(buf + srcIdx - delta)
                                                        : getKey2(buf + srcIdx - delta);
                u32* m = matches.data() + ((size_t)key << logPosChecks);
                u32 hash32 = rolzhash(buf + srcIdx);
                int matchIdx, matchLen;
                findMatch(buf, sizeChunk, srcIdx, hash32, counters[key], m,
                          &matchIdx, &matchLen);

                counters[key] = (counters[key] + 1) & maskChecks;
                m[counters[key]] = hash32 | (u32)srcIdx;

                if (matchIdx < 0) {
                    srcIdx++;
                    srcIdx += (srcInc >> 6);
                    srcInc++;
                    continue;
                }

                i64 srcIdx1 = srcIdx + 1;
                key = (minMatch == ROLZ_MIN_MATCH3) ? getKey1(buf + srcIdx1 - delta)
                                                    : getKey2(buf + srcIdx1 - delta);
                m = matches.data() + ((size_t)key << logPosChecks);
                hash32 = rolzhash(buf + srcIdx1);
                int matchIdx1, matchLen1;
                findMatch(buf, sizeChunk, srcIdx1, hash32, counters[key], m,
                          &matchIdx1, &matchLen1);

                if (matchIdx1 >= 0 && matchLen1 > matchLen) {
                    matchIdx = matchIdx1;
                    matchLen = matchLen1;
                    srcIdx = srcIdx1;
                    counters[key] = (counters[key] + 1) & maskChecks;
                    m[counters[key]] = hash32 | (u32)srcIdx;
                }

                i64 litLen = srcIdx - firstLitIdx;
                u8 token;
                if (matchLen >= 7) {
                    token = 7;
                    lenIdx += emitLengthROLZ(lenBuf.data() + lenIdx, matchLen - 7);
                } else {
                    token = (u8)matchLen;
                }

                if (litLen > 0) {
                    if (litLen >= 31) {
                        token |= 0xF8;
                        lenIdx += emitLengthROLZ(lenBuf.data() + lenIdx, (int)(litLen - 31));
                    } else {
                        token |= (u8)(litLen << 3);
                    }
                    if (litIdx + litLen > (i64)litBuf.size()) return 1;
                    std::memcpy(litBuf.data() + litIdx, buf + firstLitIdx, litLen);
                    litIdx += litLen;
                }

                if (tkIdx >= (i64)tkBuf.size() || mIdx >= (i64)mIdxBuf.size() ||
                    lenIdx + 8 > (i64)lenBuf.size())
                    return 1;
                tkBuf[tkIdx++] = token;
                mIdxBuf[mIdx++] = (u8)matchIdx;
                srcIdx += matchLen + minMatch;
                firstLitIdx = srcIdx;
                srcInc = 0;
            }

            // last chunk literals
            srcIdx = sizeChunk;
            i64 litLen = srcIdx - firstLitIdx;
            if (tkIdx != 0) {
                tkBuf[tkIdx++] = (litLen >= 31) ? 0xF8 : (u8)(litLen << 3);
            }
            if (litLen > 0) {
                if (litLen >= 31)
                    lenIdx += emitLengthROLZ(lenBuf.data() + lenIdx, (int)(litLen - 31));
                if (litIdx + litLen > (i64)litBuf.size()) return 1;
                std::memcpy(litBuf.data() + litIdx, buf + firstLitIdx, litLen);
                litIdx += litLen;
            }

            // nested bitstream: section sizes + ANS-coded sections
            {
                OBS obs(dst + dstIdx, cap - dstIdx);
                obs.writeBits((u64)litIdx, 32);
                obs.writeBits((u64)tkIdx, 32);
                obs.writeBits((u64)lenIdx, 32);
                obs.writeBits((u64)mIdx, 32);
                ansEncodeChunked(obs, litBuf.data(), litIdx, litOrder, 0);
                ansEncodeChunked(obs, tkBuf.data(), tkIdx, 0, 32768);
                ansEncodeChunked(obs, lenBuf.data(), lenIdx, 0, 32768);
                ansEncodeChunked(obs, mIdxBuf.data(), mIdx, 0, 32768);
                u64 written = obs.written();
                obs.close();
                dstIdx += (i64)((written + 7) >> 3);
            }
            startChunk = endChunk;
        }

        if (dstIdx + 4 > cap) return 1;
        srcIdx += (startChunk - sizeChunk);
        dst[dstIdx] = src[srcIdx];
        dst[dstIdx + 1] = src[srcIdx + 1];
        dst[dstIdx + 2] = src[srcIdx + 2];
        dst[dstIdx + 3] = src[srcIdx + 3];
        srcIdx += 4;
        dstIdx += 4;
        if (srcIdx != count) return 1;
        if (dstIdx >= count) return 1;  // no compression
        *outLen = (i32)dstIdx;
        return 0;
    }

    int inverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
        int bsVersion = ctx.bsVersion > 0 ? ctx.bsVersion : 6;
        if (count < 5) throw Error("ROLZ inverse: input too small");
        i64 dstEnd = (i64)(((u32)src[0] << 24) | ((u32)src[1] << 16) |
                           ((u32)src[2] << 8) | src[3]) - 4;
        if (dstEnd <= 0 || dstEnd > cap) throw Error("ROLZ inverse: invalid data");

        i64 startChunk = 0;
        i64 srcIdx = 5;
        i64 dstIdx = 0;
        i64 sizeChunk = std::min((i64)cap, ROLZ_CHUNK_SIZE);
        std::vector<u8> litBuf(sizeChunk);
        std::vector<u8> mLenBuf(sizeChunk / 5 + 8);
        std::vector<u8> mIdxBuf(sizeChunk / 4 + 8);
        std::vector<u8> tkBuf(sizeChunk / 4 + 8);

        std::fill(counters.begin(), counters.end(), 0);
        u8 flags = src[4];
        int litOrder = flags & 1;
        int delta = 2;
        minMatch = ROLZ_MIN_MATCH3;

        // flag semantics by stream version (ROLZCodec.go:638-655)
        if (bsVersion >= 4) {
            if ((flags & 0x0E) == 2) {
                minMatch = ROLZ_MIN_MATCH4;
                delta = 8;
            } else if ((flags & 0x0E) == 4) {
                minMatch = ROLZ_MIN_MATCH7;
                delta = 8;
            } else if ((flags & 0x0E) == 8) {
                delta = 3;
            }
        } else if (bsVersion >= 3) {
            if ((flags & 6) == 2) {
                minMatch = ROLZ_MIN_MATCH4;
            } else if ((flags & 6) == 4) {
                minMatch = ROLZ_MIN_MATCH7;
            }
        }

        logPosChecks = flags >> 4;
        if (logPosChecks < 2 || logPosChecks > 8)
            throw Error("ROLZ inverse: invalid logPosChecks");
        posChecks = 1 << logPosChecks;
        maskChecks = posChecks - 1;
        resetMatches((size_t)ROLZ_HASH_SIZE << logPosChecks);

        while (startChunk < dstEnd) {
            i64 mIdx = 0, lenIdx = 0, litIdx = 0, tkIdx = 0;
            clearMatches();
            i64 endChunk = startChunk + sizeChunk;
            if (endChunk > dstEnd) endChunk = dstEnd;
            sizeChunk = endChunk - startChunk;
            u8* buf = dst + startChunk;
            bool onlyLiterals = false;
            i64 litLenDecoded = 0;

            i64 litLen, tkLen, mLenLen, mIdxLen;
            {
                IBS ibs(src + srcIdx, count - srcIdx);
                litLen = (i64)ibs.readBits(32);
                tkLen = (i64)ibs.readBits(32);
                mLenLen = (i64)ibs.readBits(32);
                mIdxLen = (i64)ibs.readBits(32);
                i64 firstLitLen = std::min(sizeChunk, (i64)8);

                if (litLen < 0 || litLen > (i64)litBuf.size())
                    throw Error("ROLZ inverse: invalid literals length");
                if (tkLen < 0 || tkLen > (i64)tkBuf.size())
                    throw Error("ROLZ inverse: invalid tokens length");
                if (mLenLen < 0 || mLenLen > (i64)mLenBuf.size())
                    throw Error("ROLZ inverse: invalid match lengths length");
                if (mIdxLen < 0 || mIdxLen > (i64)mIdxBuf.size())
                    throw Error("ROLZ inverse: invalid match indexes length");
                if (litLen < firstLitLen || litLen > sizeChunk)
                    throw Error("ROLZ inverse: invalid data");
                if ((tkLen == 0 && mIdxLen != 0) || (tkLen > 0 && mIdxLen + 1 != tkLen))
                    throw Error("ROLZ inverse: invalid data");
                litLenDecoded = litLen;

                ansDecodeChunked(ibs, litBuf.data(), litLen, litOrder, 0,
                                 bsVersion);
                ansDecodeChunked(ibs, tkBuf.data(), tkLen, 0, 32768, bsVersion);
                ansDecodeChunked(ibs, mLenBuf.data(), mLenLen, 0, 32768,
                                 bsVersion);
                ansDecodeChunked(ibs, mIdxBuf.data(), mIdxLen, 0, 32768,
                                 bsVersion);
                onlyLiterals = tkLen == 0;
                srcIdx += (i64)((ibs.read() + 7) >> 3);
            }

            if (onlyLiterals) {
                if (litLenDecoded != sizeChunk) throw Error("ROLZ inverse: invalid data");
                std::memcpy(buf, litBuf.data(), sizeChunk);
                dstIdx = sizeChunk;
                startChunk = endChunk;
                continue;
            }

            dstIdx = 0;
            i64 mm = bsVersion < 3 ? 2 : 8;
            // valid streams only reach here with tkLen > 0, which the
            // encoder never produces for a chunk smaller than the
            // preamble; crafted streams could (would write past buf)
            if (sizeChunk < mm)
                throw Error("ROLZ inverse: invalid data");
            for (i64 j = 0; j < mm; j++) buf[dstIdx++] = litBuf[litIdx++];

            while (dstIdx < sizeChunk) {
                u8 token = tkBuf[tkIdx++];
                int matchLen = token & 0x07;
                if (matchLen == 7) {
                    int c;
                    matchLen = readLengthROLZ(mLenBuf.data() + lenIdx, &c) + 7;
                    lenIdx += c;
                }
                i64 litLen2;
                if (token < 0xF8) {
                    litLen2 = token >> 3;
                } else {
                    int c;
                    litLen2 = readLengthROLZ(mLenBuf.data() + lenIdx, &c) + 31;
                    lenIdx += c;
                }

                if (litLen2 > 0) {
                    if (dstIdx + litLen2 > (i64)litBuf.size())
                        throw Error("ROLZ inverse: invalid data");
                    int srcInc = 0;
                    u8* d = buf + dstIdx - delta;
                    std::memcpy(d + delta, litBuf.data() + litIdx, litLen2);
                    if (minMatch == ROLZ_MIN_MATCH3) {
                        for (i64 nn = 0; nn < litLen2; nn++) {
                            u32 key = getKey1(d + nn);
                            i32 c = (counters[key] + 1) & maskChecks;
                            matches[((size_t)key << logPosChecks) + (u32)c] =
                                (u32)(dstIdx + nn);
                            counters[key] = c;
                            nn += (srcInc >> 6);
                            srcInc++;
                        }
                    } else {
                        for (i64 nn = 0; nn < litLen2; nn++) {
                            u32 key = getKey2(d + nn);
                            i32 c = (counters[key] + 1) & maskChecks;
                            matches[((size_t)key << logPosChecks) + (u32)c] =
                                (u32)(dstIdx + nn);
                            counters[key] = c;
                            nn += (srcInc >> 6);
                            srcInc++;
                        }
                    }
                    litIdx += litLen2;
                    dstIdx += litLen2;
                    if (dstIdx >= sizeChunk) {
                        if (dstIdx == sizeChunk) break;
                        throw Error("ROLZ inverse: invalid data");
                    }
                }

                // bound vs the CHUNK (dstIdx is chunk-relative): the
                // reference's dstEnd check under-constrains multi-chunk
                // streams and relies on Go bounds panics past it
                if (dstIdx + matchLen + minMatch > sizeChunk)
                    throw Error("ROLZ inverse: invalid data");
                i32 matchIdx = mIdxBuf[mIdx++] & 0xFF;
                u32 key = (minMatch == ROLZ_MIN_MATCH3) ? getKey1(buf + dstIdx - delta)
                                                        : getKey2(buf + dstIdx - delta);
                u32* m = matches.data() + ((size_t)key << logPosChecks);
                i64 ref = m[(counters[key] - matchIdx) & maskChecks];
                counters[key] = (counters[key] + 1) & maskChecks;
                m[counters[key]] = (u32)dstIdx;
                dstIdx = emitCopy(buf, dstIdx, ref, matchLen + minMatch);
            }
            startChunk = endChunk;
        }

        dstIdx += (startChunk - sizeChunk);
        if (dstIdx + 4 > cap || count - srcIdx != 4)
            throw Error("ROLZ inverse: invalid input data");
        dst[dstIdx] = src[srcIdx];
        dst[dstIdx + 1] = src[srcIdx + 1];
        dst[dstIdx + 2] = src[srcIdx + 2];
        dst[dstIdx + 3] = src[srcIdx + 3];
        srcIdx += 4;
        dstIdx += 4;
        if (srcIdx != count) throw Error("ROLZ inverse: invalid input data");
        *outLen = (i32)dstIdx;
        return 0;
    }
};

// ---------------------------------------------------------------------------
// Codec 2 (embedded CM coder, 'balz' lineage)
// ---------------------------------------------------------------------------
struct RolzCM {
    u8* buf;
    i64* idx;
    // Hard output bound for the ENCODER. The reference allocates
    // srcLen+srcLen/32 of slack and does not bounds-check per byte
    // (ROLZCodec.go:1351-1353 admits this); adversarial/incompressible
    // chunks CAN exceed that (>= 9 coded bits per literal byte), which in
    // Go panics the whole stream and in C++ was a heap overflow (found by
    // the round-4 fuzz seed 22222 under ASAN). Since *idx only grows and
    // limit > count, hitting the bound guarantees the final
    // "dstIdx >= count -> no compression -> skip" outcome, so aborting
    // early is observably identical to an unbounded run.
    i64 limit = INT64_MAX;
    bool overflow = false;
    u64 low = 0, high = ROLZ_TOP, current = 0;
    std::vector<int> probs[2];
    u32 logSize[2];
    int c1 = 1, pIdx = ROLZ_LITERAL_CTX, ctx = 0;
    int* p = nullptr;

    RolzCM(u32 litLogSize, u32 mLogSize, u8* b, i64* i) : buf(b), idx(i) {
        logSize[ROLZ_MATCH_CTX] = mLogSize;
        probs[ROLZ_MATCH_CTX].resize((size_t)256 << mLogSize);
        logSize[ROLZ_LITERAL_CTX] = litLogSize;
        probs[ROLZ_LITERAL_CTX].resize((size_t)256 << litLogSize);
        reset();
    }

    void reset() {
        std::fill(probs[0].begin(), probs[0].end(), ROLZ_PSCALE >> 1);
        std::fill(probs[1].begin(), probs[1].end(), ROLZ_PSCALE >> 1);
    }

    void setContext(int n, u8 c) {
        pIdx = n;
        ctx = (int)c << logSize[pIdx];
    }

    // encoder
    inline void encodeBit(int bit) {
        u64 split = (((high - low) >> 4) * (u64)(u32)(p[c1] >> 4)) >> 8;
        if (bit == 0) {
            low += split + 1;
            p[c1] -= (p[c1] >> 5);
            c1 += c1;
        } else {
            high = low + split;
            p[c1] -= ((p[c1] - ROLZ_PSCALE + 32) >> 5);
            c1 += c1 + 1;
        }
        while (((low ^ high) >> 24) == 0) {
            if (*idx + 4 > limit) {  // see `limit` note above
                overflow = true;
                return;
            }
            u32 v = (u32)(high >> 32);
            buf[*idx] = (u8)(v >> 24);
            buf[*idx + 1] = (u8)(v >> 16);
            buf[*idx + 2] = (u8)(v >> 8);
            buf[*idx + 3] = (u8)v;
            *idx += 4;
            low <<= 32;
            high = (high << 32) | RMASK_0_32;
        }
    }

    void encode9Bits(int val) {
        c1 = 1;
        p = probs[pIdx].data() + ctx;
        for (int b = 8; b >= 0; b--) encodeBit(val & (1 << b));
    }

    void encodeBits(int val, u32 n) {
        c1 = 1;
        p = probs[pIdx].data() + ctx;
        while (n != 0) {
            n--;
            encodeBit(val & (1 << n));
        }
    }

    void disposeEnc() {
        if (*idx + 8 > limit) {
            overflow = true;
            return;
        }
        for (int i = 0; i < 8; i++) {
            buf[*idx + i] = (u8)(low >> 56);
            low <<= 8;
        }
        *idx += 8;
    }

    // decoder
    void initDec() {
        current = 0;
        for (int i = 0; i < 8; i++)
            current = (current << 8) | (u64)buf[*idx + i];
        *idx += 8;
    }

    inline int decodeBit() {
        u64 mid = low + ((((high - low) >> 4) * (u64)(u32)(p[c1] >> 4)) >> 8);
        int bit;
        if (mid >= current) {
            bit = 1;
            high = mid;
            p[c1] -= ((p[c1] - ROLZ_PSCALE + 32) >> 5);
            c1 += c1 + 1;
        } else {
            bit = 0;
            low = mid + 1;
            p[c1] -= (p[c1] >> 5);
            c1 += c1;
        }
        while (((low ^ high) >> 24) == 0) {
            low = (low << 32) & RMASK_0_56;
            high = ((high << 32) | RMASK_0_32) & RMASK_0_56;
            u64 val = ((u64)buf[*idx] << 24) | ((u64)buf[*idx + 1] << 16) |
                      ((u64)buf[*idx + 2] << 8) | buf[*idx + 3];
            current = ((current << 32) | val) & RMASK_0_56;
            *idx += 4;
        }
        return bit;
    }

    int decode9Bits() {
        c1 = 1;
        p = probs[pIdx].data() + ctx;
        for (int b = 0; b < 9; b++) decodeBit();
        return c1 & 0x1FF;
    }

    int decodeBits(u32 n) {
        c1 = 1;
        int mask = (1 << n) - 1;
        p = probs[pIdx].data() + ctx;
        while (n != 0) {
            decodeBit();
            n--;
        }
        return c1 & mask;
    }
};

struct RolzC2 {
    std::vector<u32>& matches = rolzMatchesPoolC2();
    size_t matchesLen = 0;

    void resetMatches(size_t n) {
        matchesLen = n;
        hugePoolGrow(matches, n);
        std::memset(matches.data(), 0, n * sizeof(u32));
    }

    void clearMatches() {
        std::memset(matches.data(), 0, matchesLen * sizeof(u32));
    }
    std::vector<i32> counters;
    u32 logPosChecks;
    i32 maskChecks, posChecks;
    int minMatch = ROLZ_MIN_MATCH3;

    explicit RolzC2(u32 lpc) : logPosChecks(lpc) {
        posChecks = 1 << lpc;
        maskChecks = posChecks - 1;
        counters.assign(1 << 16, 0);
        resetMatches((size_t)ROLZ_HASH_SIZE << lpc);
    }

    void findMatch(const u8* buf, i64 bufLen, i64 pos, u32 key, int* outIdx, int* outLen) {
        int maxMatch = (int)std::min((i64)ROLZ_MAX_MATCH2, bufLen - pos);
        *outIdx = -1;
        *outLen = -1;
        u32* m = matches.data() + ((size_t)key << logPosChecks);
        i32 counter = counters[key];

        if (maxMatch >= minMatch) {
            // hash computed inside the bound check (the reference's order,
            // ROLZCodec.go:1019-1027) — at the tail, buf+pos+4 would read
            // past the block
            u32 hash32 = rolzhash(buf + pos);
            maxMatch -= 4;
            int bestLen = 0;
            int bestIdx = -1;
            const u8* curBuf = buf + pos;
            for (i32 i = counter; i > counter - posChecks; i--) {
                u32 ref = m[i & maskChecks];
                if ((ref & ROLZ_HASH_MASK) != hash32) continue;
                ref &= ~ROLZ_HASH_MASK;
                const u8* refBuf = buf + ref;
                if (refBuf[bestLen] != curBuf[bestLen]) continue;
                int n = 0;
                while (n < maxMatch) {
                    u32 diff = rle32(refBuf + n) ^ rle32(curBuf + n);
                    if (diff != 0) {
                        n += __builtin_ctz(diff) >> 3;
                        break;
                    }
                    n += 4;
                }
                if (n > bestLen) {
                    bestIdx = (int)i;
                    bestLen = n;
                    if (bestLen == maxMatch) break;
                }
            }
            counters[key] = (counters[key] + 1) & maskChecks;
            m[counters[key]] = hash32 | (u32)pos;
            if (bestLen >= minMatch) {
                *outIdx = (int)counter - bestIdx;
                *outLen = bestLen - minMatch;
            }
            return;
        }
        // maxMatch < minMatch: reference returns early WITHOUT registering
    }

    int forward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
        i64 required = count <= 16384 ? count + 1024 : count + count / 32;
        if (cap < required) return 1;
        // Degenerate multi-chunk tails (found by the round-4 corner scan):
        // the encoder chunks over srcEnd=count-4 but the decoder chunks
        // over count, so for count % CHUNK in 1..4 the chunk COUNTS
        // differ (the stream is emitted but undecodable — the reference
        // pair breaks identically), and for count % CHUNK in 5..11 the
        // fixed 8-literal chunk preamble overruns the tail chunk (the
        // reference panics; we previously read past the block then
        // skipped). Skip the transform up front in both corners.
        i64 srcEnd = count - 4;
        if (count > ROLZ_CHUNK_SIZE) {
            i64 tail = count % ROLZ_CHUNK_SIZE;
            if (tail != 0 && tail < 12) return 1;
        }
        i64 srcIdx = 0;
        i64 dstIdx = 5;
        i64 startChunk = 0;
        dst[0] = (u8)(count >> 24);
        dst[1] = (u8)(count >> 16);
        dst[2] = (u8)(count >> 8);
        dst[3] = (u8)count;
        RolzCM re(9, logPosChecks, dst, &dstIdx);
        re.limit = cap;

        std::fill(counters.begin(), counters.end(), 0);
        minMatch = ROLZ_MIN_MATCH3;
        int delta = 2;
        u8 flags = 0;

        int dt = ctx.dataType;
        if (dt == DT_UNDEFINED) {
            i32 freqs0[256];
            computeHistogram(src, count, freqs0);
            dt = detectSimpleType(count, freqs0);
            // (the reference only stores UNDEFINED back here — a quirk)
        }
        if (dt == DT_EXE) {
            delta = 3;
            flags |= 8;
        } else if (dt == DT_DNA) {
            // DELIBERATE divergence from the reference encoder
            // (ROLZCodec.go:1120-1123 emits flags=1 with minMatch=7 and
            // delta=2): with delta=2 the decoder's key — getKey2 reads 8
            // bytes from pos-2 — depends on SIX not-yet-decoded bytes, so
            // those streams are undecodable by ANY decoder, including the
            // reference's own (whose v4+ codec2 Inverse also never honors
            // flags==1). Found by the randomized differential fuzz. We emit
            // the combination the format's decoders DO define and decode
            // correctly (reference Inverse :1234-1239, flags&0x0E==4):
            // delta=8 keeps every key byte behind the decode frontier,
            // exactly like codec1's DNA mode (ROLZCodec.go:337-341).
            minMatch = ROLZ_MIN_MATCH7;
            delta = 8;
            flags = 4;
        }

        dst[4] = flags;
        i64 sizeChunk = std::min((i64)count, ROLZ_CHUNK_SIZE);

        while (startChunk < srcEnd) {
            clearMatches();
            i64 endChunk = startChunk + sizeChunk;
            if (endChunk >= srcEnd) endChunk = srcEnd;
            sizeChunk = endChunk - startChunk;
            re.reset();
            const u8* buf = src + startChunk;
            srcIdx = 0;

            i64 mm = 8;
            re.setContext(ROLZ_LITERAL_CTX, 0);
            if (startChunk >= srcEnd) mm = srcEnd - startChunk;
            for (i64 j = 0; j < mm; j++) {
                re.encode9Bits((ROLZ_LITERAL_FLAG << 8) | buf[srcIdx]);
                srcIdx++;
            }

            while (srcIdx < sizeChunk) {
                re.setContext(ROLZ_LITERAL_CTX, buf[srcIdx - 1]);
                u32 key = (minMatch == ROLZ_MIN_MATCH3) ? getKey1(buf + srcIdx - delta)
                                                        : getKey2(buf + srcIdx - delta);
                int matchIdx, matchLen;
                findMatch(buf, sizeChunk, srcIdx, key, &matchIdx, &matchLen);

                if (matchIdx < 0) {
                    re.encode9Bits((ROLZ_LITERAL_FLAG << 8) | buf[srcIdx]);
                    srcIdx++;
                    continue;
                }
                re.encode9Bits((ROLZ_MATCH_FLAG << 8) | matchLen);
                re.setContext(ROLZ_MATCH_CTX, buf[srcIdx - 1]);
                re.encodeBits(matchIdx, logPosChecks);
                srcIdx += matchLen + minMatch;
            }
            if (re.overflow) return 1;  // output >= cap > count: skip
            startChunk = endChunk;
        }

        srcIdx += (startChunk - sizeChunk);
        for (int i = 0; i < 4; i++) {
            re.setContext(ROLZ_LITERAL_CTX, src[srcIdx - 1]);
            re.encode9Bits((ROLZ_LITERAL_FLAG << 8) | src[srcIdx]);
            srcIdx++;
        }
        re.disposeEnc();
        if (re.overflow) return 1;

        if (srcIdx != count) return 1;
        if (dstIdx >= count) return 1;  // no compression
        *outLen = (i32)dstIdx;
        return 0;
    }

    int inverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
        int bsVersion = ctx.bsVersion > 0 ? ctx.bsVersion : 6;
        if (count < 5) throw Error("ROLZX inverse: invalid data");
        i64 dstEnd = (i64)(((u32)src[0] << 24) | ((u32)src[1] << 16) |
                           ((u32)src[2] << 8) | src[3]);
        if (dstEnd <= 0 || dstEnd > cap) throw Error("ROLZX inverse: invalid data");

        minMatch = ROLZ_MIN_MATCH3;
        i64 srcIdx = 4;
        u8 flags = src[4];
        int delta = 2;
        // flag semantics by stream version (ROLZCodec.go:1233-1248); pre-v3
        // streams carry no flags byte at all (srcIdx stays at 4)
        if (bsVersion >= 4) {
            if ((flags & 0x0E) == 8) {
                delta = 3;
            } else if ((flags & 0x0E) == 4) {
                delta = 8;
                minMatch = ROLZ_MIN_MATCH7;
            } else if (flags == 1) {
                // flags==1 is the reference encoder's DNA output
                // (ROLZCodec.go:1120-1123): minMatch=7 with delta=2, whose
                // decode keys depend on not-yet-decoded bytes — such
                // streams are undecodable by construction (the reference's
                // own v4+ decoder doesn't even parse flags==1 and garbles).
                // Reject cleanly instead of desyncing mid-block. Our
                // encoder emits the decodable flags=4 mode instead.
                throw Error("ROLZX inverse: stream uses the reference "
                            "encoder's undecodable DNA mode (flags=1)");
            }
            srcIdx++;
        } else if (bsVersion >= 3) {
            if (flags == 1) minMatch = ROLZ_MIN_MATCH7;
            srcIdx++;
        }

        i64 dstIdx = 0;
        i64 startChunk = 0;
        i64 sizeChunk = std::min((i64)cap, ROLZ_CHUNK_SIZE);
        RolzCM rd(9, logPosChecks, const_cast<u8*>(src), &srcIdx);
        rd.initDec();
        std::fill(counters.begin(), counters.end(), 0);

        while (startChunk < dstEnd) {
            clearMatches();
            i64 endChunk = startChunk + sizeChunk;
            if (endChunk > dstEnd) {
                endChunk = dstEnd;
                sizeChunk = endChunk - startChunk;
            }
            u8* buf = dst + startChunk;
            rd.reset();
            dstIdx = 0;

            i64 mm = bsVersion < 3 ? 2 : 8;
            rd.setContext(ROLZ_LITERAL_CTX, 0);
            // crafted streams can present a final chunk smaller than the
            // fixed preamble; valid streams cannot (the forward skips
            // degenerate tails), so reject instead of writing past buf
            if (sizeChunk < mm)
                throw Error("ROLZX inverse: invalid data");
            for (i64 j = 0; j < mm; j++) {
                int val = rd.decode9Bits();
                if ((val >> 8) == ROLZ_MATCH_FLAG)
                    throw Error("ROLZX inverse: invalid data");
                buf[dstIdx++] = (u8)val;
            }

            while (dstIdx < sizeChunk) {
                i64 savedIdx = dstIdx;
                u32 key = (minMatch == ROLZ_MIN_MATCH3) ? getKey1(buf + dstIdx - delta)
                                                        : getKey2(buf + dstIdx - delta);
                u32* m = matches.data() + ((size_t)key << logPosChecks);
                rd.setContext(ROLZ_LITERAL_CTX, buf[dstIdx - 1]);
                int val = rd.decode9Bits();

                if ((val >> 8) == ROLZ_LITERAL_FLAG) {
                    buf[dstIdx++] = (u8)val;
                } else {
                    int matchLen = val & 0xFF;
                    if (matchLen + 3 > dstEnd) throw Error("ROLZX inverse: invalid data");
                    // corrupt streams can otherwise emitCopy past the chunk
                    // (the reference relies on Go bounds panics here)
                    if (dstIdx + matchLen + minMatch > sizeChunk)
                        throw Error("ROLZX inverse: invalid data");
                    rd.setContext(ROLZ_MATCH_CTX, buf[dstIdx - 1]);
                    i32 matchIdx = rd.decodeBits(logPosChecks);
                    i64 ref = m[(counters[key] - matchIdx) & maskChecks];
                    if (ref < 0 || ref >= dstIdx)
                        throw Error("ROLZX inverse: invalid data");
                    dstIdx = emitCopy(buf, dstIdx, ref, matchLen + minMatch);
                }
                counters[key] = (counters[key] + 1) & maskChecks;
                m[counters[key]] = (u32)savedIdx;
            }
            startChunk = endChunk;
        }

        dstIdx += (startChunk - sizeChunk);
        if (srcIdx != count) throw Error("ROLZX inverse: invalid data");
        *outLen = (i32)dstIdx;
        return 0;
    }
};

int rolzForward(const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen, bool extra) {
    if (n < 64) return 1;  // min block size
    if (n > (1 << 30)) return 1;
    if (extra) {
        RolzC2 c(ROLZ_LOG_POS_CHECKS2);
        return c.forward(src, n, dst, cap, ctx, outLen);
    }
    RolzC1 c(ROLZ_LOG_POS_CHECKS1);
    return c.forward(src, n, dst, cap, ctx, outLen);
}

int rolzInverse(const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen, bool extra) {
    if (n < 5) throw Error("ROLZ inverse: input too small");
    if (extra) {
        RolzC2 c(ROLZ_LOG_POS_CHECKS2);
        return c.inverse(src, n, dst, cap, ctx, outLen);
    }
    RolzC1 c(ROLZ_LOG_POS_CHECKS1);
    return c.inverse(src, n, dst, cap, ctx, outLen);
}

}  // namespace kz
