// Sequential-scan byte transforms: SBRT (MTF/Rank/Timestamp), SRT, ZRLT, RLT.
//
// Format specs: reference v2/transform/SBRT.go, SRT.go, ZRLT.go, RLT.go.
// All are small-state sequential scans; block batching provides parallelism.

#include "kz.h"

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace kz {

void computeHistogram(const u8* block, i64 len, i32* freqs);
int detectSimpleType(i64 count, const i32* freqs0);

enum {
    DT_UNDEFINED = 0, DT_MULTIMEDIA = 2, DT_BASE64 = 5, DT_DNA = 6, DT_UTF8 = 8,
};

// ---------------------------------------------------------------------------
// SBRT: sort-by-rank family parameterized by (mask1, mask2, shift)
// ---------------------------------------------------------------------------

// First index >= i in s[0..n) whose byte differs from c (vectorized run
// scan). Post-BWT data is ~85% distance-1 repeats with mean run length ~7,
// so one 64-byte compare usually covers the whole run.
static inline i32 runEnd(const u8* s, i32 i, i32 n, u8 c) {
#ifdef __AVX512BW__
    __m512i vc = _mm512_set1_epi8((char)c);
    while (i + 64 <= n) {
        u64 m = _mm512_cmpneq_epi8_mask(
            _mm512_loadu_si512((const void*)(s + i)), vc);
        if (m) return i + (i32)__builtin_ctzll(m);
        i += 64;
    }
#endif
    while (i < n && s[i] == c) i++;
    return i;
}
int sbrtForward(const u8* src, i32 count, u8* dst, i64 cap, int mode, i32* outLen) {
    if (cap < count) return 1;
    int mask1 = (mode == 3) ? 0 : -1;  // TIMESTAMP
    int mask2 = (mode == 1) ? 0 : -1;  // MTF
    u32 shift = (mode == 2) ? 1 : 0;   // RANK

    u8 s2r[256], r2s[256];
    i32 p[256] = {0};
    i32 qr[256] = {0};  // the rank list's keys, indexed BY RANK: scanning
                        // it directly avoids the q[r2s[r-1]] dependent-load
                        // chain of the naive walk (post-BWT data hits large
                        // ranks, making this the hot loop of level 5)
    for (int i = 0; i < 256; i++) s2r[i] = r2s[i] = (u8)i;

    if (mode == 1) {
        // MTF: the walk always reaches rank 0 (every key is a smaller
        // position index), so it is a pure move-to-front: a short scalar
        // head for the common near-front hits (memchr's setup cost exceeds
        // a 4-entry scan), vectorized find beyond, one memmove, no rank map
        for (i32 i = 0; i < count;) {
            u8 c = src[i];
            if (r2s[0] == c) {
                // front hit: the whole run of c emits zeros with no list
                // movement — batch it (see the RANK path run collapse)
                i32 j = runEnd(src, i + 1, count, c);
                std::memset(dst + i, 0, (size_t)(j - i));
                i = j;
                continue;
            }
            u32 r;
            if (r2s[1] == c) {
                r = 1;
            } else if (r2s[2] == c) {
                r = 2;
            } else if (r2s[3] == c) {
                r = 3;
            } else {
                r = (u32)((const u8*)std::memchr(r2s, c, 256) - r2s);
            }
            dst[i] = (u8)r;
            std::memmove(r2s + 1, r2s, r);  // r >= 1: front hits batched above
            r2s[0] = c;
            i++;
        }
        *outLen = count;
        return 0;
    }

#ifdef __AVX512F__
    if (mode == 2) {
        // RANK fast path (the hot loop of level-5 encode, measured 1.5-1.7x
        // on post-BWT data).  Two structural changes vs the generic walk:
        // - no s2r map at all: the symbol's rank is found by comparing the
        //   64-entry r2s vectors (post-BWT data answers at rank 0 ~69% of
        //   the time, so the first-element check short-circuits);  this
        //   removes the per-move s2r fixup loop entirely — the costliest
        //   part of long moves;
        // - qr is sorted descending by construction, so the backward walk
        //   `while (qr[rt-1] <= qc) rt--` equals counting entries > qc,
        //   which vectorizes to compare-mask popcounts.
        alignas(64) u8 r2sv[256];
        alignas(64) i32 qrv[256] = {0};
        i32 pv[256] = {0};
        for (int i = 0; i < 256; i++) r2sv[i] = (u8)i;
        for (i32 i = 0; i < count;) {
            u8 c = src[i];
            if (r2sv[0] == c) {
                // Rank-0 hit: r=0 forces rt=0 (the backward count runs over
                // an empty prefix), so c stays at the front and the whole
                // run of c collapses to zeros. Stepwise the recurrence is
                // qc_k = (k + p_prev)>>1 with p_prev = k-1 from the second
                // element on, so after the run qrv[0] = j-2 and pv[c] = j-1
                // — identical to executing the loop per element (~85% of
                // post-BWT symbols take this path; measured run stats in
                // docs/ARCHITECTURE.md).
                i32 j = runEnd(src, i + 1, count, c);
                std::memset(dst + i, 0, (size_t)(j - i));
                qrv[0] = (j - i == 1) ? (i + pv[c]) >> 1 : j - 2;
                pv[c] = j - 1;
                i = j;
                continue;
            }
            u32 r;
            {
                __m512i vc = _mm512_set1_epi8((char)c);
                u64 m0 = _mm512_cmpeq_epi8_mask(
                    _mm512_load_si512((const void*)&r2sv[0]), vc);
                if (m0) {
                    r = (u32)__builtin_ctzll(m0);
                } else {
                    u64 m1 = _mm512_cmpeq_epi8_mask(
                        _mm512_load_si512((const void*)&r2sv[64]), vc);
                    if (m1) {
                        r = 64 + (u32)__builtin_ctzll(m1);
                    } else {
                        u64 m2 = _mm512_cmpeq_epi8_mask(
                            _mm512_load_si512((const void*)&r2sv[128]), vc);
                        if (m2) {
                            r = 128 + (u32)__builtin_ctzll(m2);
                        } else {
                            r = 192 + (u32)__builtin_ctzll(
                                _mm512_cmpeq_epi8_mask(_mm512_load_si512(
                                    (const void*)&r2sv[192]), vc));
                        }
                    }
                }
            }
            dst[i] = (u8)r;
            i32 qc = (i + pv[c]) >> 1;
            pv[c] = i;
            u32 rt;
            if (r <= 4) {
                rt = r;
                while (rt > 0 && qrv[rt - 1] <= qc) rt--;
            } else {
                __m512i vqc = _mm512_set1_epi32(qc);
                u32 cnt = 0;
                u32 full = r & ~15u;
                for (u32 k = 0; k < full; k += 16) {
                    __m512i v = _mm512_load_si512((const void*)&qrv[k]);
                    cnt += (u32)_mm_popcnt_u32(
                        _mm512_cmpgt_epi32_mask(v, vqc));
                }
                if (r & 15) {
                    __mmask16 lane = (__mmask16)((1u << (r & 15)) - 1);
                    __m512i v = _mm512_maskz_load_epi32(
                        lane, (const void*)&qrv[full]);
                    cnt += (u32)_mm_popcnt_u32(
                        _mm512_mask_cmpgt_epi32_mask(lane, v, vqc));
                }
                rt = cnt;
            }
            if (rt < r) {
                std::memmove(&r2sv[rt + 1], &r2sv[rt], r - rt);
                std::memmove(&qrv[rt + 1], &qrv[rt], (r - rt) * sizeof(i32));
            }
            r2sv[rt] = c;
            qrv[rt] = qc;
            i++;
        }
        *outLen = count;
        return 0;
    }
#endif

    for (i32 i = 0; i < count; i++) {
        u8 c = src[i];
        u32 r = s2r[c];
        dst[i] = (u8)r;
        i32 qc = ((i & mask1) + (p[c] & mask2)) >> shift;
        p[c] = i;
        u32 rt = r;
        while (rt > 0 && qr[rt - 1] <= qc) rt--;
        if (rt < r) {
            std::memmove(&r2s[rt + 1], &r2s[rt], r - rt);
            std::memmove(&qr[rt + 1], &qr[rt], (r - rt) * sizeof(i32));
            for (u32 j = rt + 1; j <= r; j++) s2r[r2s[j]] = (u8)j;
        }
        r2s[rt] = c;
        qr[rt] = qc;
        s2r[c] = (u8)rt;
    }
    *outLen = count;
    return 0;
}

int sbrtInverse(const u8* src, i32 count, u8* dst, i64 cap, int mode, i32* outLen) {
    if (cap < count) throw Error("SBRT inverse: output too small");
    int mask1 = (mode == 3) ? 0 : -1;
    int mask2 = (mode == 1) ? 0 : -1;
    u32 shift = (mode == 2) ? 1 : 0;

    u8 r2s[256];
    i32 p[256] = {0};
    i32 qr[256] = {0};  // keys by rank (see sbrtForward)
    for (int i = 0; i < 256; i++) r2s[i] = (u8)i;

    if (mode == 1) {  // pure MTF (see sbrtForward)
        for (i32 i = 0; i < count;) {
            u32 r = src[i];
            if (r == 0) {  // batch the zero-rank run (front symbol repeats)
                u8 c0 = r2s[0];
                i32 j = runEnd(src, i + 1, count, 0);
                std::memset(dst + i, c0, (size_t)(j - i));
                i = j;
                continue;
            }
            u8 c = r2s[r];
            dst[i] = c;
            std::memmove(r2s + 1, r2s, r);
            r2s[0] = c;
            i++;
        }
        *outLen = count;
        return 0;
    }

#ifdef __AVX512F__
    if (mode == 2) {
        // RANK inverse fast path (the hot loop of level-5 decode): the rank
        // comes straight from the input byte, so the remaining cost is the
        // backward walk — qr is descending-sorted by construction, so it
        // vectorizes to compare-mask popcounts exactly like the forward.
        alignas(64) u8 r2sv[256];
        alignas(64) i32 qrv[256] = {0};
        i32 pv[256] = {0};
        for (int i = 0; i < 256; i++) r2sv[i] = (u8)i;
        for (i32 i = 0; i < count;) {
            u32 r = src[i];
            if (r == 0) {
                // mirror of the forward's rank-0 run collapse: a run of
                // zero ranks keeps r2sv[0] at the front; decode it as one
                // memset with the same end-state recurrence
                u8 c0 = r2sv[0];
                i32 j = runEnd(src, i + 1, count, 0);
                std::memset(dst + i, c0, (size_t)(j - i));
                qrv[0] = (j - i == 1) ? (i + pv[c0]) >> 1 : j - 2;
                pv[c0] = j - 1;
                i = j;
                continue;
            }
            u8 c = r2sv[r];
            dst[i] = c;
            i32 qc = (i + pv[c]) >> 1;
            pv[c] = i;
            u32 rt;
            if (r <= 4) {
                rt = r;
                while (rt > 0 && qrv[rt - 1] <= qc) rt--;
            } else {
                __m512i vqc = _mm512_set1_epi32(qc);
                u32 cnt = 0;
                u32 full = r & ~15u;
                for (u32 k = 0; k < full; k += 16) {
                    __m512i v = _mm512_load_si512((const void*)&qrv[k]);
                    cnt += (u32)_mm_popcnt_u32(
                        _mm512_cmpgt_epi32_mask(v, vqc));
                }
                if (r & 15) {
                    __mmask16 lane = (__mmask16)((1u << (r & 15)) - 1);
                    __m512i v = _mm512_maskz_load_epi32(
                        lane, (const void*)&qrv[full]);
                    cnt += (u32)_mm_popcnt_u32(
                        _mm512_mask_cmpgt_epi32_mask(lane, v, vqc));
                }
                rt = cnt;
            }
            if (rt < r) {
                std::memmove(&r2sv[rt + 1], &r2sv[rt], r - rt);
                std::memmove(&qrv[rt + 1], &qrv[rt], (r - rt) * sizeof(i32));
            }
            r2sv[rt] = c;
            qrv[rt] = qc;
            i++;
        }
        *outLen = count;
        return 0;
    }
#endif

    for (i32 i = 0; i < count; i++) {
        u32 r = src[i];
        u8 c = r2s[r];
        dst[i] = c;
        i32 qc = ((i & mask1) + (p[c] & mask2)) >> shift;
        p[c] = i;
        u32 rt = r;
        while (rt > 0 && qr[rt - 1] <= qc) rt--;
        if (rt < r) {
            std::memmove(&r2s[rt + 1], &r2s[rt], r - rt);
            std::memmove(&qr[rt + 1], &qr[rt], (r - rt) * sizeof(i32));
        }
        r2s[rt] = c;
        qr[rt] = qc;
    }
    *outLen = count;
    return 0;
}

// ---------------------------------------------------------------------------
// SRT: sorted-rank transform with 256-varint frequency header
// ---------------------------------------------------------------------------
static int srtPreprocess(const i32* freqs, u8* symbols) {
    int nbSymbols = 0;
    for (int i = 0; i < 256; i++)
        if (freqs[i] != 0) symbols[nbSymbols++] = (u8)i;
    // Shell sort by (freq desc, symbol asc)
    int h = 4;
    while (h < nbSymbols) h = h * 3 + 1;
    do {
        h /= 3;
        for (int i = h; i < nbSymbols; i++) {
            u8 t = symbols[i];
            int b;
            for (b = i - h;
                 b >= 0 && (freqs[symbols[b]] < freqs[t] ||
                            (t < symbols[b] && freqs[t] == freqs[symbols[b]]));
                 b -= h)
                symbols[b + h] = symbols[b];
            symbols[b + h] = t;
        }
    } while (h != 1);
    return nbSymbols;
}

int srtForward(const u8* src, i32 count, u8* dst, i64 cap, i32* outLen) {
    if (cap < (i64)count + 4 * 256) return 1;
    // zero-initialized: the vector rank search loads the full 256-byte
    // array; stale bytes beyond nbSymbols can never win (the true match
    // always has the lowest index) but must be deterministic
    alignas(64) u8 r2s[256] = {0};
    i32 freqs[256] = {0};

    for (i32 i = 0, b = 0; i < count;) {
        u8 c = src[i];
        if (freqs[c] == 0) {
            r2s[b] = c;
            b++;
        }
        i32 j = i + 1;
        while (j < count && src[j] == c) j++;
        freqs[c] += j - i;
        i = j;
    }

    u8 symbols[256];
    int nbSymbols = srtPreprocess(freqs, symbols);
    i32 buckets[256] = {0};
    for (int i = 0, bucketPos = 0; i < nbSymbols; i++) {
        u8 c = symbols[i];
        buckets[c] = bucketPos;
        bucketPos += freqs[c];
    }

    // header: 256 little-varint freqs
    int headerSize = 0;
    for (int i = 0; i < 256; i++) {
        i32 f = freqs[i];
        while (f >= 128) {
            dst[headerSize++] = (u8)(0x80 | (f & 0x7F));
            f >>= 7;
        }
        dst[headerSize++] = (u8)f;
    }
    u8* out = dst + headerSize;

    // the rank update is an unconditional move-to-front: find the symbol's
    // rank with a vectorized scan and shift with one memmove — no
    // symbol->rank map to maintain (the naive walk is O(rank) dependent
    // loads/stores and dominates on post-BWT data).  Post-BWT symbols sit
    // near the front of the MTF list most of the time, so a 4-entry scalar
    // head beats memchr's setup cost; the tail uses direct 64-byte vector
    // compares (no call overhead) where available.
    for (i32 i = 0; i < count;) {
        u8 c = src[i];
        u32 r;
        if (r2s[0] == c) {
            r = 0;
        } else if (r2s[1] == c) {
            r = 1;
        } else if (r2s[2] == c) {
            r = 2;
        } else if (r2s[3] == c) {
            r = 3;
        } else {
#ifdef __AVX512BW__
            __m512i vc = _mm512_set1_epi8((char)c);
            u64 m = _mm512_cmpeq_epi8_mask(
                _mm512_loadu_si512((const void*)&r2s[0]), vc);
            if (m) {
                r = (u32)__builtin_ctzll(m);
            } else if (nbSymbols > 64) {
                m = _mm512_cmpeq_epi8_mask(
                    _mm512_loadu_si512((const void*)&r2s[64]), vc);
                if (m) {
                    r = 64 + (u32)__builtin_ctzll(m);
                } else if (nbSymbols > 128) {
                    m = _mm512_cmpeq_epi8_mask(
                        _mm512_loadu_si512((const void*)&r2s[128]), vc);
                    if (m) {
                        r = 128 + (u32)__builtin_ctzll(m);
                    } else {
                        r = 192 + (u32)__builtin_ctzll(
                            _mm512_cmpeq_epi8_mask(_mm512_loadu_si512(
                                (const void*)&r2s[192]), vc));
                    }
                } else {
                    r = 0;  // unreachable on valid input: c is in r2s
                }
            } else {
                r = 0;      // unreachable on valid input
            }
#else
            r = (u32)((const u8*)std::memchr(r2s, c, (size_t)nbSymbols) - r2s);
#endif
        }
        i32 pp = buckets[c];
        out[pp++] = (u8)r;
        if (r > 0) {
            std::memmove(r2s + 1, r2s, r);
            r2s[0] = c;
        }
        // the rest of the run emits zeros into c's bucket: one vectorized
        // run scan + memset (post-BWT input is ~85% distance-1 repeats)
        i32 j = runEnd(src, i + 1, count, c);
        if (j - i > 1) std::memset(out + pp, 0, (size_t)(j - i - 1));
        pp += j - i - 1;
        i = j;
        buckets[c] = pp;
    }
    *outLen = count + headerSize;
    return 0;
}

int srtInverse(const u8* src, i32 count, u8* dst, i64 cap, i32* outLen) {
    i32 freqs[256];
    int headerSize = 0;
    for (int i = 0; i < 256; i++) {
        if (headerSize >= count) throw Error("SRT inverse: invalid header");
        i32 val = src[headerSize++];
        if (val < 128) {
            freqs[i] = val;
            continue;
        }
        i32 res = val & 0x7F;
        val = src[headerSize++];
        res |= (val & 0x7F) << 7;
        if (val >= 128) {
            val = src[headerSize++];
            res |= (val & 0x7F) << 14;
            if (val >= 128) {
                val = src[headerSize++];
                res |= (val & 0x7F) << 21;
            }
        }
        freqs[i] = res;
    }
    const u8* in = src + headerSize;
    i32 n = count - headerSize;
    if (n < 0 || n > cap) throw Error("SRT inverse: invalid data");

    u8 symbols[256];
    int nbSymbols = srtPreprocess(freqs, symbols);
    i32 buckets[256] = {0}, bucketEnds[256] = {0};
    u8 r2s[256] = {0};

    for (int i = 0, bucketPos = 0; i < nbSymbols; i++) {
        u8 c = symbols[i];
        if (bucketPos < 0 || bucketPos > n) throw Error("SRT inverse: invalid data");
        r2s[in[bucketPos]] = c;
        buckets[c] = bucketPos + 1;
        bucketPos += freqs[c];
        bucketEnds[c] = bucketPos;
    }

    if (nbSymbols == 0) {
        *outLen = 0;
        return 0;
    }
    u8 c = r2s[0];
    for (i32 i = 0; i < n;) {
        // each emission of c consumes one rank byte from c's bucket; a run
        // of zero ranks keeps c at the front, so it collapses to one run
        // scan + memset (mirror of the forward's zero-run emission)
        i32 b = buckets[c], e = bucketEnds[c];
        if (b < e) {
            i32 j = runEnd(in, b, std::min(e, b + (n - i) - 1), 0);
            if (j > b) {
                std::memset(dst + i, c, (size_t)(j - b));
                i += j - b;
                buckets[c] = j;
                if (i >= n) break;
                b = j;
            }
            dst[i++] = c;
            if (b < e) {
                u8 r = in[b];
                buckets[c] = b + 1;
                if (r == 0) continue;  // only when the cap clipped the scan
                std::memmove(r2s, r2s + 1, r);  // shift ranks 1..r down
                r2s[r] = c;
                c = r2s[0];
            } else {
                if (nbSymbols == 1) continue;
                nbSymbols--;
                for (int s = 0; s < nbSymbols; s++) r2s[s] = r2s[s + 1];
                c = r2s[0];
            }
        } else {
            dst[i++] = c;
            if (nbSymbols == 1) continue;
            nbSymbols--;
            for (int s = 0; s < nbSymbols; s++) r2s[s] = r2s[s + 1];
            c = r2s[0];
        }
    }
    *outLen = n;
    return 0;
}

// ---------------------------------------------------------------------------
// ZRLT: zero run lengths in binary, one bit per byte, MSB implied
// ---------------------------------------------------------------------------
int zrltForward(const u8* src, i32 count, u8* dst, i64 cap, i32* outLen) {
    if (cap < count) return 1;
    i64 srcEnd = count, dstEnd = count;  // do not expand
    i64 srcIdx = 0, dstIdx = 0;
    bool res = true;

    while (srcIdx < srcEnd) {
        if (src[srcIdx] == 0) {
            i64 runStart = srcIdx - 1;
            srcIdx++;
            while (srcIdx + 1 < srcEnd && (src[srcIdx] | src[srcIdx + 1]) == 0)
                srcIdx += 2;
            while (srcIdx < srcEnd && src[srcIdx] == 0) srcIdx++;
            i64 runLength = srcIdx - runStart;
            u32 log2v = log2_32((u32)runLength);
            if (dstIdx >= dstEnd - (i64)log2v) {
                res = false;
                break;
            }
            while (log2v > 0) {
                log2v--;
                dst[dstIdx++] = (u8)((runLength >> log2v) & 1);
            }
            continue;
        }
        if (src[srcIdx] >= 0xFE) {
            if (dstIdx >= dstEnd - 1) {
                res = false;
                break;
            }
            dst[dstIdx++] = 0xFF;
            dst[dstIdx] = src[srcIdx] - 0xFE;
        } else {
            if (dstIdx >= dstEnd) {
                res = false;
                break;
            }
            dst[dstIdx] = src[srcIdx] + 1;
        }
        srcIdx++;
        dstIdx++;
    }

    if (srcIdx != srcEnd || !res) return 1;  // skip: no compression
    *outLen = (i32)dstIdx;
    return 0;
}

int zrltInverse(const u8* src, i32 count, u8* dst, i64 cap, i32* outLen) {
    i64 srcEnd = count, dstEnd = cap;
    i64 srcIdx = 0, dstIdx = 0;
    i64 runLength = 0;
    bool atEnd = false;

    while (!atEnd) {
        if (src[srcIdx] <= 1) {
            runLength = 1;
            while (src[srcIdx] <= 1) {
                runLength += runLength + src[srcIdx];
                srcIdx++;
                if (srcIdx >= srcEnd) {
                    atEnd = true;
                    break;
                }
            }
            if (atEnd) break;
            runLength--;
            if (runLength >= dstEnd - dstIdx) break;
            while (runLength > 0) {
                runLength--;
                dst[dstIdx++] = 0;
            }
        }
        if (src[srcIdx] == 0xFF) {
            srcIdx++;
            if (srcIdx >= srcEnd) break;
            dst[dstIdx] = 0xFE + src[srcIdx];
        } else {
            dst[dstIdx] = src[srcIdx] - 1;
        }
        srcIdx++;
        dstIdx++;
        if (srcIdx >= srcEnd || dstIdx >= dstEnd) break;
    }

    if (runLength > 0) {
        runLength--;
        if (runLength > dstEnd - dstIdx) throw Error("ZRLT inverse: output too small");
        while (runLength > 0) {
            runLength--;
            dst[dstIdx++] = 0;
        }
    }
    if (srcIdx < srcEnd) throw Error("ZRLT inverse: output too small");
    *outLen = (i32)dstIdx;
    return 0;
}

// ---------------------------------------------------------------------------
// RLT: escaped run-length transform, threshold 3
// ---------------------------------------------------------------------------
static constexpr int RLT_ENC1 = 224;
static constexpr int RLT_ENC2 = (255 - RLT_ENC1) << 8;
static constexpr int RLT_THRESHOLD = 3;
static constexpr int RLT_MAX_RUN = 0xFFFF + RLT_ENC2 + RLT_THRESHOLD - 1;
static constexpr int RLT_MAX_RUN4 = RLT_MAX_RUN - 4;

static int rltEmitRunLength(u8* dst, int run) {
    run -= RLT_THRESHOLD;
    if (run < RLT_ENC1) {
        dst[0] = (u8)run;
        return 1;
    }
    int dstIdx;
    if (run < RLT_ENC2) {
        run -= RLT_ENC1;
        dst[0] = (u8)(RLT_ENC1 + (run >> 8));
        dstIdx = 1;
    } else {
        run -= RLT_ENC2;
        dst[0] = 0xFF;
        dst[1] = (u8)(run >> 8);
        dstIdx = 2;
    }
    dst[dstIdx] = (u8)run;
    return dstIdx + 1;
}

int rltForward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (count < 16) return 1;
    i64 required = count <= 512 ? count + 32 : count;
    if (cap < required) return 1;

    int dt = ctx.dataType;
    if (dt == DT_DNA || dt == DT_BASE64 || dt == DT_UTF8) return 1;
    // fast-entropy codecs use the fixed default escape
    bool findBestEscape = true;
    int e = ctx.entropyType;
    if (e == 0 || e == 1 || e == 4 || e == 5) findBestEscape = false;

    u8 escape = 0xFB;
    if (findBestEscape) {
        i32 freqs[256];
        computeHistogram(src, count, freqs);
        if (dt == DT_UNDEFINED) {
            dt = detectSimpleType(count, freqs);
            if (dt != DT_UNDEFINED) ctx.dataType = dt;
            if (dt == DT_DNA || dt == DT_BASE64 || dt == DT_UTF8) return 1;
        }
        int minIdx = 0;
        if (freqs[minIdx] > 0) {
            for (int i = 0; i < 256; i++) {
                if (freqs[i] < freqs[minIdx]) {
                    minIdx = i;
                    if (freqs[i] == 0) break;
                }
            }
        }
        escape = (u8)minIdx;
    }

    i64 srcIdx = 0, dstIdx = 0;
    i64 srcEnd = count, srcEnd4 = count - 4, dstEnd = cap;
    int run = 0;
    bool failed = false;
    u8 prev = src[srcIdx++];
    dst[dstIdx++] = escape;
    dst[dstIdx++] = prev;
    if (prev == escape) dst[dstIdx++] = 0;

    for (;;) {
        if (prev == src[srcIdx]) {
            u32 v = 0x01010101u * prev;
            u32 w;
            std::memcpy(&w, src + srcIdx, 4);
            if (v == w) {
                srcIdx += 4;
                run += 4;
                if (run < RLT_MAX_RUN4 && srcIdx < srcEnd4) continue;
            } else {
                srcIdx++;
                run++;
                if (prev == src[srcIdx]) {
                    srcIdx++;
                    run++;
                    if (prev == src[srcIdx]) {
                        srcIdx++;
                        run++;
                        if (run < RLT_MAX_RUN4 && srcIdx < srcEnd4) continue;
                    }
                }
            }
        }

        if (run > RLT_THRESHOLD) {
            if (dstIdx + 6 >= dstEnd) {
                failed = true;
                break;
            }
            dst[dstIdx++] = prev;
            if (prev == escape) dst[dstIdx++] = 0;
            dst[dstIdx++] = escape;
            dstIdx += rltEmitRunLength(dst + dstIdx, run);
        } else if (prev != escape) {
            if (dstIdx + run >= dstEnd) {
                failed = true;
                break;
            }
            while (run > 0) {
                dst[dstIdx++] = prev;
                run--;
            }
        } else {
            if (dstIdx + 2 * run >= dstEnd) {
                failed = true;
                break;
            }
            while (run > 0) {
                dst[dstIdx] = escape;
                dst[dstIdx + 1] = 0;
                dstIdx += 2;
                run--;
            }
        }

        prev = src[srcIdx++];
        run = 1;
        if (srcIdx >= srcEnd4) break;
    }

    if (!failed) {
        // run == 1
        if (prev != escape) {
            if (dstIdx + run < dstEnd) {
                while (run > 0) {
                    dst[dstIdx++] = prev;
                    run--;
                }
            }
        } else {
            if (dstIdx + 2 * run < dstEnd) {
                while (run > 0) {
                    dst[dstIdx] = escape;
                    dst[dstIdx + 1] = 0;
                    dstIdx += 2;
                    run--;
                }
            }
        }
        while (srcIdx < srcEnd && dstIdx < dstEnd) {
            if (src[srcIdx] == escape) {
                if (dstIdx + 2 >= dstEnd) break;
                dst[dstIdx] = escape;
                dst[dstIdx + 1] = 0;
                dstIdx += 2;
                srcIdx++;
                continue;
            }
            dst[dstIdx++] = src[srcIdx++];
        }
        if (srcIdx != srcEnd) failed = true;
        else if (dstIdx >= srcIdx) failed = true;  // no compression
    }

    if (failed) return 1;
    *outLen = (i32)dstIdx;
    return 0;
}

int rltInverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    (void)ctx;
    if (count < 2) throw Error("RLT inverse: invalid data");
    i64 srcIdx = 0, dstIdx = 0;
    i64 srcEnd = count, dstEnd = cap;
    u8 escape = src[srcIdx++];

    if (src[srcIdx] == escape) {
        srcIdx++;
        if (srcIdx < srcEnd && src[srcIdx] != 0)
            throw Error("RLT inverse: input starts with a run");
        srcIdx++;
        dst[dstIdx++] = escape;
    }

    while (srcIdx < srcEnd) {
        if (src[srcIdx] != escape) {
            if (dstIdx >= dstEnd) throw Error("RLT inverse: invalid data");
            dst[dstIdx++] = src[srcIdx++];
            continue;
        }
        srcIdx++;
        if (srcIdx >= srcEnd) throw Error("RLT inverse: invalid data");
        int run = src[srcIdx++];
        if (run == 0) {
            if (dstIdx >= dstEnd) throw Error("RLT inverse: invalid data");
            dst[dstIdx++] = escape;
            continue;
        }
        if (run == 0xFF) {
            if (srcIdx + 1 >= srcEnd) throw Error("RLT inverse: invalid data");
            run = ((int)src[srcIdx] << 8) | src[srcIdx + 1];
            srcIdx += 2;
            run += RLT_ENC2;
        } else if (run >= RLT_ENC1) {
            if (srcIdx >= srcEnd) throw Error("RLT inverse: invalid data");
            run = ((run - RLT_ENC1) << 8) | src[srcIdx];
            run += RLT_ENC1;
            srcIdx++;
        }
        run += RLT_THRESHOLD - 1;
        if (run > RLT_MAX_RUN || dstIdx + run >= dstEnd)
            throw Error("RLT inverse: invalid run length");
        u8 val = dst[dstIdx - 1];
        std::memset(dst + dstIdx, val, run);
        dstIdx += run;
    }
    *outLen = (i32)dstIdx;
    return 0;
}

}  // namespace kz
