// Burrows-Wheeler Transform: forward (via SA-IS) and the two inverse
// LF-mapping walks, plus the block codec that frames the primary indexes.
//
// Format spec: reference v2/transform/BWT.go, BWTBlockCodec.go,
// DivSufSort.go:179-311 (ComputeBWT output layout and per-chunk primary
// index rule: indexes[q] records the SA rank + 1 of the suffix starting at
// q*step, step = ceil(n/chunks); 8 chunks when n >= 256).
//
// Output layout: dst[0] = src[n-1]; BWT rows follow with the primary row
// (suffix 0) removed — dst[j+1] = src[SA[j]-1] for j < pIdx, dst[j] for
// j > pIdx.
//
// Inverse: <= 4 MiB blocks use mergeTPSI (packed (prev<<8|byte) vector, 8
// chunk cursors in lockstep); larger blocks use biPSIv2 (bucket/fastBits
// structure). The 8-cursor lockstep is this domain's sequence parallelism —
// the device kernel batches cursors across blocks.

#include <thread>

#include "kz.h"

namespace kz {

void suffixArray(const u8* src, i32* sa, i32 n);
const i32* suffixArrayView(const u8* src, i32 n);
void computeHistogram(const u8* block, i64 len, i32* freqs);

static constexpr i32 BWT_MAX_BLOCK_SIZE = 1024 * 1024 * 1024;
static constexpr int BWT_NB_FASTBITS = 17;
static constexpr i32 BWT_MASK_FASTBITS = (1 << BWT_NB_FASTBITS) - 1;
static constexpr i32 BWT_THRESHOLD1 = 256;
static constexpr i32 BWT_THRESHOLD2 = 4 * 1024 * 1024;

static inline int bwtChunks(i32 size) { return size < BWT_THRESHOLD1 ? 1 : 8; }

// Grow-only per-thread scratch for the inverse walks: keeps the multi-MB
// LF vectors on warm (and hugepage-collapsed) memory instead of paying
// first-touch faults per block. Zeroing semantics of the fresh vectors the
// reference allocates per call (BWT.go:219,377) are preserved explicitly at
// each use site — the walks' corrupted-stream behavior depends on them.
struct BwtInverseScratch {
    std::vector<i32> data;
    std::vector<i32> buckets;
    std::vector<u16> fastBits;
};

static BwtInverseScratch& bwtScratch() {
    static thread_local BwtInverseScratch s;
    return s;
}

// indexes[8]: filled with primary indexes (SA rank + 1 of chunk starts)
static void bwtForwardCore(const u8* src, u8* dst, i32 n, u32* indexes) {
    if (n == 1) {
        dst[0] = src[0];
        indexes[0] = 1;
        return;
    }
    // SA stays in the sorter's thread-local pool: no fresh n-word vector
    // (first-touch costs ~6 ms/MB here) and no n-word copy out
    const i32* saView = suffixArrayView(src, n);

    int idxCount = bwtChunks(n);
    i32 step = n / idxCount;
    if (step * idxCount != n) step++;

    // One fused pass: primary-index detection via an exact multiply-shift
    // reciprocal (s*step <= 2^60 < 2^62 for n <= 1 GiB, so q == s/step
    // exactly), prefetched gathers for the dst[j] = src[sa[j]-1] scatter.
    // ~2x faster than the separate modulo scan + two gather loops.
    u64 recip = (~(u64)0 >> 2) / (u64)step + 1;  // floor(2^62/step) + 1
    dst[0] = src[n - 1];
    i32 pIdx = -1;
    for (i32 j = 0; j < n; j++) {
        if (j + 24 < n) __builtin_prefetch(&src[saView[j + 24] - 1]);
        i32 s = saView[j];
        u64 q = (u64)(((unsigned __int128)(u32)s * recip) >> 62);
        if ((i64)(q * (u64)step) == (i64)s) indexes[q] = (u32)(j + 1);
        if (s == 0) {
            pIdx = j;
            continue;  // primary row: no preceding character
        }
        dst[j + (pIdx < 0 ? 1 : 0)] = src[s - 1];
    }
    indexes[0] = (u32)(pIdx + 1);
}

// mergeTPSI inverse for n <= 4 MiB (reference BWT.go:211-358)
static void inverseMergeTPSI(const u8* src, u8* dst, i32 count, const u32* indexes) {
    i32 pIdx = (i32)indexes[0];
    if (pIdx <= 0 || pIdx > count) throw Error("corrupted BWT primary index");

    // max(count, 256): on a corrupted stream the 0xFF00|src[0] sentinel
    // entry can surface mid-walk as cursor value 255; a zeroed slot there
    // keeps the walk in bounds (garbage output is caught by the checksum).
    // The fill below writes every slot in [0, count) (the bucket offsets
    // form an exact permutation), so only the count < 256 padding needs the
    // explicit zeroing the fresh reference vector provided.
    i32* data = hugePoolGrow(bwtScratch().data, (size_t)std::max(count, 256));
    if (count < 256) std::memset(data, 0, 256 * sizeof(i32));
    i32 buckets[256];
    {
        i32 freqs[256];
        computeHistogram(src, count, freqs);
        i32 sum = 0;
        for (int i = 0; i < 256; i++) {
            i32 tmp = freqs[i];
            buckets[i] = sum;
            sum += tmp;
        }
    }
    data[buckets[src[0]]] = (i32)0xFF00 | src[0];
    buckets[src[0]]++;
    for (i32 i = 1; i < pIdx; i++) {
        i32 val = src[i];
        data[buckets[val]] = ((i - 1) << 8) | val;
        buckets[val]++;
    }
    for (i32 i = pIdx; i < count; i++) {
        i32 val = src[i];
        data[buckets[val]] = (i << 8) | val;
        buckets[val]++;
    }

    if (bwtChunks(count) != 8) {
        i32 t = pIdx - 1;
        for (i32 i = 0; i < count; i++) {
            i32 ptr = data[t];
            dst[i] = (u8)ptr;
            t = ptr >> 8;
        }
    } else {
        i32 ckSize = count >> 3;
        if (ckSize * 8 != count) ckSize++;
        i32 t[8];
        for (int c = 0; c < 8; c++) {
            t[c] = (i32)indexes[c] - 1;
            if (t[c] < 0 || t[c] >= count) throw Error("corrupted BWT primary index");
        }
        u8* d[8];
        for (int c = 0; c < 8; c++) d[c] = dst + c * ckSize;
        i32 end = count - ckSize * 7;  // last chunk may be shorter
        i32 nn = 0;
        for (; nn < end; nn++) {
            for (int c = 0; c < 8; c++) {
                i32 ptr = data[t[c]];
                d[c][nn] = (u8)ptr;
                t[c] = ptr >> 8;
            }
        }
        for (; nn < ckSize; nn++) {
            for (int c = 0; c < 7; c++) {
                i32 ptr = data[t[c]];
                d[c][nn] = (u8)ptr;
                t[c] = ptr >> 8;
            }
        }
    }
}

// biPSIv2 inverse for n > 4 MiB (reference BWT.go:361-628)
static void inverseBiPSIv2(const u8* src, u8* dst, i32 count, const u32* indexes,
                           int jobs) {
    i32 pIdx = (i32)indexes[0];
    if (pIdx <= 0 || pIdx > count) throw Error("corrupted BWT primary index");
    // every chunk's index seeds a walk cursor into data[0..count] and
    // fastBits[idx >> shift]: validate all 8 like mergeTPSI does (a
    // corrupted chunk index would otherwise read far out of bounds)
    for (int c = 0; c < 8; c++) {
        i32 idx = (i32)indexes[c];
        if (idx < 0 || idx > count) throw Error("corrupted BWT primary index");
    }

    // pooled, explicitly zeroed: unlike mergeTPSI the fill skips the two
    // primary-index slots, and on corrupted streams stale pool values here
    // could index fastBits out of bounds — the zeroing is load-bearing
    BwtInverseScratch& scratch = bwtScratch();
    i32* data = hugePoolGrow(scratch.data, (size_t)count + 1);
    std::memset(data, 0, ((size_t)count + 1) * sizeof(i32));
    i32 freqs[256];
    computeHistogram(src, count, freqs);
    // one sentinel slot: the decode walk scans `while (buckets[s] <= p) s++`
    // and a corrupted stream can drive s past the last real bucket
    i32* buckets = hugePoolGrow(scratch.buckets, (size_t)65537);
    std::memset(buckets, 0, 65537 * sizeof(i32));
    buckets[65536] = INT32_MAX;

    for (i32 c = 0, sum = 1; c < 256; c++) {
        i32 f = sum;
        sum += freqs[c];
        freqs[c] = f;
        if (f != sum) {
            i32* ptr = buckets + (c << 8);
            i32 hi = std::min(sum, pIdx);
            i32 lo = std::max(f - 1, pIdx);
            for (i32 i = f; i < hi; i++) ptr[src[i]]++;
            for (i32 i = lo; i < sum - 1; i++) ptr[src[i]]++;
        }
    }

    int lastc = src[0];
    u16* fastBits = hugePoolGrow(scratch.fastBits, (size_t)BWT_MASK_FASTBITS + 1);
    std::memset(fastBits, 0, ((size_t)BWT_MASK_FASTBITS + 1) * sizeof(u16));
    u32 shift = 0;
    while ((count >> shift) > BWT_MASK_FASTBITS) shift++;

    for (i32 c = 0, v = 0, sum = 1; c < 256; c++) {
        if (c == lastc) sum++;
        i32* ptr = buckets + c;
        for (i32 d = 0; d < 256; d++) {
            i32 val = ptr[d << 8];
            ptr[d << 8] = sum;
            sum += val;
            if (val != 0) {
                u16 fb = (u16)((c << 8) | d);
                i32 ve = (sum - 1) >> shift;
                while (v <= ve) fastBits[v++] = fb;
            }
        }
    }

    for (i32 i = 0; i < pIdx; i++) {
        int c = src[i];
        i32 p = freqs[c];
        freqs[c]++;
        if (p < pIdx) {
            i32 idx = (c << 8) | src[p];
            data[buckets[idx]] = i;
            buckets[idx]++;
        } else if (p > pIdx) {
            i32 idx = (c << 8) | src[p - 1];
            data[buckets[idx]] = i;
            buckets[idx]++;
        }
    }
    for (i32 i = pIdx; i < count; i++) {
        int c = src[i];
        i32 p = freqs[c];
        freqs[c]++;
        if (p < pIdx) {
            i32 idx = (c << 8) | src[p];
            data[buckets[idx]] = i + 1;
            buckets[idx]++;
        } else if (p > pIdx) {
            i32 idx = (c << 8) | src[p - 1];
            data[buckets[idx]] = i + 1;
            buckets[idx]++;
        }
    }

    for (i32 c = 0; c < 256; c++) {
        i32 c256 = c << 8;
        for (i32 d = 0; d < c; d++)
            std::swap(buckets[(d << 8) | c], buckets[c256 | d]);
    }

    int chunks = bwtChunks(count);
    i32 ckSize = count / chunks;
    if (ckSize * chunks != count) ckSize++;

    // Chunk walks: each chunk's LF-walk is independent given its primary
    // index, so chunk groups run on threads when jobs > 1 (reference
    // BWT.go:473-500 runs the same split on goroutines). The reference lets
    // both sides of a group boundary write the shared byte (same value);
    // here each non-first task instead diverts its very first byte write to
    // a per-task slot applied after the join, so no two threads ever touch
    // the same dst byte (a formal C++ data race the Go memory model shrugs
    // off).
    auto walkChunks = [&](int firstChunk, int lastChunk, u8* firstByteOut) {
        i32 start = (i32)firstChunk * ckSize;
        for (int c = firstChunk; c < lastChunk; c++) {
            i32 end = std::min(start + ckSize, count - 1);
            i32 p = (i32)indexes[c];
            i32 i = start + 1;
            if (firstByteOut != nullptr && c == firstChunk && i <= end) {
                u32 s = fastBits[p >> shift];
                while (buckets[s] <= p) s++;
                *firstByteOut = (u8)(s >> 8);   // dst[start], applied later
                dst[i] = (u8)s;
                p = data[p];
                i += 2;
            }
            for (; i <= end; i += 2) {
                u32 s = fastBits[p >> shift];
                while (buckets[s] <= p) s++;
                dst[i - 1] = (u8)(s >> 8);
                dst[i] = (u8)s;
                p = data[p];
            }
            start = end;
        }
    };

    int nbTasks = std::min(jobs > 0 ? jobs : 1, chunks);
    if (nbTasks <= 1) {
        // Single-thread: interleave all chunk walks in one loop so the 8
        // independent LF chains keep ~8 cache misses in flight instead of 1
        // (the same memory-level-parallelism trick mergeTPSI uses; byte
        // order of writes is irrelevant — boundary bytes carry the same
        // value from both sides, as the threaded split relies on).
        i32 p[8], ii[8], ee[8];
        i32 minSteps = INT32_MAX;
        for (int c = 0; c < chunks; c++) {
            i32 start = (i32)c * ckSize;
            ee[c] = std::min(start + ckSize, count - 1);
            p[c] = (i32)indexes[c];
            ii[c] = start + 1;
            i32 steps = ii[c] <= ee[c] ? (ee[c] - ii[c]) / 2 + 1 : 0;
            minSteps = std::min(minSteps, steps);
        }
        for (i32 nn = 0; nn < minSteps; nn++) {
            for (int c = 0; c < chunks; c++) {
                u32 s = fastBits[p[c] >> shift];
                while (buckets[s] <= p[c]) s++;
                dst[ii[c] - 1] = (u8)(s >> 8);
                dst[ii[c]] = (u8)s;
                p[c] = data[p[c]];
                ii[c] += 2;
            }
        }
        for (int c = 0; c < chunks; c++) {
            for (; ii[c] <= ee[c]; ii[c] += 2) {
                u32 s = fastBits[p[c] >> shift];
                while (buckets[s] <= p[c]) s++;
                dst[ii[c] - 1] = (u8)(s >> 8);
                dst[ii[c]] = (u8)s;
                p[c] = data[p[c]];
            }
        }
    } else {
        // ComputeJobsPerTask split (v2/internal/Global.go:424-460)
        std::vector<std::thread> threads;
        u8 firstBytes[8] = {0};
        i32 firstPos[8] = {0};
        int q = chunks / nbTasks, r = chunks - q * nbTasks;
        int c = 0;
        for (int j = 0; j < nbTasks; j++) {
            int take = q + (j < r ? 1 : 0);
            firstPos[j] = (i32)c * ckSize;
            threads.emplace_back(walkChunks, c, c + take,
                                 j > 0 ? &firstBytes[j] : nullptr);
            c += take;
        }
        for (auto& t : threads) t.join();
        for (int j = 1; j < nbTasks; j++)
            if (firstPos[j] < count - 1) dst[firstPos[j]] = firstBytes[j];
    }

    dst[count - 1] = (u8)lastc;
}

// ---------------------------------------------------------------------------
// BWTBlockCodec: header (mode byte + primary indexes) + BWT payload
// ---------------------------------------------------------------------------
int bwtBlockForward(const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    (void)ctx;
    if (n > BWT_MAX_BLOCK_SIZE) return 1;
    if ((i64)n + 33 > cap) return 1;

    u32 logBlockSize = n < 2 ? 0 : log2_32((u32)n);
    if (n & (n - 1)) logBlockSize++;
    int pIndexSize = (int)(logBlockSize + 7) >> 3;
    if (pIndexSize <= 0 || pIndexSize >= 5) return 1;
    int chunks = bwtChunks(n);
    u32 logNbChunks = log2_32((u32)chunks);
    int headerSize = chunks * pIndexSize + 1;

    u32 indexes[8] = {0};
    bwtForwardCore(src, dst + headerSize, n, indexes);

    dst[0] = (u8)((logNbChunks << 2) | (u32)(pIndexSize - 1));
    int idx = 1;
    for (int i = 0; i < chunks; i++) {
        u32 primaryIndex = indexes[i] - 1;
        for (int shift = (pIndexSize - 1) << 3; shift >= 0; shift -= 8)
            dst[idx++] = (u8)(primaryIndex >> shift);
    }
    *outLen = n + headerSize;
    return 0;
}

int bwtBlockInverse(const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (n <= 1) throw Error("BWT inverse: invalid size");
    u32 indexes[8] = {0};
    i32 blockSize;
    int headerSize;
    if (ctx.bsVersion > 0 && ctx.bsVersion < 6) {
        // legacy per-chunk headers: mode byte embeds the primary index's
        // top 6 bits and its byte width (reference BWTBlockCodec.go:193-221)
        int chunks = bwtChunks(n);
        int idx = 0;
        blockSize = n;
        for (int i = 0; i < chunks; i++) {
            if (idx >= n) throw Error("BWT inverse: invalid header size");
            int blockMode = src[idx++];
            int pIndexSizeBytes = 1 + ((blockMode >> 6) & 0x03);
            if (blockSize < pIndexSizeBytes)
                throw Error("BWT inverse: invalid compressed length");
            blockSize -= pIndexSizeBytes;
            int shift = (pIndexSizeBytes - 1) << 3;
            u32 primaryIndex = (u32)(blockMode & 0x3F) << shift;
            for (int k = 1; k < pIndexSizeBytes; k++) {
                shift -= 8;
                primaryIndex |= (u32)src[idx++] << shift;
            }
            indexes[i] = primaryIndex;
        }
        headerSize = idx;
    } else {
        u8 mode = src[0];
        u32 logNbChunks = (mode >> 2) & 0x07;
        int pIndexSize = (mode & 0x03) + 1;
        int chunks = 1 << logNbChunks;
        headerSize = chunks * pIndexSize + 1;
        if (n < headerSize) throw Error("BWT inverse: invalid header size");
        blockSize = n - headerSize;
        if (chunks != bwtChunks(blockSize)) throw Error("BWT inverse: invalid number of chunks");

        int idx = 1;
        for (int i = 0; i < chunks; i++) {
            u32 primaryIndex = 0;
            for (int shift = (pIndexSize - 1) << 3; shift >= 0; shift -= 8)
                primaryIndex = (primaryIndex << 8) | src[idx++];
            indexes[i] = primaryIndex + 1;
        }
    }

    if (cap < blockSize) throw Error("BWT inverse: output buffer too small");
    const u8* payload = src + headerSize;
    if (blockSize == 0) {
        *outLen = 0;
        return 0;
    }
    if (blockSize == 1) {
        dst[0] = payload[0];
        *outLen = 1;
        return 0;
    }
    if (blockSize <= BWT_THRESHOLD2)
        inverseMergeTPSI(payload, dst, blockSize, indexes);
    else
        inverseBiPSIv2(payload, dst, blockSize, indexes, ctx.jobs);
    *outLen = blockSize;
    return 0;
}

}  // namespace kz
