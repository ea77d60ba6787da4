// BWTS: bijective Burrows-Wheeler transform (Scott), no primary index.
//
// Format spec: reference v2/transform/BWTS.go (forward after Neal Burns'
// mk-bwts): standard suffix array, then Lyndon-factor rotations applied to
// SA/ISA in place; inverse is an LF-mapping cycle walk.

#include "kz.h"

namespace kz {

void suffixArray(const u8* src, i32* sa, i32 n);

static i32 moveLyndonWordHead(i32* sa, i32* isa, const u8* data, i32 count,
                              i32 start, i32 size, i32 rank) {
    i32 end = start + size;
    while (rank + 1 < count) {
        i32 nextStart0 = sa[rank + 1];
        if (nextStart0 <= end) break;
        i32 nextStart = nextStart0;
        i32 k = 0;
        while (k < size && nextStart < count && data[start + k] == data[nextStart]) {
            k++;
            nextStart++;
        }
        if (k == size && rank < isa[nextStart]) break;
        if (k < size && nextStart < count && data[start + k] < data[nextStart]) break;
        sa[rank] = nextStart0;
        isa[nextStart0] = rank;
        rank++;
    }
    sa[rank] = start;
    isa[start] = rank;
    return rank;
}

int bwtsForward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    (void)ctx;
    if (cap < count) return 1;
    if (count < 2) {
        if (count == 1) dst[0] = src[0];
        *outLen = count;
        return 0;
    }

    // per-thread pooled (hugepage-advised) like the BWT scratch: both
    // arrays are fully rewritten below before any read
    static thread_local std::vector<i32> saPool, isaPool;
    i32* sa = hugePoolGrow(saPool, (size_t)count);
    i32* isa = hugePoolGrow(isaPool, (size_t)count);
    suffixArray(src, sa, count);
    for (i32 i = 0; i < count; i++) isa[sa[i]] = i;

    i32 minv = isa[0];
    i32 idxMin = 0;
    for (i32 i = 1; i < count && minv > 0; i++) {
        if (isa[i] >= minv) continue;
        i32 refRank = moveLyndonWordHead(sa, isa, src, count,
                                         idxMin, i - idxMin, minv);
        for (i32 j = i - 1; j > idxMin; j--) {
            i32 testRank = isa[j];
            i32 startRank = testRank;
            while (testRank < count - 1) {
                i32 nextRankStart = sa[testRank + 1];
                if (j > nextRankStart || src[j] != src[nextRankStart] ||
                    refRank < isa[nextRankStart + 1])
                    break;
                sa[testRank] = nextRankStart;
                isa[nextRankStart] = testRank;
                testRank++;
            }
            sa[testRank] = j;
            isa[j] = testRank;
            refRank = testRank;
            if (startRank == testRank) break;
        }
        minv = isa[i];
        idxMin = i;
    }

    minv = count;
    for (i32 i = 0; i < count; i++) {
        if (isa[i] >= minv) {
            dst[isa[i]] = src[i - 1];
            continue;
        }
        if (minv < count) dst[minv] = src[i - 1];
        minv = isa[i];
    }
    dst[0] = src[count - 1];
    *outLen = count;
    return 0;
}

int bwtsInverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    (void)ctx;
    if (cap < count) throw Error("BWTS inverse: output too small");
    if (count < 2) {
        if (count == 1) dst[0] = src[0];
        *outLen = count;
        return 0;
    }

    static thread_local std::vector<i32> lfPool;
    i32* lf = hugePoolGrow(lfPool, (size_t)count);  // fully rewritten below
    i32 buckets[256] = {0};
    for (i32 i = 0; i < count; i++) buckets[src[i]]++;
    i32 sum = 0;
    for (int i = 0; i < 256; i++) {
        sum += buckets[i];
        buckets[i] = sum - buckets[i];
    }
    for (i32 i = 0; i < count; i++) lf[i] = buckets[src[i]]++;

    for (i32 i = 0, j = count - 1; j >= 0; i++) {
        if (lf[i] < 0) continue;
        i32 p = i;
        for (;;) {
            dst[j--] = src[p];
            i32 t = lf[p];
            lf[p] = -1;
            p = t;
            if (lf[p] < 0) break;
        }
    }
    *outLen = count;
    return 0;
}

}  // namespace kz
