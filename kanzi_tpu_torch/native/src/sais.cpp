// Suffix array construction via SA-IS (induced sorting), from scratch.
//
// The reference builds its BWT on Yuta Mori's divsufsort
// (v2/transform/DivSufSort.go); we use SA-IS instead — the suffix array of a
// string is unique, so the resulting BWT bytes are identical and the choice
// of algorithm is free (see SURVEY.md §7.1 step 5).
//
// Classic formulation with an explicit appended sentinel (unique smallest
// character at the end), which yields the standard order where a suffix that
// is a prefix of another sorts first — the same order divsufsort produces.
//
// Performance notes (this kernel dominates levels 5-7 encode).  Round-3
// restructure (libsais-class pass fusion, measured ~1.3x end to end on the
// bench corpus; the per-pass accounting that motivated it is in
// docs/ARCHITECTURE.md):
// - ONE fused left-to-right pass computes the symbol histogram AND collects
//   LMS positions (text order) into a scratch buffer with a branchless
//   append; the buffer then drives both LMS placements, removing the two
//   extra full-array scans (stage-1 re-scan + the stage-3 lmsPos rebuild)
//   the textbook formulation performs;
// - all recursion scratch (reduced string, its SA, the LMS buffer, fused
//   element arrays) comes from grow-only per-depth pools — the textbook
//   version allocated five fresh multi-MB vectors per recursion level,
//   which this host's allocator punishes (~6 ms/MB first-touch);
// - the (symbol, S/L-type) pair is fused into one element
//   `st = sym<<1|type`, so the induced-sort inner loops touch ONE random
//   cache line per suffix instead of two; level 0 uses u16 elements (257
//   symbols + type = 10 bits), halving memory traffic against an i32 symbol
//   array, and recursion levels with <32768 names (always, on text) do the
//   same;
// - the induced sorts software-prefetch the st element of the suffix
//   processed SAIS_PREFETCH iterations ahead (latency-bound random gathers;
//   the SA read itself is sequential); the scans are split so the main loop
//   carries no prefetch bounds check.
// Measured-and-rejected here (don't redo blindly): naming via an
// inverse-LMS index writing the reduced string directly (fewer passes but
// random scatter, 10-15% slower); fusing naming into the collect scan
// (slower); packed (pos,prev-sym) induce entries (round 2, neutral).
// Overturned in round 5: hugepage scratch, previously "neutral", wins 7%
// on the sort when advised BEFORE first touch (hugePoolGrow below; the
// old attempt advised already-4K-faulted pages, which does nothing — see
// the ledger entry in docs/ARCHITECTURE.md).
//
// Ge Nong, Sen Zhang, Wai Hong Chan:
// "Two Efficient Algorithms for Linear Time Suffix Array Construction" (2009).

#include <memory>

#include "kz.h"

namespace kz {

namespace {

constexpr int SAIS_PREFETCH = 16;

struct SaisScratch {
    std::vector<i32> s1, sa1, lms, collect, counts, buckets;
    std::vector<u16> st16;
    std::vector<u32> st32;
};

// Grow-only per-recursion-depth scratch (depth is O(log n), in practice <=5)
std::vector<std::unique_ptr<SaisScratch>>& saisScratchStack() {
    static thread_local std::vector<std::unique_ptr<SaisScratch>> s;
    return s;
}

SaisScratch& scratchAt(int depth) {
    auto& s = saisScratchStack();
    while ((int)s.size() <= depth) s.emplace_back(new SaisScratch);
    return *s[depth];
}

// st: length n, st[i] = (sym[i] << 1) | Stype[i]; sym values in [0, K);
// st[n-1] == 1 (sentinel: unique minimum symbol 0, S-type).
// SA: length n output.
template <typename ST>
void saisCore(const ST* st, i32* SA, i32 n, i32 K, int depth) {
    SaisScratch& S = scratchAt(depth);
    std::vector<i32>& counts = S.counts;
    std::vector<i32>& buckets = S.buckets;
    counts.assign(K, 0);
    buckets.resize(K);
    i32* lms = hugePoolGrow(S.lms, (size_t)(n >> 1) + 1);

    // Fused pass: symbol counts + LMS positions in text order (branchless
    // append: the slot is always written, the cursor advances only on LMS)
    i32 m = 0;
    {
        ST prev = st[0];
        counts[prev >> 1]++;
        for (i32 i = 1; i < n; i++) {
            ST cur = st[i];
            counts[cur >> 1]++;
            lms[m] = i;
            m += (cur & 1) & ~(prev & 1);
            prev = cur;
        }
    }

    auto bucketEnds = [&]() {
        i32 sum = 0;
        for (i32 i = 0; i < K; i++) {
            sum += counts[i];
            buckets[i] = sum;
        }
    };
    auto bucketStarts = [&]() {
        i32 sum = 0;
        for (i32 i = 0; i < K; i++) {
            buckets[i] = sum;
            sum += counts[i];
        }
    };

    // `collect`: when non-null, the S-type pass also gathers the sorted LMS
    // positions (ascending SA order into collect[0..m)), replacing the
    // separate full-array collect scan stage 1 used to run afterwards.
    // Safe because of the SA-IS single-pass invariant (Nong et al. §3: every
    // entry is induced strictly below the scan cursor and each slot is
    // written at most once, so the value the right-to-left cursor reads at
    // SA[i] is the pass's final value at i). The LMS test only adds a load
    // of st[j] — adjacent to the st[j-1] the induce already pulls, so it is
    // almost always the same cache line.
    auto induce = [&](i32* collect) {
        // L-type left-to-right (split so the hot loop has no prefetch
        // bounds check; writes only ever land at indices >= i, so the split
        // point does not change what the tail loop observes)
        bucketStarts();
        i32 lim = n - SAIS_PREFETCH > 0 ? n - SAIS_PREFETCH : 0;
        for (i32 i = 0; i < lim; i++) {
            i32 jp = SA[i + SAIS_PREFETCH];
            __builtin_prefetch(&st[(jp > 0 ? jp : 1) - 1]);
            i32 j = SA[i];
            if (j > 0) {
                ST prev = st[j - 1];
                if (!(prev & 1)) SA[buckets[prev >> 1]++] = j - 1;
            }
        }
        for (i32 i = lim; i < n; i++) {
            i32 j = SA[i];
            if (j > 0) {
                ST prev = st[j - 1];
                if (!(prev & 1)) SA[buckets[prev >> 1]++] = j - 1;
            }
        }
        // S-type right-to-left
        bucketEnds();
        i32 cnt = m;
        if (collect == nullptr) {
            for (i32 i = n - 1; i >= SAIS_PREFETCH; i--) {
                i32 jp = SA[i - SAIS_PREFETCH];
                __builtin_prefetch(&st[(jp > 0 ? jp : 1) - 1]);
                i32 j = SA[i];
                if (j > 0) {
                    ST prev = st[j - 1];
                    if (prev & 1) SA[--buckets[prev >> 1]] = j - 1;
                }
            }
            for (i32 i = (SAIS_PREFETCH < n ? SAIS_PREFETCH : n) - 1; i >= 0;
                 i--) {
                i32 j = SA[i];
                if (j > 0) {
                    ST prev = st[j - 1];
                    if (prev & 1) SA[--buckets[prev >> 1]] = j - 1;
                }
            }
        } else {
            for (i32 i = n - 1; i >= SAIS_PREFETCH; i--) {
                i32 jp = SA[i - SAIS_PREFETCH];
                __builtin_prefetch(&st[(jp > 0 ? jp : 1) - 1]);
                i32 j = SA[i];
                if (j > 0) {
                    ST prev = st[j - 1];
                    if (prev & 1) {
                        SA[--buckets[prev >> 1]] = j - 1;
                    } else if (st[j] & 1) {
                        collect[--cnt] = j;  // LMS: S with L predecessor
                    }
                }
            }
            for (i32 i = (SAIS_PREFETCH < n ? SAIS_PREFETCH : n) - 1; i >= 0;
                 i--) {
                i32 j = SA[i];
                if (j > 0) {
                    ST prev = st[j - 1];
                    if (prev & 1) {
                        SA[--buckets[prev >> 1]] = j - 1;
                    } else if (st[j] & 1) {
                        collect[--cnt] = j;
                    }
                }
            }
        }
        return cnt;
    };

    // Stage 1: place LMS suffixes at bucket ends (descending text order,
    // straight from the fused-pass buffer; prefetched — st[lms[i]] is a
    // random gather and lms is sequential, so the future element's address
    // is free), induce-sort the LMS substrings. The S-type pass collects
    // the sorted LMS positions as it goes (see `induce`), which replaces
    // the full-array collect scan this stage used to pay afterwards.
    std::fill(SA, SA + n, -1);
    bucketEnds();
    i32* sorted_lms = hugePoolGrow(S.collect, (size_t)m + 1);
    for (i32 i = m - 1; i >= SAIS_PREFETCH; i--) {
        __builtin_prefetch(&st[lms[i - SAIS_PREFETCH]]);
        i32 j = lms[i];
        SA[--buckets[st[j] >> 1]] = j;
    }
    for (i32 i = (SAIS_PREFETCH < m ? SAIS_PREFETCH : m) - 1; i >= 0; i--) {
        i32 j = lms[i];
        SA[--buckets[st[j] >> 1]] = j;
    }
    i32 mm = induce(sorted_lms);

    // Name LMS substrings in SA[m..] (ceil(n/2) slots suffice); two LMS
    // substrings get the same name iff symbols AND types match throughout,
    // which is exactly st-element equality. (A length-precompute + memcmp
    // variant was measured slower here: the cost is the random access to
    // the two substrings, not the per-element walk.)
    i32* names = SA + m;
    std::fill(names, SA + n, -1);
    auto isLMS = [&](i32 i) {
        return i > 0 && (st[i] & 1) && !(st[i - 1] & 1);
    };
    i32 name = 0, prev = -1;
    for (i32 i = 0; i < m; i++) {
        i32 pos = sorted_lms[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (i32 d = 0;; d++) {
                if (st[prev + d] != st[pos + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (isLMS(prev + d) || isLMS(pos + d))) {
                    diff = !(isLMS(prev + d) && isLMS(pos + d));
                    break;
                }
                // the sentinel (unique min, LMS) bounds every comparison,
                // so d cannot run past the end
            }
        }
        if (diff) {
            name++;
            prev = pos;
        }
        names[pos >> 1] = name - 1;
    }

    // Build the reduced string (LMS names in text order)
    i32* s1 = hugePoolGrow(S.s1, (size_t)m);
    i32* SA1 = hugePoolGrow(S.sa1, (size_t)m);
    for (i32 i = 0, j = 0; i < n - m; i++)
        if (names[i] >= 0) s1[j++] = names[i];

    // Stage 2: order LMS suffixes
    if (name < m) {
        // recurse on the reduced string: compute its types, fuse, and go.
        // Text-like inputs keep every recursion level's alphabet small
        // (measured: <25k names at all depths on mixed text), so u16 fused
        // elements — half the random-gather footprint of the induce loops —
        // apply almost always; u32 is the correctness fallback.
        if (name < 32768) {
            u16* st1 = hugePoolGrow(S.st16, (size_t)m);
            st1[m - 1] = (u16)((s1[m - 1] << 1) | 1);
            for (i32 i = m - 2; i >= 0; i--) {
                bool sType = (s1[i] < s1[i + 1]) ||
                             (s1[i] == s1[i + 1] && (st1[i + 1] & 1));
                st1[i] = (u16)((s1[i] << 1) | (sType ? 1 : 0));
            }
            saisCore<u16>(st1, SA1, m, name, depth + 1);
        } else {
            u32* st1 = hugePoolGrow(S.st32, (size_t)m);
            st1[m - 1] = (u32)(s1[m - 1] << 1) | 1;
            for (i32 i = m - 2; i >= 0; i--) {
                bool sType = (s1[i] < s1[i + 1]) ||
                             (s1[i] == s1[i + 1] && (st1[i + 1] & 1));
                st1[i] = ((u32)s1[i] << 1) | (sType ? 1 : 0);
            }
            saisCore<u32>(st1, SA1, m, name, depth + 1);
        }
        // the recursion reused counts/buckets via its own depth slot, so
        // this level's histograms are intact
    } else {
        for (i32 i = 0; i < m; i++) SA1[s1[i]] = i;
    }

    // Stage 3: place fully sorted LMS suffixes (text positions via the
    // fused-pass buffer), induce the final SA. Software-pipelined
    // prefetch: SA1 reads sequentially, lms[SA1[i]] is the first random
    // gather and st[lms[SA1[i]]] the second — prefetch lms two steps out
    // and st one step out (the lms element prefetched earlier is in cache
    // by then, so loading it to form the st address is cheap).
    std::fill(SA, SA + n, -1);
    bucketEnds();
    for (i32 i = m - 1; i >= 2 * SAIS_PREFETCH; i--) {
        __builtin_prefetch(&lms[SA1[i - 2 * SAIS_PREFETCH]]);
        __builtin_prefetch(&st[lms[SA1[i - SAIS_PREFETCH]]]);
        i32 j = lms[SA1[i]];
        SA[--buckets[st[j] >> 1]] = j;
    }
    for (i32 i = (2 * SAIS_PREFETCH < m ? 2 * SAIS_PREFETCH : m) - 1; i >= 0;
         i--) {
        i32 j = lms[SA1[i]];
        SA[--buckets[st[j] >> 1]] = j;
    }
    induce(nullptr);
    (void)mm;
}

struct SaisPools {
    std::vector<u16> st;
    std::vector<i32> sa;
};

SaisPools& saisPools() {
    static thread_local SaisPools p;
    return p;
}

}  // namespace

// Suffix array into the thread-local pool; returns a pointer to it (valid
// until the next suffix-sort call on this thread).  Lets the BWT forward
// consume the SA without a fresh n-word allocation + n-word copy per block.
const i32* suffixArrayView(const u8* src, i32 n) {
    SaisPools& pools = saisPools();
    std::vector<u16>& st = pools.st;
    hugePoolGrow(st, (size_t)n + 1);
    // fused (symbol+1, type) elements, right to left
    st[n] = 1;  // sentinel: symbol 0, S-type
    {
        u16 next = (u16)(((u16)src[n - 1] + 1) << 1);  // L vs sentinel
        st[n - 1] = next;
        for (i32 i = n - 2; i >= 0; i--) {
            u16 symShifted = (u16)(((u16)src[i] + 1) << 1);
            u16 nextSym = (u16)(next & ~(u16)1);
            u16 cur = symShifted;
            if (symShifted < nextSym || (symShifted == nextSym && (next & 1)))
                cur |= 1;
            st[i] = cur;
            next = cur;
        }
    }
    std::vector<i32>& SA = pools.sa;
    hugePoolGrow(SA, (size_t)n + 1);
    saisCore<u16>(st.data(), SA.data(), n + 1, 257, 0);
    // SA[0] is the sentinel suffix; drop it
    return SA.data() + 1;
}

// Standard suffix array of src (length n >= 1) into sa.
void suffixArray(const u8* src, i32* sa, i32 n) {
    if (n <= 0) return;
    if (n == 1) {
        sa[0] = 0;
        return;
    }
    std::memcpy(sa, suffixArrayView(src, n), (size_t)n * sizeof(i32));
}

}  // namespace kz
