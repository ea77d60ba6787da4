// Suffix order by Manber-Myers prefix doubling (K9).
//
// kz_prefix_double replaces kanzi_tpu/ops/suffix_sort.py: _prefix_double,
// an XLA while_loop whose every round sorts (rank[i], rank[i + k]) with a
// stable lexsort, relabels the suffixes with dense ranks and doubles k
// until every rank is distinct.
//
// Bound: bytes. A round moves a few dozen bytes per suffix it sorts (the
// key and index through each radix pass, the relabel's reads and
// scatters); the arithmetic is a shift and a compare per element. The
// rounds are serial: about log2 of the longest repeat.
//
// Design: sort only what is unsorted.
// - State: `order` holds the suffix order of the real suffixes (the pads
//   n..size-1 sit at the tail from the start: their ranks 256 + i exceed
//   every symbol and differ), grp[s] the position in `order` where suffix
//   s's group starts (a group: the suffixes whose first 2^r symbols are
//   equal after round r). Group starts order the groups as the plain
//   version's dense ranks do, so a round's keys compare alike. The
//   active list holds the positions of the suffixes in groups of two or
//   more, in order, with each one's group as a dense index among them.
// - A round (a few launches on the caller's stream):
//   1. keys of the active suffixes only: key = group << b | (r2 + 1),
//      r2 = grp[s + k] or -1 at or past n (so -1 sorts below every rank);
//      the first round takes the symbols as groups and ranks (b = 9). The
//      pass reduces the OR and the AND of all keys;
//   2. a stable LSD radix sort of (key, suffix), 8-bit digits, written
//      here: a per-warp digit histogram of each 1024-element chunk, an
//      exclusive scan of the counts in (digit, chunk) order, and a scatter
//      in which each warp ranks its chunk's elements 32 at a time
//      (__match_any_sync: the rank among equal digits is the count of
//      lower lanes). A digit in which no key bit varies (the OR and AND
//      agree there) is skipped. The group is the key's major part, so each
//      group's suffixes come back to its own slots of `order`;
//   3. relabel: a key that differs from the one before starts a group at
//      its position; one tiled scan (tile sums, one CTA over the tiles,
//      each tile's scan) carries the last start (a max), the count of
//      suffixes that stay active and the count of active groups, and the
//      apply pass writes the order, grp of each sorted suffix, and the next
//      active list and its length. A suffix whose new group is itself is
//      final and is never keyed again.
// - The loop reads the next round's active count and its keys' OR and AND
//   back in one synchronisation a round (the next keys are built before
//   the read; the key pass reads the count from the device). It stops
//   when no suffix is active (every rank distinct) or k reaches size, as
//   the plain version stops, so the rounds agree. The order of distinct
//   ranks is unique, so it equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kChunk = 1024;      // elements a warp ranks (32 x 32)
constexpr int kScanThreads = 1024;
constexpr int kPerThread = 8;          // relabel: elements a thread scans
constexpr int64_t kTile = kThreads * kPerThread;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kPadKey = ~0ull;   // above every key: sorts last

// Inclusive scan over a CTA of kT threads; `total` gets the CTA's sum.
// `ws` holds 32 ints of shared memory; every thread must call it.
template <int kT>
__device__ __forceinline__ int block_scan(int v, int* ws, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += t;
    }
    if (lane == 31) ws[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = lane < kT / 32 ? ws[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(kFull, w, o);
            if (lane >= o) w += t;
        }
        ws[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += ws[warp - 1];
    total = ws[kT / 32 - 1];
    __syncthreads();
    return v;
}

// The relabel's scan element: counts (low 32 bits: suffixes that stay
// active; high 32: active groups) and the last group start (a max)
struct Agg {
    unsigned long long c;
    int h;
};

__device__ __forceinline__ Agg combine(Agg a, Agg b) {
    return {a.c + b.c, a.h > b.h ? a.h : b.h};
}

// Inclusive scan of Agg over a CTA of kT threads, as block_scan
template <int kT>
__device__ __forceinline__ Agg agg_scan(Agg v, Agg* ws, Agg& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const Agg t = {__shfl_up_sync(kFull, v.c, o), __shfl_up_sync(kFull, v.h, o)};
        if (lane >= o) v = combine(t, v);
    }
    if (lane == 31) ws[warp] = v;
    __syncthreads();
    if (warp == 0) {
        Agg w = lane < kT / 32 ? ws[lane] : Agg{0ull, -1};
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const Agg t = {__shfl_up_sync(kFull, w.c, o), __shfl_up_sync(kFull, w.h, o)};
            if (lane >= o) w = combine(t, w);
        }
        ws[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v = combine(ws[warp - 1], v);
    total = ws[kT / 32 - 1];
    __syncthreads();
    return v;
}

// order: the identity (real suffixes unsorted, pads at the tail); grp and
// the active list: every real suffix, grouped by its symbol; res[0] = n
__global__ void init_state(const int* __restrict__ data, int64_t size, int64_t n,
                           int* __restrict__ order, int* __restrict__ grp,
                           int* __restrict__ apos, int* __restrict__ agrp,
                           long long* __restrict__ res) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
         i += (int64_t)gridDim.x * blockDim.x) {
        order[i] = (int)i;
        if (i < n) {
            grp[i] = data[i];
            apos[i] = (int)i;
            agrp[i] = data[i];
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) res[0] = n;
}

// keys of the res[0] active suffixes, padded with kPadKey to a whole
// chunk; orand[0] |= every key, orand[1] &= every key
__global__ void build_keys(const int* __restrict__ apos, const int* __restrict__ agrp,
                           const int* __restrict__ order, const int* __restrict__ grp,
                           int64_t n, int64_t k, int b,
                           const long long* __restrict__ res,
                           uint64_t* __restrict__ keys, int* __restrict__ vals,
                           unsigned long long* __restrict__ orand) {
    const int64_t m = res[0];
    const int64_t mpad = (m + kChunk - 1) / kChunk * kChunk;
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < mpad;
         t += (int64_t)gridDim.x * blockDim.x) {
        if (t < m) {
            const int s = order[apos[t]];
            const int64_t p = s + k;
            const int r2 = p < n ? grp[p] : -1;
            const uint64_t key = ((uint64_t)(unsigned)agrp[t] << b) |
                                 (uint64_t)(unsigned)(r2 + 1);
            keys[t] = key;
            vals[t] = s;
            o |= key;
            a &= key;
        } else {
            keys[t] = kPadKey;
            vals[t] = 0;
        }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        o |= __shfl_xor_sync(kFull, o, s);
        a &= __shfl_xor_sync(kFull, a, s);
    }
    if ((threadIdx.x & 31) == 0) {
        atomicOr(&orand[0], o);
        atomicAnd(&orand[1], a);
    }
}

// counts[d * nchunks + c]: elements of chunk c whose digit is d
__global__ void __launch_bounds__(kThreads)
radix_hist(const uint64_t* __restrict__ keys, int64_t nchunks, int shift,
           int* __restrict__ counts) {
    __shared__ int cnt[kWarps][256];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = lane; j < 256; j += 32) cnt[warp][j] = 0;
    __syncwarp();
    const int64_t c = (int64_t)blockIdx.x * kWarps + warp;
    if (c >= nchunks) return;
    const uint64_t* kk = keys + c * kChunk;
#pragma unroll 4
    for (int it = 0; it < kChunk / 32; ++it) {
        const unsigned d = (unsigned)(kk[it * 32 + lane] >> shift) & 255u;
        const unsigned peers = __match_any_sync(kFull, d);
        if (lane == 31 - __clz(peers)) cnt[warp][d] += __popc(peers);
        __syncwarp();
    }
    for (int j = lane; j < 256; j += 32) counts[j * nchunks + c] = cnt[warp][j];
}

// In place: the exclusive scan of rows[blockIdx.x * n : + n]; the row's
// sum into totals[blockIdx.x] (when totals is not null)
__global__ void __launch_bounds__(kScanThreads)
scan_rows(int* __restrict__ rows, int64_t n, int* __restrict__ totals) {
    __shared__ int ws[32];
    int* row = rows + (int64_t)blockIdx.x * n;
    int carry = 0;
    for (int64_t base = 0; base < n; base += kScanThreads) {
        const int64_t i = base + threadIdx.x;
        const int v = i < n ? row[i] : 0;
        int total;
        const int incl = block_scan<kScanThreads>(v, ws, total);
        if (i < n) row[i] = carry + incl - v;
        carry += total;
    }
    if (totals != nullptr && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The stable scatter of one digit: element j of chunk c goes to
// start[d] + counts[d][c] + (elements of chunk c before j with digit d)
__global__ void __launch_bounds__(kThreads)
radix_scatter(const uint64_t* __restrict__ keys, const int* __restrict__ vals,
              int64_t nchunks, int shift, const int* __restrict__ counts,
              const int* __restrict__ totals, uint64_t* __restrict__ okeys,
              int* __restrict__ ovals) {
    __shared__ int ws[32];
    __shared__ int start[256];
    __shared__ int run[kWarps][256];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = totals[threadIdx.x];
    int total;
    start[threadIdx.x] = block_scan<kThreads>(t, ws, total) - t;
    __syncthreads();
    const int64_t c = (int64_t)blockIdx.x * kWarps + warp;
    if (c >= nchunks) return;
    for (int j = lane; j < 256; j += 32) run[warp][j] = start[j] + counts[j * nchunks + c];
    __syncwarp();
    const uint64_t* kk = keys + c * kChunk;
    const int* vv = vals + c * kChunk;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
    for (int it = 0; it < kChunk / 32; ++it) {
        const uint64_t key = kk[it * 32 + lane];
        const int v = vv[it * 32 + lane];
        const unsigned d = (unsigned)(key >> shift) & 255u;
        const unsigned peers = __match_any_sync(kFull, d);
        const int pos = run[warp][d] + __popc(peers & below);
        __syncwarp();
        if (lane == 31 - __clz(peers)) run[warp][d] += __popc(peers);
        __syncwarp();
        okeys[pos] = key;
        ovals[pos] = v;
    }
}

// Element j of the m sorted keys: does it start a group, does it stay
// active (its group has two or more suffixes)?
__device__ __forceinline__ void group_flags(const uint64_t* skeys, int64_t m, int64_t j,
                                            bool& start, bool& keep) {
    const uint64_t key = skeys[j];
    start = j == 0 || key != skeys[j - 1];
    const bool end = j == m - 1 || key != skeys[j + 1];
    keep = !(start && end);
}

__device__ __forceinline__ Agg element_agg(const uint64_t* skeys, const int* apos,
                                           int64_t m, int64_t j) {
    bool start, keep;
    group_flags(skeys, m, j, start, keep);
    return {keep ? 1ull | ((unsigned long long)start << 32) : 0ull,
            start ? apos[j] : -1};
}

// tile_c[t], tile_h[t]: the Agg of tile t's elements
__global__ void __launch_bounds__(kThreads)
relabel_count(const uint64_t* __restrict__ skeys, const int* __restrict__ apos,
              int64_t m, unsigned long long* __restrict__ tile_c,
              int* __restrict__ tile_h) {
    __shared__ Agg ws[32];
    const int64_t j0 = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
    Agg v = {0ull, -1};
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
        if (j0 + e < m) v = combine(v, element_agg(skeys, apos, m, j0 + e));
    Agg total;
    agg_scan<kThreads>(v, ws, total);
    if (threadIdx.x == 0) {
        tile_c[blockIdx.x] = total.c;
        tile_h[blockIdx.x] = total.h;
    }
}

// In place: the exclusive scan of the ntiles tile Aggs, one CTA; res[0]
// = the suffixes that stay active (the next round's count)
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(unsigned long long* __restrict__ tile_c, int* __restrict__ tile_h,
           int64_t ntiles, long long* __restrict__ res) {
    __shared__ Agg ws[32];
    __shared__ Agg excl[kScanThreads];
    Agg carry = {0ull, -1};
    for (int64_t base = 0; base < ntiles; base += kScanThreads) {
        const int64_t i = base + threadIdx.x;
        const Agg v = i < ntiles ? Agg{tile_c[i], tile_h[i]} : Agg{0ull, -1};
        Agg total;
        excl[threadIdx.x] = combine(carry, agg_scan<kScanThreads>(v, ws, total));
        __syncthreads();
        if (i < ntiles) {
            const Agg e = threadIdx.x > 0 ? excl[threadIdx.x - 1] : carry;
            tile_c[i] = e.c;
            tile_h[i] = e.h;
        }
        carry = combine(carry, total);
        __syncthreads();
    }
    if (threadIdx.x == 0) res[0] = (long long)(carry.c & 0xFFFFFFFFull);
}

// Each sorted suffix back into its slot of `order`, grp[s] = its group's
// start, and the next active list (position, dense group index)
__global__ void __launch_bounds__(kThreads)
relabel_apply(const uint64_t* __restrict__ skeys, const int* __restrict__ svals,
              const int* __restrict__ apos, int64_t m,
              const unsigned long long* __restrict__ tile_c,
              const int* __restrict__ tile_h, int* __restrict__ order,
              int* __restrict__ grp, int* __restrict__ apos_next,
              int* __restrict__ agrp_next) {
    __shared__ Agg ws[32];
    const int64_t j0 = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
    Agg v = {0ull, -1};
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
        if (j0 + e < m) v = combine(v, element_agg(skeys, apos, m, j0 + e));
    Agg total;
    const Agg incl = agg_scan<kThreads>(v, ws, total);
    // everything before this thread's first element: the tile's prefix,
    // then the threads before it (the inclusive scan less this thread's
    // counts; for the last start, the thread before's inclusive max)
    __shared__ int hprev[kThreads];
    hprev[threadIdx.x] = incl.h;
    __syncthreads();
    Agg run = {tile_c[blockIdx.x] + incl.c - v.c, tile_h[blockIdx.x]};
    if (threadIdx.x > 0 && hprev[threadIdx.x - 1] > run.h) run.h = hprev[threadIdx.x - 1];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int64_t j = j0 + e;
        if (j >= m) break;
        bool start, keep;
        group_flags(skeys, m, j, start, keep);
        const int pos = apos[j];
        if (start) run.h = pos;          // positions increase along j
        const unsigned long long add =
            keep ? 1ull | ((unsigned long long)start << 32) : 0ull;
        const int s = svals[j];
        order[pos] = s;
        grp[s] = run.h;
        if (keep) {
            const int c = (int)(run.c & 0xFFFFFFFFull);
            apos_next[c] = pos;
            agrp_next[c] = (int)((run.c + add) >> 32) - 1;
        }
        run.c += add;
    }
}

struct Layout {
    int64_t grp, apos, agrp, keys, vals, counts, totals, tile_c, tile_h, res, bytes;
};

Layout layout(int64_t size) {
    auto up = [](int64_t x) { return (x + 255) & ~(int64_t)255; };
    Layout l;
    const int64_t nchunks = (size + kChunk - 1) / kChunk;
    const int64_t ntiles = (size + kTile - 1) / kTile;
    l.grp = 0;
    l.apos = up(l.grp + size * 4);                  // 2 x size int
    l.agrp = up(l.apos + 2 * size * 4);             // 2 x size int
    l.keys = up(l.agrp + 2 * size * 4);             // 2 x size u64
    l.vals = up(l.keys + 2 * size * 8);             // 2 x size int
    l.counts = up(l.vals + 2 * size * 4);           // 256 x nchunks int
    l.totals = up(l.counts + 256 * nchunks * 4);    // 256 int
    l.tile_c = up(l.totals + 256 * 4);              // ntiles u64
    l.tile_h = up(l.tile_c + ntiles * 8);           // ntiles int
    l.res = up(l.tile_h + ntiles * 4);              // active count, OR, AND
    l.bytes = up(l.res + 3 * 8);
    return l;
}

// the active count of each round of the last call, for the measurements
int64_t g_active[64];
int64_t g_nactive = 0;

int grid_for(int64_t n, int threads) {
    const int64_t g = (n + threads - 1) / threads;
    return (int)(g < 4096 ? (g < 1 ? 1 : g) : 4096);
}

}  // namespace

extern "C" {

// bytes of scratch kz_prefix_double needs at this size
int64_t kz_prefix_double_scratch(int64_t size) { return layout(size).bytes; }

// the suffixes each round of the last kz_prefix_double call sorted, into
// out[: cap]; returns the number of rounds recorded (at most 64)
int64_t kz_prefix_double_active(void* out, int64_t cap) {
    const int64_t n = g_nactive < cap ? g_nactive : cap;
    for (int64_t i = 0; i < n; ++i) ((int64_t*)out)[i] = g_active[i];
    return n;
}

// data (size,) int32 symbols below n, size a multiple of 1024 -> order
// (size,) int32, the suffix order with the entries >= n at the tail;
// *rounds (host memory) = doubling rounds taken. Synchronises `stream`
// once a round.
int kz_prefix_double(const void* data, int64_t size, int64_t n, void* order,
                     void* rounds, void* scratch, int64_t scratch_bytes,
                     void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Layout l = layout(size);
    if (size <= 0 || size % kChunk || n < 0 || n > size || scratch_bytes < l.bytes)
        return (int)cudaErrorInvalidValue;
    char* s = (char*)scratch;
    int* ord = (int*)order;
    int* grp = (int*)(s + l.grp);
    int* apos[2] = {(int*)(s + l.apos), (int*)(s + l.apos) + size};
    int* agrp[2] = {(int*)(s + l.agrp), (int*)(s + l.agrp) + size};
    uint64_t* keys[2] = {(uint64_t*)(s + l.keys), (uint64_t*)(s + l.keys) + size};
    int* vals[2] = {(int*)(s + l.vals), (int*)(s + l.vals) + size};
    int* counts = (int*)(s + l.counts);
    int* totals = (int*)(s + l.totals);
    unsigned long long* tile_c = (unsigned long long*)(s + l.tile_c);
    int* tile_h = (int*)(s + l.tile_h);
    long long* res = (long long*)(s + l.res);
    unsigned long long* orand = (unsigned long long*)(res + 1);
    // the later rounds' r2 + 1 is a group start + 1, at most n
    const int b = n > 0 ? 64 - __builtin_clzll((unsigned long long)n) : 1;
    const int g = grid_for(size, kThreads);
    cudaError_t rc;

    init_state<<<g, kThreads, 0, st>>>((const int*)data, size, n, ord, grp, apos[0],
                                       agrp[0], res);
    int cur = 0;                 // the active list of this round
    int64_t k = 1, nrounds = 0;
    g_nactive = 0;
    long long host[3];
    while (true) {
        if (k < size) {
            cudaMemsetAsync(orand, 0, 8, st);
            cudaMemsetAsync(orand + 1, 0xFF, 8, st);
            // the first round's groups and ranks are the symbols: r2 + 1 <= 256
            build_keys<<<g, kThreads, 0, st>>>(apos[cur], agrp[cur], ord, grp, n, k,
                                                nrounds == 0 ? 9 : b, res, keys[0],
                                                vals[0], orand);
        }
        // this round's active count, its keys' OR and AND
        cudaMemcpyAsync(host, res, sizeof(host), cudaMemcpyDeviceToHost, st);
        rc = cudaStreamSynchronize(st);
        if (rc != cudaSuccess) return (int)rc;
        const int64_t m = host[0];
        if (nrounds > 0 && (m == 0 || k >= size)) break;
        if (g_nactive < 64) g_active[g_nactive++] = m;
        if (m > 0) {
            const int64_t nchunks = (m + kChunk - 1) / kChunk;
            const unsigned gchunks = (unsigned)((nchunks + kWarps - 1) / kWarps);
            const uint64_t varying = (uint64_t)host[1] ^ (uint64_t)host[2];
            int src = 0;
            for (int shift = 0; shift < 64; shift += 8) {
                if (((varying >> shift) & 255u) == 0) continue;
                radix_hist<<<gchunks, kThreads, 0, st>>>(keys[src], nchunks, shift, counts);
                scan_rows<<<256, kScanThreads, 0, st>>>(counts, nchunks, totals);
                radix_scatter<<<gchunks, kThreads, 0, st>>>(
                    keys[src], vals[src], nchunks, shift, counts, totals, keys[src ^ 1],
                    vals[src ^ 1]);
                src ^= 1;
            }
            const unsigned ntiles = (unsigned)((m + kTile - 1) / kTile);
            relabel_count<<<ntiles, kThreads, 0, st>>>(keys[src], apos[cur], m, tile_c,
                                                       tile_h);
            scan_tiles<<<1, kScanThreads, 0, st>>>(tile_c, tile_h, ntiles, res);
            relabel_apply<<<ntiles, kThreads, 0, st>>>(keys[src], vals[src], apos[cur], m,
                                                       tile_c, tile_h, ord, grp,
                                                       apos[cur ^ 1], agrp[cur ^ 1]);
            rc = cudaGetLastError();
            if (rc != cudaSuccess) return (int)rc;
            cur ^= 1;
        }
        ++nrounds;
        k *= 2;
    }
    *(int64_t*)rounds = nrounds;
    return (int)cudaGetLastError();
}

}  // extern "C"
