// Suffix order by Manber-Myers prefix doubling (K9).
//
// kz_prefix_double replaces kanzi_tpu/ops/suffix_sort.py: _prefix_double,
// an XLA while_loop whose every round sorts (rank[i], rank[i + k]) with a
// stable lexsort, relabels the suffixes with dense ranks and doubles k
// until every rank is distinct.
//
// Bound: bytes. A round moves a few dozen bytes per suffix (the key and
// index through each radix pass, the relabel's reads and scatter); the
// arithmetic is a shift and a compare per element. The rounds are serial:
// 3-5 for mixed data, about log2(n) for a periodic block.
//
// Design, simple and exact first:
// - one host loop of rounds inside this call, each a few launches on the
//   caller's stream:
//   1. keys: key = rank[i] << b | (r2 + 1) as u64, r2 = rank[i + k] or -1
//      at or past n_true (so -1 sorts below every rank), with b the bits
//      that size + 256 needs (the first round's pad ranks are 256 + i);
//      the same pass reduces the OR and the AND of all keys;
//   2. a stable LSD radix sort of (key, index), 8-bit digits, written
//      here: a per-warp digit histogram of each 1024-element chunk, an
//      exclusive scan of the counts in (digit, chunk) order, and a scatter
//      in which each warp ranks its chunk's elements 32 at a time
//      (__match_any_sync: the rank among equal digits is the count of
//      lower lanes). A digit in which no key bit varies (the OR and AND
//      agree there) is skipped: such a pass would leave the order as is;
//   3. relabel: flag each sorted key that differs from the one before,
//      scan the flags (tile counts, one CTA scanning the tile counts, then
//      each tile's scan), scatter new_rank[order[j]] = flag scan - 1, and
//      keep the last one: the ranks are dense, so it is the largest.
// - the loop reads the largest rank and the next round's OR and AND back
//   in one synchronisation a round (the next round's keys are built before
//   the read, into the other buffer, and are dropped when the loop ends).
// The sort keeps every element's index, so the last round's sorted
// indices are the order; once all ranks differ, the order is unique.

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

__global__ void init_rank(const int* __restrict__ data, int64_t size, int64_t n,
                          int* __restrict__ rank) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
         i += (int64_t)gridDim.x * blockDim.x)
        rank[i] = i < n ? data[i] : (int)(256 + i);
}

// orand[0] |= every key, orand[1] &= every key
__global__ void build_keys(const int* __restrict__ rank, int64_t size, int64_t n,
                           int64_t k, int b, uint64_t* __restrict__ keys,
                           int* __restrict__ vals,
                           unsigned long long* __restrict__ orand) {
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int64_t p = i + k;
        const int r2 = p < n ? rank[p] : -1;
        const uint64_t key = ((uint64_t)(unsigned)rank[i] << b) | (uint64_t)(unsigned)(r2 + 1);
        keys[i] = key;
        vals[i] = (int)i;
        o |= key;
        a &= key;
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

__device__ __forceinline__ int new_group(const uint64_t* skeys, int64_t j) {
    return j == 0 || skeys[j] != skeys[j - 1];
}

// tile_sums[t]: the flags of tile t
__global__ void __launch_bounds__(kThreads)
relabel_count(const uint64_t* __restrict__ skeys, int64_t size,
              int* __restrict__ tile_sums) {
    __shared__ int ws[32];
    const int64_t j0 = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
        if (j0 + e < size) cnt += new_group(skeys, j0 + e);
    int total;
    block_scan<kThreads>(cnt, ws, total);
    if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// rank[order[j]] = (flags up to j) - 1; res[0] = the last one, the largest
__global__ void __launch_bounds__(kThreads)
relabel_apply(const uint64_t* __restrict__ skeys, const int* __restrict__ svals,
              int64_t size, const int* __restrict__ tile_off, int* __restrict__ rank,
              long long* __restrict__ res) {
    __shared__ int ws[32];
    const int64_t j0 = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
    int f[kPerThread];
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        f[e] = j0 + e < size ? new_group(skeys, j0 + e) : 0;
        cnt += f[e];
    }
    int total;
    int r = tile_off[blockIdx.x] + block_scan<kThreads>(cnt, ws, total) - cnt - 1;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int64_t j = j0 + e;
        if (j < size) {
            r += f[e];
            rank[svals[j]] = r;
            if (j == size - 1) res[0] = r;
        }
    }
}

struct Layout {
    int64_t rank, keys, vals, counts, totals, tiles, res, bytes;
};

Layout layout(int64_t size) {
    auto up = [](int64_t x) { return (x + 255) & ~(int64_t)255; };
    Layout l;
    const int64_t nchunks = (size + kChunk - 1) / kChunk;
    const int64_t ntiles = (size + kTile - 1) / kTile;
    l.rank = 0;
    l.keys = up(l.rank + size * 4);                 // 2 x size u64
    l.vals = up(l.keys + 2 * size * 8);             // 2 x size int
    l.counts = up(l.vals + 2 * size * 4);           // 256 x nchunks int
    l.totals = up(l.counts + 256 * nchunks * 4);    // 256 int
    l.tiles = up(l.totals + 256 * 4);               // ntiles int
    l.res = up(l.tiles + ntiles * 4);               // max rank, OR, AND
    l.bytes = up(l.res + 3 * 8);
    return l;
}

int grid_for(int64_t n, int threads) {
    const int64_t g = (n + threads - 1) / threads;
    return (int)(g < 4096 ? (g < 1 ? 1 : g) : 4096);
}

}  // namespace

extern "C" {

// bytes of scratch kz_prefix_double needs at this size
int64_t kz_prefix_double_scratch(int64_t size) { return layout(size).bytes; }

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
    int* rank = (int*)(s + l.rank);
    uint64_t* keys[2] = {(uint64_t*)(s + l.keys), (uint64_t*)(s + l.keys) + size};
    int* vals[2] = {(int*)(s + l.vals), (int*)(s + l.vals) + size};
    int* counts = (int*)(s + l.counts);
    int* totals = (int*)(s + l.totals);
    int* tiles = (int*)(s + l.tiles);
    long long* res = (long long*)(s + l.res);
    unsigned long long* orand = (unsigned long long*)(res + 1);
    const int64_t nchunks = size / kChunk;
    const int64_t ntiles = (size + kTile - 1) / kTile;
    const int b = 64 - __builtin_clzll((unsigned long long)(size + 256));
    const int ndigits = (2 * b + 7) / 8;
    const int g = grid_for(size, kThreads);
    const unsigned gchunks = (unsigned)((nchunks + kWarps - 1) / kWarps);
    cudaError_t rc;

    init_rank<<<g, kThreads, 0, st>>>((const int*)data, size, n, rank);
    int cur = 0;                 // the buffer that holds this round's keys
    int64_t k = 1, nrounds = 0;
    long long host[3];
    while (true) {
        if (k < size) {
            cudaMemsetAsync(orand, 0, 8, st);
            cudaMemsetAsync(orand + 1, 0xFF, 8, st);
            build_keys<<<g, kThreads, 0, st>>>(rank, size, n, k, b, keys[cur],
                                                vals[cur], orand);
        }
        // the largest rank of the round before, this round's OR and AND
        cudaMemcpyAsync(host, res, sizeof(host), cudaMemcpyDeviceToHost, st);
        rc = cudaStreamSynchronize(st);
        if (rc != cudaSuccess) return (int)rc;
        if (nrounds > 0 && !(k < size && host[0] < size - 1)) break;
        const uint64_t varying = (uint64_t)host[1] ^ (uint64_t)host[2];
        int src = cur;
        for (int dg = 0; dg < ndigits; ++dg) {
            const int shift = 8 * dg;
            if (((varying >> shift) & 255u) == 0) continue;
            radix_hist<<<gchunks, kThreads, 0, st>>>(keys[src], nchunks, shift, counts);
            scan_rows<<<256, kScanThreads, 0, st>>>(counts, nchunks, totals);
            radix_scatter<<<gchunks, kThreads, 0, st>>>(
                keys[src], vals[src], nchunks, shift, counts, totals, keys[src ^ 1],
                vals[src ^ 1]);
            src ^= 1;
        }
        relabel_count<<<(unsigned)ntiles, kThreads, 0, st>>>(keys[src], size, tiles);
        scan_rows<<<1, kScanThreads, 0, st>>>(tiles, ntiles, nullptr);
        relabel_apply<<<(unsigned)ntiles, kThreads, 0, st>>>(keys[src], vals[src], size,
                                                             tiles, rank, res);
        rc = cudaGetLastError();
        if (rc != cudaSuccess) return (int)rc;
        ++nrounds;
        k *= 2;
        cur = src ^ 1;           // the next keys leave this round's order intact
    }
    cudaMemcpyAsync(order, vals[cur ^ 1], size * 4, cudaMemcpyDeviceToDevice, st);
    *(int64_t*)rounds = nrounds;
    return (int)cudaGetLastError();
}

}  // extern "C"
