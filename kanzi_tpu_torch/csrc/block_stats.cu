// Per-block statistics for the incompressibility gate: order-0 histograms
// (K1) and first-order entropy x1024 (K2), fused into one launch.
//
// kz_block_stats replaces the Pallas program
//   kanzi_tpu/ops/pallas_kernels.py: block_stats_pallas
// (histograms_pallas then entropy1024_pallas, jitted as one program);
// kz_histograms_u8 is the same kernel with the entropy tail compiled out
// (kanzi_tpu/ops/pallas_kernels.py: _histogram_kernel / histograms_pallas,
// and the XLA kanzi_tpu/ops/histogram.py: histograms_u8).
// Bound: bytes. It reads every input byte once and writes 1 KiB and 4 bytes
// a row. Design:
// - A row is one thread-block cluster of c CTAs, one CTA an SM. Each CTA
//   counts a contiguous share of the row's 16-byte-aligned body; rank 0
//   also takes the unaligned head, the last rank the tail (each under 16
//   bytes). c is the card's to decide: an H100 holds only 15 clusters of 8
//   (or 7) of these CTAs at once, so 16 rows in clusters of 8 would run in
//   two waves; pick_cluster takes the c <= 8 whose waves of resident
//   clusters finish first (c = 6 for 16 rows of 4 MiB: 17 fit, one wave
//   on 96 SMs).
// - Counting has no conflicts whatever the bytes are: every lane owns a u32
//   counter per bin at byte offset pair<<16 | bin<<8 | (warp&1)<<7 | lane<<2
//   (one 64 KiB table a warp pair), so lane l's counters all sit in bank l.
//   The offset is one byte permute (PRMT) of the input word and a per-lane
//   constant, and the update one shared atomic with no return (no
//   load-add-store chain), so a byte costs two instructions; the shared
//   atomics' rate, about 12 bytes a cycle an SM, then sets the time. A
//   counter never overflows: a row holds fewer than 2^31 bytes (the output
//   is int32), and the wrapper refuses longer ones.
// - Bytes in flight: each thread keeps kUnroll 16-byte loads of the next
//   group in flight while it counts the current one, and thread 0 asks the
//   TMA unit to prefetch kPrefetch groups further ahead into L2
//   (cp.async.bulk.prefetch), so the loads mostly wait on L2, not HBM.
// - No global scratch and no memset: each CTA reduces its counters into
//   256 u32 in its shared memory; after cluster.sync() rank 0 sums the
//   cluster's tables over distributed shared memory, writes the histogram
//   row and runs K2's body on it; every CTA syncs the cluster once more
//   before it exits, so no table is read after its CTA is gone. Two calls
//   in flight on two streams share nothing.
//
// kz_entropy1024 replaces the Pallas kernel
//   kanzi_tpu/ops/pallas_kernels.py: _entropy_kernel / entropy1024_pallas
// (and kanzi_tpu/ops/histogram.py: entropy1024) for histograms the caller
// gives: one warp a row runs entropy1024_warp, the body the fused kernel
// runs, so both give the same bits on the same histogram. float32
// h*log2f(h/n) summed in a fixed order with rounded operations (no FMA
// contraction), the result truncated toward zero like astype(int32). Built
// without --use_fast_math: __log2f would move values.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;                 // CTAs a row at most: one cluster
constexpr int kPairs = 3;                      // warp pairs a CTA
constexpr int kWarps = 2 * kPairs;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;                     // 16-byte loads a thread a group
constexpr int kPrefetch = 2;                   // groups prefetched into L2 ahead
constexpr int kPairBytes = 256 * 64 * 4;       // 256 bins x 64 lanes x u32
constexpr int kSmem = kPairs * kPairBytes;
constexpr int64_t kGroup = (int64_t)kUnroll * kThreads;   // vectors a group

// One warp's K2 body: lane l holds bins l, l + 32, ..., l + 224. The
// terms are summed in that order, then across lanes by shuffles; lane 0's
// value is the row's entropy x1024.
__device__ __forceinline__ int entropy1024_warp(const int (&h)[8], float len) {
    const float n = fmaxf(len, 1.0f);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float x = (float)h[i];
        if (x > 0.0f) s = __fadd_rn(s, __fmul_rn(x, log2f(__fdiv_rn(x, n))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    return (int)__fdiv_rn(__fmul_rn(128.0f, -s), n);
}

__device__ __forceinline__ void count_word(unsigned char* cnt, uint32_t w,
                                           uint32_t lb) {
    // offset = lb's pair (byte 2) | byte k of w (byte 1) | lb's lane (byte 0)
    atomicAdd(reinterpret_cast<unsigned*>(cnt + __byte_perm(w, lb, 0x7604)), 1u);
    atomicAdd(reinterpret_cast<unsigned*>(cnt + __byte_perm(w, lb, 0x7614)), 1u);
    atomicAdd(reinterpret_cast<unsigned*>(cnt + __byte_perm(w, lb, 0x7624)), 1u);
    atomicAdd(reinterpret_cast<unsigned*>(cnt + __byte_perm(w, lb, 0x7634)), 1u);
}

__device__ __forceinline__ void count_vec(unsigned char* cnt, const uint4& q,
                                          uint32_t lb) {
    count_word(cnt, q.x, lb);
    count_word(cnt, q.y, lb);
    count_word(cnt, q.z, lb);
    count_word(cnt, q.w, lb);
}

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(p), "r"(bytes) : "memory");
}

// grid (c, B), clusters (c, 1, 1): a cluster of c CTAs a row; kSmem
// bytes of dynamic shared memory
template <bool kEntropy>
__global__ void __launch_bounds__(kThreads, 1)
block_stats_kernel(const uint8_t* __restrict__ blocks, int64_t n,
                   int* __restrict__ hist, int* __restrict__ ent) {
    extern __shared__ __align__(16) unsigned char cnt[];
    __shared__ unsigned tot[256];
    __shared__ int row_hist[256];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int c = (int)gridDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const uint32_t lb = ((uint32_t)(warp >> 1) << 16) | ((uint32_t)(warp & 1) << 7)
                        | ((uint32_t)lane << 2);

    uint4* c4 = reinterpret_cast<uint4*>(cnt);
    for (int i = tid; i < kSmem / 16; i += kThreads) c4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const int64_t b = blockIdx.y;
    const uint8_t* row = blocks + b * n;
    const int64_t head = min((int64_t)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15), n);
    const int64_t nv = (n - head) >> 4;
    const int64_t tail = head + 16 * nv;
    if (rank == 0 && tid < head)
        atomicAdd(reinterpret_cast<unsigned*>(cnt + lb + ((uint32_t)row[tid] << 8)), 1u);
    if (rank == c - 1 && tail + tid < n)
        atomicAdd(reinterpret_cast<unsigned*>(cnt + lb + ((uint32_t)row[tail + tid] << 8)), 1u);

    // this CTA's vectors [v0, v1) of the body; thread t counts vectors
    // t, t + kThreads, ... of it, kUnroll of them a group
    const int64_t v0 = nv * rank / c;
    const int64_t m = nv * (rank + 1) / c - v0;
    const uint4* p = reinterpret_cast<const uint4*>(row + head) + v0;
    const int64_t ng = m / kGroup;
    if (kPrefetch > 0 && tid == 0)
        for (int64_t g = 1; g <= kPrefetch && g < ng; ++g)
            prefetch_l2(p + g * kGroup, (uint32_t)(kGroup * 16));
    uint4 nxt[kUnroll];
    if (ng > 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) nxt[u] = __ldcs(p + u * kThreads + tid);
    }
    for (int64_t g = 0; g < ng; ++g) {
        uint4 cur[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
        if (g + 1 < ng) {
            const uint4* q = p + (g + 1) * kGroup + tid;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) nxt[u] = __ldcs(q + u * kThreads);
        }
        if (kPrefetch > 0 && tid == 0 && g + 1 + kPrefetch < ng)
            prefetch_l2(p + (g + 1 + kPrefetch) * kGroup, (uint32_t)(kGroup * 16));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) count_vec(cnt, cur[u], lb);
    }
    for (int64_t v = ng * kGroup + tid; v < m; v += kThreads) count_vec(cnt, __ldcs(p + v), lb);
    __syncthreads();

    // the CTA's table: warp w sums bins w, w + kWarps, ..., four at a time;
    // lane l reads counter words 2l and 2l + 1 of each pair's row of a bin
    for (int bin = warp; bin < 256; bin += 4 * kWarps) {
        unsigned s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s[j] = 0;
            if (bin + j * kWarps < 256) {
#pragma unroll
                for (int pr = 0; pr < kPairs; ++pr) {
                    const uint2 v = *reinterpret_cast<const uint2*>(
                        cnt + pr * kPairBytes + (bin + j * kWarps) * 256 + lane * 8);
                    s[j] += v.x + v.y;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s[j] = __reduce_add_sync(0xffffffffu, s[j]);
            if (lane == 0 && bin + j * kWarps < 256) tot[bin + j * kWarps] = s[j];
        }
    }
    cluster.sync();
    if (rank == 0) {
        for (int i = tid; i < 256; i += kThreads) {
            unsigned s = 0;
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r)
                if (r < c) s += cluster.map_shared_rank(&tot[0], r)[i];
            hist[b * 256 + i] = (int)s;
            if (kEntropy) row_hist[i] = (int)s;
        }
    }
    cluster.sync();   // rank 0 has read every table: the CTAs may exit
    if (kEntropy && rank == 0 && warp == 0) {
        int h[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = row_hist[lane + 32 * i];
        const int e = entropy1024_warp(h, (float)n);
        if (lane == 0) ent[b] = e;
    }
}

__global__ void entropy1024_kernel(const int* __restrict__ histos,
                                   const int* __restrict__ lengths,
                                   int* __restrict__ out) {
    const int64_t b = blockIdx.x;
    const int lane = threadIdx.x;
    int h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = histos[b * 256 + lane + 32 * i];
    const int e = entropy1024_warp(h, (float)lengths[b]);
    if (lane == 0) out[b] = e;
}

__global__ void empty_kernel() {}

cudaLaunchConfig_t cluster_config(int c, int64_t B, void* stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)c, (unsigned)B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = (cudaStream_t)stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)c;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// How many clusters of c CTAs the card holds at once (negative: a CUDA
// error), queried once a device and kept: it is the card's and the
// kernel's, not a call's.
int64_t resident_clusters(int c) {
    constexpr int kDevices = 64;
    static int64_t known[kDevices][kMaxCluster + 1] = {};
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return -(int64_t)rc;
    if (dev < kDevices && known[dev][c] > 0) return known[dev][c];
    for (void* k : {(void*)block_stats_kernel<true>, (void*)block_stats_kernel<false>}) {
        rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
        if (rc != cudaSuccess) return -(int64_t)rc;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(c, 1, nullptr, &attr);
    int clusters = 0;
    rc = cudaOccupancyMaxActiveClusters(&clusters, block_stats_kernel<true>, &cfg);
    if (rc != cudaSuccess) return -(int64_t)rc;
    if (dev < kDevices && clusters > 0) known[dev][c] = clusters;
    return clusters;
}

// The cluster size for B rows of n bytes: the c <= kMaxCluster whose
// waves of resident clusters, ceil(B / resident(c)), cost least, a wave
// costing kWaveBytes (a CTA's fixed work: zeroing and reducing its
// counters, the cluster's syncs) plus a CTA's ceil(n / c) bytes; ties go
// to the larger c. On an H100 15 clusters of 8 fit at once, so 16 rows of
// 4 MiB take clusters of 6, one wave, not two of 8; many short rows take
// small clusters.
constexpr int64_t kWaveBytes = 96 * 1024;

int pick_cluster(int64_t B, int64_t n, int* c_out) {
    int best = 0;
    int64_t best_cost = 0;
    for (int c = kMaxCluster; c >= 1; --c) {
        const int64_t r = resident_clusters(c);
        if (r < 0) return (int)-r;
        if (r == 0) continue;
        const int64_t cost = (B + r - 1) / r * (kWaveBytes + (n + c - 1) / c);
        if (best == 0 || cost < best_cost) {
            best = c;
            best_cost = cost;
        }
    }
    if (best == 0) return (int)cudaErrorInvalidConfiguration;
    *c_out = best;
    return 0;
}

template <bool kEntropy>
int launch_block_stats(const void* blocks, int64_t B, int64_t n, void* hist,
                       void* ent, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    int c = 0;
    const int rc0 = pick_cluster(B, n, &c);
    if (rc0 != 0) return rc0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(c, B, stream, &attr);
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, block_stats_kernel<kEntropy>,
                                              (const uint8_t*)blocks, n, (int*)hist,
                                              (int*)ent);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks (B, n) uint8 contiguous, rows at any alignment, n < 2^31 ->
// hist (B, 256) int32 and ent (B,) int32, both written whole (no zeroing
// by the caller). One launch.
int kz_block_stats(const void* blocks, int64_t B, int64_t n, void* hist,
                   void* ent, void* stream) {
    return launch_block_stats<true>(blocks, B, n, hist, ent, stream);
}

// the same kernel without the entropy tail: hist (B, 256) int32
int kz_histograms_u8(const void* blocks, int64_t B, int64_t n, void* hist,
                     void* stream) {
    return launch_block_stats<false>(blocks, B, n, hist, nullptr, stream);
}

// histos (B, 256) int32, lengths (B,) int32 -> out (B,) int32.
int kz_entropy1024(const void* histos, const void* lengths, int64_t B,
                   void* out, void* stream) {
    if (B > 0)
        entropy1024_kernel<<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
            (const int*)histos, (const int*)lengths, (int*)out);
    return (int)cudaGetLastError();
}

// The cluster size kz_block_stats takes for B rows of n bytes (a negative
// CUDA error code on failure), and through clusters_out the clusters of
// each size 1..8 the card holds at once. No launch.
int64_t kz_block_stats_cluster(int64_t B, int64_t n, int64_t* clusters_out) {
    for (int c = 1; c <= kMaxCluster; ++c) {
        clusters_out[c - 1] = resident_clusters(c);
        if (clusters_out[c - 1] < 0) return clusters_out[c - 1];
    }
    int c = 0;
    const int rc = pick_cluster(B, n, &c);
    return rc == 0 ? (int64_t)c : -(int64_t)rc;
}

// One empty kernel on the stream: the floor of any one-launch call.
int kz_empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
