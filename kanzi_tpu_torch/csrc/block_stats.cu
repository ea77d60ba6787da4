// Per-block statistics for the incompressibility gate: order-0 histograms
// (K1) and first-order entropy x1024 (K2).
//
// K1 kz_histograms_u8 replaces the Pallas kernel
//   kanzi_tpu/ops/pallas_kernels.py: _histogram_kernel / histograms_pallas
// (and its XLA scatter-add twin kanzi_tpu/ops/histogram.py: histograms_u8).
// Bound: bytes. It reads every input byte once and writes 1 KiB per row; the
// counting itself is one shared-memory atomic per byte. Design: the grid is
// (row slice, row), so a 4 MiB row spreads over many SMs; each warp counts
// into its own 256-bin sub-histogram in shared memory (fewer atomic
// collisions than one CTA-wide table), loads are 16 bytes per thread where
// the slice is 16-byte aligned, and the CTA reduces its sub-histograms
// before one global atomicAdd per bin into the (B, 256) int32 output, which
// the caller zeroes. Any row length N is accepted.
//
// K2 kz_entropy1024 replaces the Pallas kernel
//   kanzi_tpu/ops/pallas_kernels.py: _entropy_kernel / entropy1024_pallas
// (and kanzi_tpu/ops/histogram.py: entropy1024).
// Bound: bytes (1 KiB of histogram per row in, 4 bytes out; 256 log2f per
// row). One CTA of 256 threads per row, thread i owns bin i, a float32
// block reduction of h*log2f(h/n); the result is truncated toward zero like
// astype(int32). Built without --use_fast_math: __log2f would move values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int64_t kSliceBytes = 64 * 1024;  // bytes of one row per CTA

__device__ __forceinline__ void count_word(unsigned int* h, uint32_t w) {
    atomicAdd(&h[w & 0xFF], 1u);
    atomicAdd(&h[(w >> 8) & 0xFF], 1u);
    atomicAdd(&h[(w >> 16) & 0xFF], 1u);
    atomicAdd(&h[w >> 24], 1u);
}

__global__ void histograms_u8_kernel(const uint8_t* __restrict__ blocks,
                                     int64_t n, int* __restrict__ out) {
    __shared__ unsigned int sub[kHistWarps][256];
    const int tid = threadIdx.x;
    for (int i = tid; i < kHistWarps * 256; i += kHistThreads)
        (&sub[0][0])[i] = 0;
    __syncthreads();

    unsigned int* h = sub[tid >> 5];
    const uint8_t* row = blocks + (int64_t)blockIdx.y * n;
    const int64_t start = (int64_t)blockIdx.x * kSliceBytes;
    const int64_t end = min(n, start + kSliceBytes);
    // 16-byte aligned body [a0, a1); scalar head and tail
    const uintptr_t base = reinterpret_cast<uintptr_t>(row);
    int64_t a0 = (int64_t)(((base + start + 15) & ~(uintptr_t)15) - base);
    int64_t a1 = (int64_t)(((base + end) & ~(uintptr_t)15) - base);
    if (a0 > end) a0 = end;
    if (a1 < a0) a1 = a0;
    for (int64_t i = start + tid; i < a0; i += kHistThreads)
        atomicAdd(&h[row[i]], 1u);
    const uint4* body = reinterpret_cast<const uint4*>(row + a0);
    const int64_t nvec = (a1 - a0) >> 4;
    for (int64_t v = tid; v < nvec; v += kHistThreads) {
        uint4 q = body[v];
        count_word(h, q.x);
        count_word(h, q.y);
        count_word(h, q.z);
        count_word(h, q.w);
    }
    for (int64_t i = a1 + tid; i < end; i += kHistThreads)
        atomicAdd(&h[row[i]], 1u);
    __syncthreads();

    unsigned int total = 0;
    for (int w = 0; w < kHistWarps; ++w) total += sub[w][tid];
    if (total) atomicAdd(&out[(int64_t)blockIdx.y * 256 + tid], (int)total);
}

__global__ void entropy1024_kernel(const int* __restrict__ histos,
                                   const int* __restrict__ lengths,
                                   int* __restrict__ out) {
    __shared__ float partial[8];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const float n = fmaxf((float)lengths[b], 1.0f);
    const float h = (float)histos[(int64_t)b * 256 + tid];
    float term = h > 0.0f ? h * log2f(h / n) : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
        term += __shfl_down_sync(0xffffffffu, term, off);
    if ((tid & 31) == 0) partial[tid >> 5] = term;
    __syncthreads();
    if (tid == 0) {
        float s = 0.0f;
        for (int w = 0; w < 8; ++w) s += partial[w];
        const float bits = -s;
        out[b] = (int)(128.0f * bits / n);
    }
}

}  // namespace

extern "C" {

// blocks (B, n) uint8 contiguous; out (B, 256) int32, zeroed by the caller.
int kz_histograms_u8(const void* blocks, int64_t B, int64_t n, void* out,
                     void* stream) {
    if (B > 0 && n > 0) {
        dim3 grid((unsigned)((n + kSliceBytes - 1) / kSliceBytes), (unsigned)B);
        histograms_u8_kernel<<<grid, kHistThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)blocks, n, (int*)out);
    }
    return (int)cudaGetLastError();
}

// histos (B, 256) int32, lengths (B,) int32 -> out (B,) int32.
int kz_entropy1024(const void* histos, const void* lengths, int64_t B,
                   void* out, void* stream) {
    if (B > 0)
        entropy1024_kernel<<<(unsigned)B, 256, 0, (cudaStream_t)stream>>>(
            (const int*)histos, (const int*)lengths, (int*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
