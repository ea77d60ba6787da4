// BWT inverse by a batched LF-mapping walk (K10).
//
// kz_lf_walk replaces kanzi_tpu/ops/bwt_inverse.py: lf_walk, an XLA scan
// whose every step gathers B cursors' bytes from the last columns and
// their next positions from the LF mapping.
//
// Bound: on the roofline, bytes (a byte and an LF entry read a step, a
// byte written). On the card, latency: every step of a row needs the
// position the step before loaded, so a row is one chain of dependent
// loads, and 16 rows of 4 MiB hold 256 MiB of table, far past the 50 MB
// L2: most steps wait on device memory.
//
// Design, simple and exact first:
// - a first launch packs each row's two tables into one, lf << 8 | byte,
//   as u32 while N <= 2^24 and as u64 above, so a step is one dependent
//   load; it also flags each row that holds an LF entry outside [0, N)
//   (bad[row] = 1; the walk skips such a row and the wrapper raises);
// - the walk runs one thread per row, each in a CTA of its own so that the
//   rows spread over the SMs; it stages 16 output bytes in registers and
//   stores them at once, with single bytes up to the first 16-byte
//   boundary of the row and after the last.
// The starts are checked by the wrapper before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename E>
__global__ void lf_pack(const uint8_t* __restrict__ last, const int* __restrict__ lf,
                        int64_t N, E* __restrict__ tab, int* __restrict__ bad) {
    const int64_t row = blockIdx.y;
    const uint8_t* l = last + row * N;
    const int* f = lf + row * N;
    E* t = tab + row * N;
    bool out_of_range = false;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < N;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int v = f[i];
        out_of_range |= v < 0 || v >= N;
        t[i] = ((E)(unsigned)v << 8) | (E)l[i];
    }
    if (out_of_range) bad[row] = 1;
}

template <typename E>
__device__ __forceinline__ unsigned step(const E* t, E& cur) {
    const E e = __ldg(t + cur);
    cur = e >> 8;
    return (unsigned)e & 255u;
}

template <typename E>
__global__ void lf_walk_kernel(const E* __restrict__ tab, int64_t N,
                               const int* __restrict__ starts, int64_t nsteps,
                               const int* __restrict__ bad, uint8_t* __restrict__ out) {
    const int64_t row = blockIdx.x;
    if (threadIdx.x != 0 || bad[row]) return;
    const E* t = tab + row * N;
    uint8_t* o = out + row * nsteps;
    E cur = (E)starts[row];
    int64_t head = (int64_t)((16 - ((uintptr_t)o & 15)) & 15);
    if (head > nsteps) head = nsteps;
    int64_t s = 0;
    for (; s < head; ++s) o[s] = (uint8_t)step(t, cur);
    for (; s + 16 <= nsteps; s += 16) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j >> 2] |= step(t, cur) << (8 * (j & 3));
        *(uint4*)(o + s) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (; s < nsteps; ++s) o[s] = (uint8_t)step(t, cur);
}

template <typename E>
int run(const void* last, const void* lf, const void* starts, int64_t B, int64_t N,
        int64_t nsteps, void* table, void* bad, void* out, cudaStream_t st) {
    cudaError_t rc = cudaMemsetAsync(bad, 0, B * sizeof(int), st);
    if (rc != cudaSuccess) return (int)rc;
    const int64_t gx = (N + 255) / 256;
    lf_pack<E><<<dim3((unsigned)(gx < 1024 ? gx : 1024), (unsigned)B), 256, 0, st>>>(
        (const uint8_t*)last, (const int*)lf, N, (E*)table, (int*)bad);
    rc = cudaGetLastError();
    if (rc != cudaSuccess || nsteps == 0) return (int)rc;
    lf_walk_kernel<E><<<(unsigned)B, 32, 0, st>>>((const E*)table, N, (const int*)starts,
                                                  nsteps, (const int*)bad, (uint8_t*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// last (B, N) uint8, lf (B, N) int32, starts (B,) int32 in [0, N), table of
// B * N * 4 bytes (N <= 2^24) or B * N * 8 (above) -> bad (B,) int32 (1: a
// row with an LF entry outside [0, N), not walked), out (B, nsteps) uint8
// in walk order (the text back to front).
int kz_lf_walk(const void* last, const void* lf, const void* starts, int64_t B,
               int64_t N, int64_t nsteps, void* table, void* bad, void* out,
               void* stream) {
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    return N <= (1 << 24)
        ? run<uint32_t>(last, lf, starts, B, N, nsteps, table, bad, out, st)
        : run<uint64_t>(last, lf, starts, B, N, nsteps, table, bad, out, st);
}

}  // extern "C"
