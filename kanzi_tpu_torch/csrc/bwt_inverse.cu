// BWT inverse by a batched LF-mapping walk (K10).
//
// kz_lf_walk replaces kanzi_tpu/ops/bwt_inverse.py: lf_walk, an XLA scan
// whose every step gathers B cursors' bytes from the last columns and
// their next positions from the LF mapping.
//
// Bound: on the roofline, bytes (a byte and an LF entry read a step, a
// byte written). On the card, latency: a walk is a chain of dependent
// loads, and 16 rows of 4 MiB hold 256 MiB of table, far past the 50 MB
// L2, so a step waits on device memory (about 325 ns). One chain a row
// leaves 16 chains in flight on 132 SMs.
//
// Design: cut each row's walk into segments of L = 2^k steps and walk them
// all at once. The walk is the map f = lf iterated from a start, so the
// segments' starts f^(mL)(start) follow from a table of f^L:
// - pack: each row's two tables become one, lf << 8 | byte, as u32 while
//   N <= 2^24 and u64 above, so a step is one dependent load; the launch
//   also flags each row with an LF entry outside [0, N) (bad[row] = 1);
//   every later launch skips such a row, so no gather leaves its row;
// - jump: J = f^L by pointer doubling, k launches over all B x N entries,
//   each J'[i] = J[J[i]] (coalesced reads of J, one gather), ping-ponging
//   between two u32 buffers (J holds indices only);
// - checkpoints: one thread a row follows c_0 = start, c_{m+1} = J[c_m]
//   for the S = ceil(nsteps / L) segments: S dependent loads;
// - segments: one thread a (row, segment) walks L steps from c_m through
//   the packed table (the last segment cut at nsteps) and writes them at
//   out[row, mL ...), 16 staged bytes a store where the output is aligned.
// This is exact for any in-range lf, a permutation or not, and for any
// nsteps. With k = 0, or nsteps <= L, there is one segment a row and no
// jump table: the walk of one thread a row. The wrapper picks k.
// The starts are checked by the wrapper before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// dst = src o src on every good row
__global__ void jump_round(const unsigned* __restrict__ src, int64_t N,
                           const int* __restrict__ bad, unsigned* __restrict__ dst) {
    const int64_t row = blockIdx.y;
    if (bad[row]) return;
    const unsigned* s = src + row * N;
    unsigned* d = dst + row * N;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < N;
         i += (int64_t)gridDim.x * blockDim.x)
        d[i] = __ldg(s + __ldg(s + i));
}

// ckpt[row, m] = J^m(start), m < S; one thread a row, each row in a CTA of
// its own so that the chains spread over the SMs
__global__ void checkpoints(const unsigned* __restrict__ J, int64_t N,
                            const int* __restrict__ starts, int64_t S,
                            const int* __restrict__ bad, unsigned* __restrict__ ckpt) {
    const int64_t row = blockIdx.x;
    if (threadIdx.x != 0 || bad[row]) return;
    const unsigned* j = J + row * N;
    unsigned* c = ckpt + row * S;
    unsigned cur = (unsigned)starts[row];
    for (int64_t m = 0; m < S; ++m) {
        c[m] = cur;
        if (m + 1 < S) cur = __ldg(j + cur);
    }
}

template <typename E>
__device__ __forceinline__ unsigned step(const E* t, E& cur) {
    const E e = __ldg(t + cur);
    cur = e >> 8;
    return (unsigned)e & 255u;
}

// one thread a (row, segment): L steps from its checkpoint (the starts
// themselves when ckpt is null, S = 1)
template <typename E>
__global__ void __launch_bounds__(kThreads)
walk_segments(const E* __restrict__ tab, int64_t N, const unsigned* __restrict__ ckpt,
              const int* __restrict__ starts, int64_t B, int64_t S, int64_t L,
              int64_t nsteps, const int* __restrict__ bad, uint8_t* __restrict__ out) {
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= B * S) return;
    const int64_t row = g / S, m = g - row * S;
    if (bad[row]) return;
    const E* t = tab + row * N;
    const int64_t first = m * L;
    const int64_t len = nsteps - first < L ? nsteps - first : L;
    uint8_t* o = out + row * nsteps + first;
    E cur = ckpt ? (E)ckpt[g] : (E)(unsigned)starts[row];
    int64_t head = (int64_t)((16 - ((uintptr_t)o & 15)) & 15);
    if (head > len) head = len;
    int64_t s = 0;
    for (; s < head; ++s) o[s] = (uint8_t)step(t, cur);
    for (; s + 16 <= len; s += 16) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j >> 2] |= step(t, cur) << (8 * (j & 3));
        *(uint4*)(o + s) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (; s < len; ++s) o[s] = (uint8_t)step(t, cur);
}

unsigned blocks_for(int64_t n) {
    const int64_t g = (n + kThreads - 1) / kThreads;
    return (unsigned)(g < 1024 ? (g < 1 ? 1 : g) : 1024);
}

template <typename E>
int run(const void* last, const void* lf, const void* starts, int64_t B, int64_t N,
        int64_t nsteps, int k, void* table, void* jump, void* ckpt, void* bad, void* out,
        cudaStream_t st) {
    cudaError_t rc = cudaMemsetAsync(bad, 0, B * sizeof(int), st);
    if (rc != cudaSuccess) return (int)rc;
    lf_pack<E><<<dim3(blocks_for(N), (unsigned)B), kThreads, 0, st>>>(
        (const uint8_t*)last, (const int*)lf, N, (E*)table, (int*)bad);
    rc = cudaGetLastError();
    if (rc != cudaSuccess || nsteps == 0) return (int)rc;
    const int64_t L = k > 0 ? (int64_t)1 << k : nsteps;
    const int64_t S = (nsteps + L - 1) / L;
    const unsigned* cp = nullptr;
    if (S > 1) {
        // J = lf^(2^k): round r writes buffer (r - 1) & 1
        unsigned* buf[2] = {(unsigned*)jump, (unsigned*)jump + B * N};
        const unsigned* src = (const unsigned*)lf;
        for (int r = 1; r <= k; ++r) {
            jump_round<<<dim3(blocks_for(N), (unsigned)B), kThreads, 0, st>>>(
                src, N, (const int*)bad, buf[(r - 1) & 1]);
            src = buf[(r - 1) & 1];
        }
        checkpoints<<<(unsigned)B, 32, 0, st>>>(
            src, N, (const int*)starts, S, (const int*)bad, (unsigned*)ckpt);
        cp = (const unsigned*)ckpt;
    }
    const int64_t threads = B * S;
    walk_segments<E><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const E*)table, N, cp, (const int*)starts, B, S, L, nsteps,
        (const int*)bad, (uint8_t*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// last (B, N) uint8, lf (B, N) int32, starts (B,) int32 in [0, N), k the
// jump rounds (segments of 2^k steps; 0: one segment a row), table of
// B * N * 4 bytes (N <= 2^24) or B * N * 8 (above), jump of 2 * B * N * 4
// bytes and ckpt of B * ceil(nsteps / 2^k) * 4 (both unused when k is 0 or
// nsteps <= 2^k) -> bad (B,) int32 (1: a row with an LF entry outside
// [0, N), not walked), out (B, nsteps) uint8 in walk order (the text back
// to front).
int kz_lf_walk(const void* last, const void* lf, const void* starts, int64_t B,
               int64_t N, int64_t nsteps, int64_t k, void* table, void* jump, void* ckpt,
               void* bad, void* out, void* stream) {
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    if (k < 0 || k > 30) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return N <= (1 << 24)
        ? run<uint32_t>(last, lf, starts, B, N, nsteps, (int)k, table, jump, ckpt, bad,
                        out, st)
        : run<uint64_t>(last, lf, starts, B, N, nsteps, (int)k, table, jump, ckpt, bad,
                        out, st);
}

}  // extern "C"
