// Batched FPAQ binary arithmetic encode (K11).
//
// kz_fpaq_encode replaces kanzi_tpu/ops/fpaq_batch.py: encode_blocks, an
// XLA scan of one step per byte (eight bit steps in a fori_loop) over B
// streams in lockstep, on u64 arithmetic emulated with 16-bit limbs, whose
// flush words are compacted per row after the scan.
//
// Bound: on the roofline, bytes (a byte read and at most one 4-byte word
// written per four input bytes). On the card, latency: every bit's split
// needs the interval and the probability the bit before left, so a stream
// is one chain of about a dozen dependent integer operations a bit.
//
// Design, simple and exact first:
// - one stream per CTA; its four 256-entry probability tables sit in
//   shared memory as u16 (a probability stays in [0, 65472]); low and high
//   are native u64, wrapping as the limbs do;
// - a byte's eight table indices (bits >> (8 - k), offset by tbl * 256)
//   depend on the byte only and are distinct, so the chain loads all eight
//   when the byte starts and stores them when it ends: the bit chain is
//   multiply, add, compare and select, with no memory access;
// - the chain reads its bytes 16 at a time (one load a group ahead) and
//   writes each flush word where it lands in emission order, dropping an
//   index at or past T but counting it; the CTA then zeroes the rest of the
//   row;
// - the bit-1 update p - floor((p - 65472) / 64) is a floor division of a
//   possibly negative int, written with shifts of non-negative values only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// floor(d / 64) for any int d, with no right shift of a negative value
__device__ __forceinline__ int floor_div64(int d) {
    return d >= 0 ? (d >> 6) : ~((~d) >> 6);
}

struct Coder {
    uint64_t low, high;
    int64_t nw;
    int tbl;
    uint16_t* probs;
    unsigned* words;
    int64_t T;

    __device__ __forceinline__ void byte(unsigned val) {
        uint16_t* pt = probs + tbl * 256;
        const unsigned bits = val + 256u;
        unsigned p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = pt[bits >> (8 - k)];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const uint64_t split = (((high - low) >> 8) * p[k]) >> 8;
            if ((val >> (7 - k)) & 1u) {
                high = low + split;
                p[k] -= (unsigned)floor_div64((int)p[k] - 65472);
            } else {
                low = low + split + 1u;
                p[k] -= p[k] >> 6;
            }
            if ((low ^ high) < (1ull << 24)) {
                if (nw < T) words[nw] = (unsigned)(high >> 24);
                ++nw;
                low <<= 32;
                high = (high << 32) | 0xFFFFFFFFull;
            }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) pt[bits >> (8 - k)] = (uint16_t)p[k];
        tbl = (int)(val >> 6);
    }
};

__global__ void __launch_bounds__(kThreads)
fpaq_encode_kernel(const uint8_t* __restrict__ data, const int* __restrict__ nbytes,
                   int64_t T, unsigned* __restrict__ words, int* __restrict__ nwords,
                   int* __restrict__ low_out) {
    __shared__ uint16_t probs[1024];
    __shared__ int64_t s_nw;
    const int64_t row = blockIdx.x;
    for (int i = threadIdx.x; i < 1024; i += kThreads) probs[i] = 32768;
    __syncthreads();
    unsigned* w = words + row * T;
    if (threadIdx.x == 0) {
        int64_t nb = nbytes[row];
        nb = nb < 0 ? 0 : (nb > T ? T : nb);
        const uint8_t* src = data + row * T;
        Coder c{0ull, 0x00FFFFFFFFFFFFFFull, 0, 0, probs, w, T};
        int64_t head = (int64_t)((16 - ((uintptr_t)src & 15)) & 15);
        if (head > nb) head = nb;
        int64_t t = 0;
        for (; t < head; ++t) c.byte(src[t]);
        const int64_t groups = (nb - t) / 16;
        const uint4* g = (const uint4*)(src + t);
        uint4 next = groups > 0 ? __ldg(g) : make_uint4(0u, 0u, 0u, 0u);
        for (int64_t i = 0; i < groups; ++i) {
            const uint4 cur = next;
            if (i + 1 < groups) next = __ldg(g + i + 1);
            const unsigned v[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
            for (int j = 0; j < 16; ++j) c.byte((v[j >> 2] >> (8 * (j & 3))) & 255u);
        }
        for (t += 16 * groups; t < nb; ++t) c.byte(src[t]);
        nwords[row] = (int)c.nw;
#pragma unroll
        for (int k = 0; k < 4; ++k) low_out[row * 4 + k] = (int)((c.low >> (16 * k)) & 0xFFFFu);
        s_nw = c.nw < T ? c.nw : T;
    }
    __syncthreads();
    for (int64_t i = s_nw + threadIdx.x; i < T; i += kThreads) w[i] = 0u;
}

}  // namespace

extern "C" {

// data (B, T) uint8, nbytes (B,) int32 (clamped to [0, T]) -> words (B, T)
// u32 flush words in emission order, zero past them (indices >= T dropped),
// nwords (B,) int32 (every flush counted), low (B, 4) int32 16-bit limbs
// of the final low, least significant first.
int kz_fpaq_encode(const void* data, const void* nbytes, int64_t B, int64_t T,
                   void* words, void* nwords, void* low, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    fpaq_encode_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int*)nbytes, T, (unsigned*)words, (int*)nwords,
        (int*)low);
    return (int)cudaGetLastError();
}

}  // extern "C"
