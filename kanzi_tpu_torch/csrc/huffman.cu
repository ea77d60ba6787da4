// Huffman lane pack (K3) and lane decode (K4): the device half of the
// 4-lane chunk layout of the Huffman codec (reference
// v2/entropy/HuffmanCodec.go:435-511 encode, :807-976 decode).
//
// K3 kz_pack_lanes replaces kanzi_tpu/ops/huffman.py: pack_lanes, an XLA
// gather + cumsum + scatter-add program.
// Bound: bytes. Per lane it reads FRAG symbols and writes 1538 words; the
// work per symbol is a table lookup, a scan step and two shared atomics.
// Design: one CTA of 256 threads per lane. The lane's 256-entry code table
// is staged in shared memory; thread t owns the 16 consecutive symbols
// [16t, 16t+16), looks up their (len<<12)|code entries, and a block-wide
// exclusive scan of the per-thread bit counts (warp shuffles, then one
// pass over the 8 warp totals) gives every code its bit offset. Codes are
// placed into 1538 shared u32 words with atomicOr; the codes of a prefix
// code do not overlap, so OR gives what the JAX scatter-add gives. A code
// that straddles a word boundary is split into a high and a low part with
// explicit cases, since a CUDA shift by 32 or more is undefined (the JAX
// version clamps its shift counts instead). Words then go out to global
// memory as int32 bit patterns of the big-endian u32 stream.
//
// K4 kz_decode_lanes replaces kanzi_tpu/ops/huffman.py: decode_lanes, a
// lax.scan of FRAG steps over all lanes.
// Bound: on the roofline, bytes (lane rows in, symbols out). In practice
// latency: each lane is FRAG dependent steps (peek 12 bits, look up,
// advance), so a lane's time is FRAG times the latency of one table load,
// far above either roofline bound. Design: one thread per lane; the 12-bit
// peek is three byte loads, the (sym<<8)|len entry comes from the chunk's
// 4096-entry table through the read-only cache (__ldg). Reads past the end
// of a lane row return zero, like the zero padding of the lane rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrag = 4096;
constexpr int kMaxWords = (kFrag * 12 + 31) / 32 + 2;  // 1538
constexpr int kPackThreads = 256;
constexpr int kItems = kFrag / kPackThreads;           // 16 symbols a thread

template <typename Sym>
__global__ void pack_lanes_kernel(const Sym* __restrict__ syms,
                                  const int* __restrict__ lane_len,
                                  const int* __restrict__ table_idx,
                                  const int* __restrict__ tables,
                                  int frag, int nwords,
                                  int* __restrict__ words,
                                  int* __restrict__ nbits) {
    __shared__ int tab[256];
    __shared__ unsigned int w[kMaxWords];
    __shared__ int warp_sum[kPackThreads / 32];
    const int lane = blockIdx.x;
    const int tid = threadIdx.x;
    tab[tid] = tables[(int64_t)table_idx[lane] * 256 + tid];
    for (int i = tid; i < nwords; i += kPackThreads) w[i] = 0u;
    __syncthreads();

    const int len_valid = lane_len[lane];
    const Sym* row = syms + (int64_t)lane * frag;
    int code[kItems];
    int total = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int i = tid * kItems + k;
        int c = 0;
        if (i < frag && i < len_valid) c = tab[((int)row[i]) & 0xFF];
        code[k] = c;
        total += c >> 12;
    }

    // block-wide exclusive scan of the per-thread bit counts
    const int lid = tid & 31;
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lid >= off) incl += v;
    }
    if (lid == 31) warp_sum[tid >> 5] = incl;
    __syncthreads();
    int warp_base = 0;
    int all = 0;
#pragma unroll
    for (int q = 0; q < kPackThreads / 32; ++q) {
        const int s = warp_sum[q];
        if (q < (tid >> 5)) warp_base += s;
        all += s;
    }
    int off = warp_base + incl - total;

#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int len = code[k] >> 12;
        const unsigned int val = (unsigned int)(code[k] & 0xFFF);
        if (val != 0u) {  // a zero code adds no bits
            const int word = off >> 5;
            const int s1 = 32 - (off & 31) - len;
            if (s1 >= 0) {
                // s1 == 32 only for a zero-length entry: its bits shift out
                if (s1 < 32 && word < nwords) atomicOr(&w[word], val << s1);
            } else {
                if (word < nwords) atomicOr(&w[word], val >> (-s1));
                if (word + 1 < nwords) atomicOr(&w[word + 1], val << (32 + s1));
            }
        }
        off += len;
    }
    __syncthreads();

    int* out = words + (int64_t)lane * nwords;
    for (int i = tid; i < nwords; i += kPackThreads) out[i] = (int)w[i];
    if (tid == 0) nbits[lane] = all;
}

__global__ void decode_lanes_kernel(const uint8_t* __restrict__ lanes,
                                    int64_t L, int64_t stride,
                                    const int* __restrict__ table_idx,
                                    const uint16_t* __restrict__ dtables,
                                    uint8_t* __restrict__ out) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    const uint8_t* row = lanes + lane * stride;
    const uint16_t* tab = dtables + (int64_t)table_idx[lane] * 4096;
    uint8_t* dst = out + lane * kFrag;
    int64_t bitpos = 0;
    for (int i = 0; i < kFrag; ++i) {
        const int64_t byte = bitpos >> 3;
        const unsigned int b0 = byte < stride ? __ldg(row + byte) : 0u;
        const unsigned int b1 = byte + 1 < stride ? __ldg(row + byte + 1) : 0u;
        const unsigned int b2 = byte + 2 < stride ? __ldg(row + byte + 2) : 0u;
        const unsigned int win = (b0 << 16) | (b1 << 8) | b2;
        const unsigned int code = (win >> (12 - (int)(bitpos & 7))) & 0xFFFu;
        const unsigned int val = __ldg(tab + code);
        dst[i] = (uint8_t)(val >> 8);
        bitpos += val & 0xFFu;
    }
}

}  // namespace

extern "C" {

// syms (L, frag) uint8, lane_len/table_idx (L,) int32, tables (C, 256)
// int32 -> words (L, nwords) int32, nbits (L,) int32. frag <= 4096.
// table_idx is used unchecked: the wrappers hold it to [0, C) here and in
// kz_decode_lanes.
int kz_pack_lanes_u8(const void* syms, const void* lane_len,
                     const void* table_idx, const void* tables, int64_t L,
                     int64_t frag, int64_t nwords, void* words, void* nbits,
                     void* stream) {
    if (L > 0)
        pack_lanes_kernel<uint8_t><<<(unsigned)L, kPackThreads, 0,
                                     (cudaStream_t)stream>>>(
            (const uint8_t*)syms, (const int*)lane_len, (const int*)table_idx,
            (const int*)tables, (int)frag, (int)nwords, (int*)words,
            (int*)nbits);
    return (int)cudaGetLastError();
}

// as kz_pack_lanes_u8, with int32 symbols
int kz_pack_lanes_i32(const void* syms, const void* lane_len,
                      const void* table_idx, const void* tables, int64_t L,
                      int64_t frag, int64_t nwords, void* words, void* nbits,
                      void* stream) {
    if (L > 0)
        pack_lanes_kernel<int><<<(unsigned)L, kPackThreads, 0,
                                 (cudaStream_t)stream>>>(
            (const int*)syms, (const int*)lane_len, (const int*)table_idx,
            (const int*)tables, (int)frag, (int)nwords, (int*)words,
            (int*)nbits);
    return (int)cudaGetLastError();
}

// lanes (L, stride) uint8 zero-padded, table_idx (L,) int32, dtables
// (C, 4096) uint16 -> out (L, 4096) uint8.
int kz_decode_lanes(const void* lanes, int64_t L, int64_t stride,
                    const void* table_idx, const void* dtables, void* out,
                    void* stream) {
    if (L > 0) {
        const int threads = 64;  // few lanes per CTA: spread lanes over SMs
        decode_lanes_kernel<<<(unsigned)((L + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(
            (const uint8_t*)lanes, L, stride, (const int*)table_idx,
            (const uint16_t*)dtables, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
