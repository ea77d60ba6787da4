// Subbotin range coder chunk encode (K7) and decode (K8): the device half
// of the RANGE entropy codec (reference v2/entropy/RangeCodec.go
// encodeByte :281-305, decodeByte :500-530). The host prepares per-chunk
// tables and splices headers, renorm words and the final low
// (native/src/range.cpp kz_range_prepare, kz_range_assemble,
// kz_range_dec_chunk).
//
// The coder state (low, range, code) is 60 bits wide; here it is one u64
// masked to 60 bits after every step that can carry past bit 59, which is
// what the JAX version's two 32-bit limbs compute (kanzi_tpu/ops/range.py
// :44-105). The renormalization loop runs at most twice per byte, as in
// the JAX version (after one emission the range is >= 2^28, after two
// >= 2^56).
//
// K7 kz_range_encode replaces kanzi_tpu/ops/range.py: encode_chunks, a
// lax.scan of one step per byte followed by a cumsum + scatter that
// compacts the 28-bit words. Bound: bytes on the roofline; in practice
// latency, each byte being a chain of 64-bit multiplies and compares.
// Design: one thread per chunk writes its words in order, with no
// compaction, then zeroes the rest of its row.
//
// K8 kz_range_decode replaces kanzi_tpu/ops/range.py: decode_chunks. The
// quotient that the JAX version finds by a 12-step binary search is
// rng2 == 0 ? 4095 : min((code - low) / rng2, 4095), one 64-bit division.
// The k-th 28-bit read sits at bit 60 + 28k of the row. Design: one thread
// per chunk. A read whose bits reach past the row's byte count returns 0
// there and makes the row's nreads -1, the error flag the host reads back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kM60 = (1ull << 60) - 1;
constexpr uint64_t kTop = kM60;                  // TOP_RANGE
constexpr uint64_t kBottom = 0xFFFFull;          // BOTTOM_RANGE
constexpr uint64_t kRangeMask = 0x0FFFFFFF00000000ull;

int threads_for(int64_t rows) {
    int64_t t = (rows + 131) / 132;
    return (int)(t < 1 ? 1 : (t > 32 ? 32 : t));
}

__device__ __forceinline__ int clamp_shift(int s) {
    return s < 0 ? 0 : (s > 63 ? 63 : s);
}

// One renormalization test: true when the byte's loop ends (the top 28 of
// the 60 bits of low and low+range differ and the range is not small);
// otherwise clamps a small range as the reference does and returns false.
__device__ __forceinline__ bool renorm_done(uint64_t low, uint64_t& rng) {
    const uint64_t sum = (low + rng) & kM60;
    if (((low ^ sum) & kRangeMask) != 0) {
        if (rng > kBottom) return true;
        rng = (0ull - low) & kBottom;
    }
    return false;
}

__global__ void range_encode_kernel(const uint8_t* __restrict__ syms,
                                    int64_t N,
                                    const int* __restrict__ nvalid,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ shifts,
                                    int64_t B, int* __restrict__ words,
                                    int* __restrict__ nwords,
                                    unsigned* __restrict__ lows) {
    const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const uint8_t* s = syms + row * N;
    const unsigned* cum_t = (const unsigned*)tables + row * 512;
    const unsigned* freq_t = cum_t + 256;
    const int sh = clamp_shift(shifts[row]);
    int64_t nv = nvalid[row];
    nv = nv < 0 ? 0 : (nv > N ? N : nv);
    int* w = words + row * 2 * N;

    uint64_t low = 0, rng = kTop;
    int64_t k = 0;
    for (int64_t i = 0; i < nv; ++i) {
        const unsigned b = s[i];
        const uint64_t r2 = rng >> sh;
        low = (low + (uint64_t)__ldg(cum_t + b) * r2) & kM60;
        rng = ((uint64_t)__ldg(freq_t + b) * r2) & kM60;
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            if (renorm_done(low, rng)) break;
            w[k++] = (int)(low >> 32);
            low = (low << 28) & kM60;
            rng = (rng << 28) & kM60;
        }
    }
    for (int64_t i = k; i < 2 * N; ++i) w[i] = 0;
    nwords[row] = (int)k;
    lows[2 * row] = (unsigned)low;
    lows[2 * row + 1] = (unsigned)(low >> 32);
}

__global__ void range_decode_kernel(const uint8_t* __restrict__ bufs,
                                    int64_t S,
                                    const int* __restrict__ nbytes,
                                    const int* __restrict__ tables,
                                    const uint8_t* __restrict__ f2s,
                                    const int* __restrict__ shifts,
                                    const int* __restrict__ nvalid,
                                    int64_t B, int64_t glen,
                                    uint8_t* __restrict__ out,
                                    int* __restrict__ nreads) {
    const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const uint8_t* buf = bufs + row * S;
    int64_t nb = nbytes[row];
    nb = nb < 0 ? 0 : (nb > S ? S : nb);
    const unsigned* cum_t = (const unsigned*)tables + row * 512;
    const unsigned* freq_t = cum_t + 256;
    const uint8_t* map = f2s + row * 4096;
    const int sh = clamp_shift(shifts[row]);
    int64_t nv = nvalid[row];
    nv = nv < 0 ? 0 : (nv > glen ? glen : nv);
    uint8_t* o = out + row * glen;

    // the first 60 bits: bytes 0..7 read big-endian, shifted down by 4
    uint64_t head = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        head = (head << 8) | (j < nb ? (uint64_t)__ldg(buf + j) : 0ull);
    uint64_t code = head >> 4;
    bool err = nv > 0 && nb < 8;
    uint64_t low = 0, rng = kTop;
    int64_t nr = 0;
    for (int64_t i = 0; i < nv; ++i) {
        const uint64_t r2 = rng >> sh;
        const uint64_t d = (code - low) & kM60;
        uint64_t q = 4095;
        if (r2 != 0) {
            q = d / r2;
            if (q > 4095) q = 4095;
        }
        const unsigned sym = __ldg(map + q);
        low = (low + (uint64_t)__ldg(cum_t + sym) * r2) & kM60;
        rng = ((uint64_t)__ldg(freq_t + sym) * r2) & kM60;
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            if (renorm_done(low, rng)) break;
            // 28 bits at bit 60 + 28 nr: a 40-bit window of 5 bytes
            const int64_t off = 60 + 28 * nr;
            const int64_t byte = off >> 3;
            if (((off + 27) >> 3) >= nb) err = true;
            uint64_t win = 0;
#pragma unroll
            for (int j = 0; j < 5; ++j)
                win = (win << 8) |
                      (byte + j < nb ? (uint64_t)__ldg(buf + byte + j) : 0ull);
            const uint64_t v = (win >> (12 - (int)(off & 7))) & 0xFFFFFFFull;
            code = ((code << 28) & kM60) | v;
            low = (low << 28) & kM60;
            rng = (rng << 28) & kM60;
            ++nr;
        }
        o[i] = (uint8_t)sym;
    }
    for (int64_t i = nv; i < glen; ++i) o[i] = 0;
    nreads[row] = err ? -1 : (int)nr;
}

}  // namespace

extern "C" {

// syms (B, N) uint8, nvalid (B,) int32, tables (B, 2, 256) int32 planes
// cumFreq, freq, shifts (B,) int32 -> words (B, 2N) int32 28-bit values in
// stream order, nwords (B,) int32, lows (B, 2) u32 limbs (lo, hi).
int kz_range_encode(const void* syms, int64_t N, const void* nvalid,
                    const void* tables, const void* shifts, int64_t B,
                    void* words, void* nwords, void* lows, void* stream) {
    if (B > 0) {
        const int threads = threads_for(B);
        range_encode_kernel<<<(unsigned)((B + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(
            (const uint8_t*)syms, N, (const int*)nvalid, (const int*)tables,
            (const int*)shifts, B, (int*)words, (int*)nwords,
            (unsigned*)lows);
    }
    return (int)cudaGetLastError();
}

// bufs (B, S) uint8, nbytes (B,) int32, tables (B, 2, 256) int32, f2s
// (B, 4096) uint8, shifts (B,) int32, nvalid (B,) int32 -> out (B, glen)
// uint8, nreads (B,) int32 (-1: a read past nbytes).
int kz_range_decode(const void* bufs, int64_t S, const void* nbytes,
                    const void* tables, const void* f2s, const void* shifts,
                    const void* nvalid, int64_t B, int64_t glen, void* out,
                    void* nreads, void* stream) {
    if (B > 0) {
        const int threads = threads_for(B);
        range_decode_kernel<<<(unsigned)((B + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(
            (const uint8_t*)bufs, S, (const int*)nbytes, (const int*)tables,
            (const uint8_t*)f2s, (const int*)shifts, (const int*)nvalid, B,
            glen, (uint8_t*)out, (int*)nreads);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
