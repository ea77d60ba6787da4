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
// K8 kz_range_decode replaces kanzi_tpu/ops/range.py: decode_chunks. Bound:
// bytes on the roofline (microseconds). On the card, the latency of one
// chain per chunk: each byte's quotient needs the state the byte before
// left. Design, to shorten the step:
// - one CTA per row; thread 0 walks the chain, all threads build its
//   tables and write its symbols out;
// - the quotient that the JAX version finds by a 12-step binary search,
//   rng2 == 0 ? 4095 : min((code - low) / rng2, 4095), comes from a float
//   estimate (d * rcp(rng2), within 1 of the exact quotient) and one
//   64-bit multiply-compare that corrects it by 1, not a 64-bit division;
//   the slot entry at the estimate loads while the check runs, and the
//   walker keeps code - low, the dividend, in place of code;
// - a 4096-entry slot table (symbol | cumFreq << 8, freq) in shared
//   memory, the plain version's `comb`: one load a byte where there were
//   three dependent ones (map, then cumFreq and freq);
// - the k-th 28-bit read (bit 60 + 28k of the row) computed by the CTA
//   into shared memory up front, as the plain version's `reads`, indexed
//   by the read count; the walker holds the next two in registers;
// - the symbols staged in shared memory and written out by all threads.
// A read whose bits reach past the row's byte count returns 0 there and
// makes the row's nreads -1, the error flag the host reads back.

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

constexpr int kDecThreads = 256;
constexpr int64_t kSlots = 4096;
constexpr int64_t kStage = 32768;       // symbols staged per segment
constexpr int64_t kSmemMax = 232448;    // dynamic shared memory of a CTA
constexpr int64_t kReadsCap = (kSmemMax - kSlots * 8 - 2048 - kStage) / 4;

// The k-th 28-bit read: bits 60 + 28k .. of the row, zero past nb
__device__ __forceinline__ unsigned read28(const uint8_t* buf, int64_t nb,
                                           int64_t k) {
    const int64_t off = 60 + 28 * k;
    const int64_t byte = off >> 3;
    uint64_t win = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j)
        win = (win << 8) | (byte + j < nb ? (uint64_t)__ldg(buf + byte + j) : 0ull);
    return (unsigned)((win >> (12 - (int)(off & 7))) & 0xFFFFFFFull);
}

// The quotient min(d / r2, 4095) (d, r2 < 2^60; 4095 where r2 == 0) in
// two halves. estimate(): float32 d * rcp(r2), capped at 4096 and
// truncated. rcp.approx is within 1 ulp, so the estimate's relative error
// is below 2^-21 and it lies within 1 of the exact quotient capped at 4096
// (r2 == 0 gives rcp +inf and 4096). correct(): one 64-bit multiply-compare
// moves it by 1; q * r2 <= d + r2 < 2^61 does not overflow.
__device__ __forceinline__ unsigned estimate(uint64_t d, uint64_t r2) {
    float rcp;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(__ull2float_rn(r2)));
    return __float2uint_rz(fminf(__fmul_rn(__ull2float_rn(d), rcp), 4096.0f));
}

__device__ __forceinline__ unsigned correct(unsigned q, uint64_t d, uint64_t r2) {
    const uint64_t p = (uint64_t)q * r2;
    if (p > d) --q;
    else if (d - p >= r2) ++q;
    return q < 4095u ? q : 4095u;
}

struct DecLayout {
    int64_t kmax;     // the last read index the plain version computes
    int64_t kcap;     // reads held in shared memory
    int64_t stage;    // bytes of the symbol stage
    int64_t smem;     // dynamic shared memory of the launch
};

__host__ __device__ DecLayout dec_layout(int64_t S, int64_t glen) {
    DecLayout l;
    l.kmax = 8 * S < 60 ? 0 : (8 * S - 60) / 28 + 1;
    l.kcap = l.kmax + 1 < kReadsCap ? l.kmax + 1 : kReadsCap;
    const int64_t g = (glen + 15) & ~(int64_t)15;
    l.stage = g < 16 ? 16 : (g < kStage ? g : kStage);
    l.smem = kSlots * 8 + 2048 + 4 * l.kcap + l.stage;
    return l;
}

__global__ void __launch_bounds__(kDecThreads)
range_decode_kernel(const uint8_t* __restrict__ bufs, int64_t S,
                    const int* __restrict__ nbytes,
                    const int* __restrict__ tables,
                    const uint8_t* __restrict__ f2s,
                    const int* __restrict__ shifts,
                    const int* __restrict__ nvalid, int64_t glen,
                    uint8_t* __restrict__ out, int* __restrict__ nreads) {
    extern __shared__ __align__(16) unsigned char smem[];
    const DecLayout l = dec_layout(S, glen);
    uint2* comb = (uint2*)smem;
    int* tab = (int*)(comb + kSlots);
    unsigned* reads = (unsigned*)(tab + 512);
    uint8_t* stage = (uint8_t*)(reads + l.kcap);

    const int64_t row = blockIdx.x;
    const int tid = threadIdx.x;
    const uint8_t* buf = bufs + row * S;
    int64_t nb = nbytes[row];
    nb = nb < 0 ? 0 : (nb > S ? S : nb);
    const int sh = clamp_shift(shifts[row]);
    int64_t nv = nvalid[row];
    nv = nv < 0 ? 0 : (nv > glen ? glen : nv);
    uint8_t* o = out + row * glen;

    for (int i = tid; i < 512; i += kDecThreads) tab[i] = tables[row * 512 + i];
#pragma unroll 4
    for (int64_t k = tid; k < l.kcap; k += kDecThreads) reads[k] = read28(buf, nb, k);
    __syncthreads();
    // slot -> (symbol | (cumFreq & 0xFFFFFF) << 8, (cumFreq >> 24) | freq):
    // the bits of the plain version's int64 comb, for any int32 table
    const uint8_t* map = f2s + row * kSlots;
    for (int i = tid; i < kSlots; i += kDecThreads) {
        const int sym = map[i];
        const int cum = tab[sym], freq = tab[256 + sym];
        comb[i] = make_uint2((unsigned)sym | (((unsigned)cum & 0xFFFFFFu) << 8),
                             (unsigned)((cum >> 24) | freq));
    }
    __syncthreads();

    // the walker's state lives in thread 0's registers across segments;
    // `code` holds code - low (mod 2^60), the quotient's dividend
    uint64_t code = 0, low = 0, rng = kTop;
    int64_t nr = 0;
    unsigned nx0 = 0, nx1 = 0;
    auto read_at = [&](int64_t k) -> unsigned {
        k = k < l.kmax ? k : l.kmax;
        return k < l.kcap ? reads[k] : read28(buf, nb, k);
    };
    if (tid == 0) {
        // the first 60 bits: bytes 0..7 read big-endian, shifted down by 4
        uint64_t head = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            head = (head << 8) | (j < nb ? (uint64_t)__ldg(buf + j) : 0ull);
        code = head >> 4;
        nx0 = read_at(0);
        nx1 = read_at(1);
    }
    for (int64_t base = 0; base < glen; base += l.stage) {
        const int64_t len = glen - base < l.stage ? glen - base : l.stage;
        const int64_t end = nv - base < len ? nv - base : len;
        if (tid == 0) {
            for (int64_t i = 0; i < end; ++i) {
                const uint64_t r2 = rng >> sh;
                // the entry at the estimate loads while the estimate is
                // checked; a corrected quotient loads again (rarely)
                const unsigned qe = estimate(code, r2);
                const unsigned qs = qe < 4095u ? qe : 4095u;
                uint2 e = comb[qs];
                const unsigned q = correct(qe, code, r2);
                if (q != qs) e = comb[q];
                const uint64_t step = (uint64_t)(e.x >> 8) * r2;
                low = (low + step) & kM60;
                code = (code - step) & kM60;
                rng = ((uint64_t)(int64_t)(int)e.y * r2) & kM60;
                stage[i] = (uint8_t)e.x;
                if (renorm_done(low, rng)) continue;
                code = ((code << 28) & kM60) | nx0;
                low = (low << 28) & kM60;
                rng = (rng << 28) & kM60;
                if (renorm_done(low, rng)) {
                    ++nr;
                    nx0 = nx1;
                    nx1 = read_at(nr + 1);
                    continue;
                }
                code = ((code << 28) & kM60) | nx1;
                low = (low << 28) & kM60;
                rng = (rng << 28) & kM60;
                nr += 2;
                nx0 = read_at(nr);
                nx1 = read_at(nr + 1);
            }
        }
        __syncthreads();
        for (int64_t i = tid; i < len; i += kDecThreads) o[base + i] = i < end ? stage[i] : 0;
        __syncthreads();
    }
    if (tid == 0) {
        // reads 0 .. kbad-1 lie inside the row's bytes (the plain version
        // counts them among its kmax + 1)
        int64_t kbad = 8 * nb < 88 ? 0 : (8 * nb - 88) / 28 + 1;
        kbad = kbad < l.kmax + 1 ? kbad : l.kmax + 1;
        const bool err = nr > kbad || (nv > 0 && nb < 8);
        nreads[row] = err ? -1 : (int)nr;
    }
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
// uint8, nreads (B,) int32 (-1: a read past nbytes). One CTA per row.
int kz_range_decode(const void* bufs, int64_t S, const void* nbytes,
                    const void* tables, const void* f2s, const void* shifts,
                    const void* nvalid, int64_t B, int64_t glen, void* out,
                    void* nreads, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const DecLayout l = dec_layout(S, glen);
    const cudaError_t rc = cudaFuncSetAttribute(
        range_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (rc != cudaSuccess) return (int)rc;
    range_decode_kernel<<<(unsigned)B, kDecThreads, (size_t)l.smem,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)bufs, S, (const int*)nbytes, (const int*)tables,
        (const uint8_t*)f2s, (const int*)shifts, (const int*)nvalid, glen,
        (uint8_t*)out, (int*)nreads);
    return (int)cudaGetLastError();
}

}  // extern "C"
