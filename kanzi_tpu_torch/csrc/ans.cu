// 4-state rANS chunk encode (K5) and decode (K6): the device half of the
// ANS0/ANS1 entropy codec (reference v2/entropy/ANSRangeCodec.go:307-405
// encode, :904-948 decode). The host prepares per-chunk tables and splices
// headers, varints and tails (native/src/ans.cpp kz_ans_prepare,
// kz_ans_dec_prepare, kz_ans_assemble).
//
// K5 kz_ans_encode replaces kanzi_tpu/ops/ans.py: encode_chunks, a lax.scan
// over symbol groups with the 4 states as a vector axis, 16-bit-limb mulhi,
// then a cumsum + scatter that compacts the renorm pairs into stream order.
// Bound: on the roofline, bytes (symbols and tables in, pairs out). In
// practice latency: a state's steps form a chain (compare, shift, mulhi,
// multiply-add), so a chunk takes its symbol count times one step.
// Design: one thread per chunk runs its 4 states in emission order (group
// g, state j). The reciprocal division is one __umulhi. The p-th renorm
// pair goes to slot 4G-1-p, so the pairs lie in stream order at the end of
// the row; when the chunk is done they move to the front and the rest of
// the row is zeroed, which is the JAX compaction without a scan.
//
// K6 kz_ans_decode replaces kanzi_tpu/ops/ans.py: decode_chunks, a lax.scan
// over groups decoding states 3, 2, 1, 0 that share one byte cursor.
// Bound: bytes on the roofline; in practice latency, since every symbol
// is a dependent chain (slot -> freq-to-symbol map -> freq/cumFreq ->
// state, and the cursor links the states). Design: one thread per chunk;
// the maps come through the read-only cache (__ldg). Each chunk carries
// its own logRange (8..16), so streams with a non-default one decode here
// too. A read at or past the chunk's byte count returns 0 and makes the
// chunk's nread -1, the error flag the host reads back with the symbols.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAnsTop = 1u << 15;

// threads per CTA: spread the rows over the SMs (each row is one thread)
int threads_for(int64_t rows) {
    int64_t t = (rows + 131) / 132;
    return (int)(t < 1 ? 1 : (t > 32 ? 32 : t));
}

template <typename Sym>
__global__ void ans_encode_kernel(const Sym* __restrict__ syms,
                                  const int* __restrict__ ngroups,
                                  const int* __restrict__ tables,
                                  int64_t B, int64_t G, int64_t S,
                                  uint16_t* __restrict__ pairs,
                                  int* __restrict__ npairs,
                                  unsigned* __restrict__ states) {
    const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const Sym* sy = syms + row * G * 4;
    const unsigned* t = (const unsigned*)tables + row * 5 * S;
    const unsigned* xmax = t;
    const unsigned* bias = t + S;
    const unsigned* cmpl = t + 2 * S;
    const unsigned* ishift = t + 3 * S;
    const unsigned* ifreq = t + 4 * S;
    uint16_t* out = pairs + row * G * 4;
    const int64_t W = G * 4;
    int64_t ng = ngroups[row];
    ng = ng < 0 ? 0 : (ng > G ? G : ng);

    unsigned st[4] = {kAnsTop, kAnsTop, kAnsTop, kAnsTop};
    int64_t p = 0;
    for (int64_t g = 0; g < ng; ++g) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned s = (unsigned)sy[g * 4 + j];
            const unsigned xm = __ldg(xmax + s);
            const unsigned bi = __ldg(bias + s);
            const unsigned cf = __ldg(cmpl + s);
            const unsigned sh = __ldg(ishift + s);
            const unsigned fi = __ldg(ifreq + s);
            unsigned x = st[j];
            if (x >= xm) {
                out[W - 1 - p] = (uint16_t)(x & 0xFFFFu);
                ++p;
                x >>= 16;
            }
            const unsigned q = __umulhi(x, fi) >> ((sh - 32u) & 31u);
            st[j] = x + bi + q * cf;
        }
    }
    // the pairs sit in stream order in [W-p, W): move them to the front
    for (int64_t i = 0; i < p; ++i) out[i] = out[W - p + i];
    for (int64_t i = p; i < W; ++i) out[i] = 0;
    npairs[row] = (int)p;
#pragma unroll
    for (int j = 0; j < 4; ++j) states[row * 4 + j] = st[j];
}

__global__ void ans_decode_kernel(const uint8_t* __restrict__ bufs, int64_t S,
                                  const int* __restrict__ nbytes,
                                  const unsigned* __restrict__ states0,
                                  const uint8_t* __restrict__ f2s, int64_t F,
                                  const int* __restrict__ dtabs, int64_t T,
                                  const int* __restrict__ ngroups,
                                  const int* __restrict__ lrs, int order,
                                  int64_t B, int64_t G,
                                  uint8_t* __restrict__ out,
                                  int* __restrict__ nread) {
    const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const uint8_t* buf = bufs + row * S;
    int64_t nb = nbytes[row];
    nb = nb < 0 ? 0 : (nb > S ? S : nb);
    const uint8_t* map = f2s + row * F;
    const unsigned* freq = (const unsigned*)dtabs + row * 2 * T;
    const unsigned* cum = freq + T;
    uint8_t* o = out + row * G * 4;
    int64_t ng = ngroups[row];
    ng = ng < 0 ? 0 : (ng > G ? G : ng);
    const int lr = lrs[row];
    // a logRange the format cannot carry, or a map row too short for it
    if (lr < 8 || lr > 16 || ((int64_t)(order ? 256 : 1) << lr) > F) ng = -1;

    unsigned st[4];
    unsigned prv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j] = states0[row * 4 + j];
    const unsigned mask = (1u << (lr & 31)) - 1u;
    int64_t n = 0;
    bool err = ng < 0;
    for (int64_t g = 0; g < ng; ++g) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int j = 3 - jj;
            // the cursor's next two bytes, loaded before the state is known
            const unsigned b0 = n < nb ? (unsigned)__ldg(buf + n) : 0u;
            const unsigned b1 = n + 1 < nb ? (unsigned)__ldg(buf + n + 1) : 0u;
            const unsigned x = st[j];
            const unsigned ctx = order ? prv[j] : 0u;
            const unsigned slot = x & mask;
            const unsigned sym = __ldg(map + ((ctx << lr) + slot));
            const unsigned ti = (ctx << 8) + sym;
            unsigned y = __ldg(freq + ti) * (x >> lr) + slot - __ldg(cum + ti);
            if (y < kAnsTop) {
                if (n + 1 >= nb) err = true;
                y = (y << 16) | (b0 << 8) | b1;
                n += 2;
            }
            st[j] = y;
            prv[j] = sym;
            o[g * 4 + j] = (uint8_t)sym;
        }
    }
    for (int64_t i = (ng < 0 ? 0 : ng) * 4; i < G * 4; ++i) o[i] = 0;
    nread[row] = err ? -1 : (int)n;
}

}  // namespace

extern "C" {

// syms (B, G, 4) uint8 (order 0) symbol indices, ngroups (B,) int32,
// tables (B, 5, S) int32 planes xMax, bias, cmplFreq, invShift, invFreq
// (S >= 256) -> pairs (B, 4G) u16 in stream order, npairs (B,) int32,
// states (B, 4) u32.
int kz_ans_encode_u8(const void* syms, const void* ngroups, const void* tables,
                     int64_t B, int64_t G, int64_t S, void* pairs,
                     void* npairs, void* states, void* stream) {
    if (B > 0) {
        const int threads = threads_for(B);
        ans_encode_kernel<uint8_t><<<(unsigned)((B + threads - 1) / threads),
                                     threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)syms, (const int*)ngroups, (const int*)tables, B, G,
            S, (uint16_t*)pairs, (int*)npairs, (unsigned*)states);
    }
    return (int)cudaGetLastError();
}

// as kz_ans_encode_u8, with u16 symbol indices (order 1, S = 65536)
int kz_ans_encode_u16(const void* syms, const void* ngroups, const void* tables,
                      int64_t B, int64_t G, int64_t S, void* pairs,
                      void* npairs, void* states, void* stream) {
    if (B > 0) {
        const int threads = threads_for(B);
        ans_encode_kernel<uint16_t><<<(unsigned)((B + threads - 1) / threads),
                                      threads, 0, (cudaStream_t)stream>>>(
            (const uint16_t*)syms, (const int*)ngroups, (const int*)tables, B,
            G, S, (uint16_t*)pairs, (int*)npairs, (unsigned*)states);
    }
    return (int)cudaGetLastError();
}

// bufs (B, S) uint8, nbytes (B,) int32, states0 (B, 4) u32, f2s (B, F)
// uint8, dtabs (B, 2, T) int32 planes freq, cumFreq (T = 256 or 65536),
// ngroups (B,) int32, lrs (B,) int32 -> out (B, G, 4) uint8, nread (B,)
// int32 (-1: a read past nbytes, or a logRange the map cannot hold).
int kz_ans_decode(const void* bufs, int64_t S, const void* nbytes,
                  const void* states0, const void* f2s, int64_t F,
                  const void* dtabs, int64_t T, const void* ngroups,
                  const void* lrs, int64_t order, int64_t B, int64_t G,
                  void* out, void* nread, void* stream) {
    if (B > 0) {
        const int threads = threads_for(B);
        ans_decode_kernel<<<(unsigned)((B + threads - 1) / threads), threads, 0,
                            (cudaStream_t)stream>>>(
            (const uint8_t*)bufs, S, (const int*)nbytes,
            (const unsigned*)states0, (const uint8_t*)f2s, F,
            (const int*)dtabs, T, (const int*)ngroups, (const int*)lrs,
            (int)order, B, G, (uint8_t*)out, (int*)nread);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
