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
// Bound: bytes on the roofline (microseconds). On the card, the latency of
// one chain per chunk: each group's four lookups need the states of the
// group before, and its renorm reads the cursor that those states moved.
// Design:
// - one CTA per row; thread 0 walks the chain, the other threads build the
//   row's table, stage its stream and zero the output past ngroups;
// - one 8-byte entry per freq slot, (symbol | freq << 8, slot - cumFreq),
//   the plain version's `comb`: one dependent load per state where there
//   were two (map, then freq and cumFreq);
// - an order-0 row whose 2^lr entries fit (lr <= 14) keeps its table and
//   its byte stream in shared memory; an order-1 row (256 * 2^lr entries)
//   and a larger order-0 row read a table that a grid-wide pass, launched
//   first in the same call, builds in a scratch buffer the caller passes;
// - a group issues its four lookups and the load of the 8 bytes at the
//   cursor together, since all depend only on the group before; the
//   renormalisations 3, 2, 1, 0 then take their pairs from that window in
//   registers, so the cursor chain costs a few ALU operations a group.
// Each chunk carries its own logRange (8..16). A read at or past the row's
// byte count returns 0 and makes the row's nread -1, the error flag the
// host reads back with the symbols.

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

// order-0 rows in shared memory: 2^14 entries of 8 bytes (lr <= 14) and a
// byte stream of up to 40 KiB (a chunk's is at most 2 * 16384 + 256)
constexpr int64_t kSmemEntries = 1 << 14;
constexpr int64_t kStreamCap = 40960;
constexpr int kDecThreads = 256;

__device__ __forceinline__ bool bad_lr(int lr, int order, int64_t F) {
    return lr < 8 || lr > 16 || ((int64_t)(order ? 256 : 1) << lr) > F;
}

// One slot's entry: x = symbol | (freq & 0x1FFFF) << 8, y = slot - (cumFreq
// | freq >> 17), the bits the plain version's comb gives (exact for any
// table, not only the host's, whose freq and cumFreq are below 2^17)
__device__ __forceinline__ uint2 dec_entry(unsigned sym, unsigned slot,
                                           unsigned freq, unsigned cum) {
    return make_uint2(sym | ((freq & 0x1FFFFu) << 8), slot - (cum | (freq >> 17)));
}

// The 8 stream bytes at cursor n, big-endian (byte n on top), 0 past nb.
// Three aligned words: a word holding a byte below nb lies in the row's
// data, so no load leaves the buffer's pages. A shared buffer is aligned.
template <bool kShared>
__device__ __forceinline__ uint64_t window8(const uint8_t* buf, int64_t n,
                                            int64_t nb) {
    if (n >= nb) return 0ull;
    const int64_t mis = kShared ? 0 : (int64_t)((uintptr_t)buf & 3);
    const unsigned* w = (const unsigned*)(buf - mis);
    const int64_t pos = n + mis;
    const int64_t wi = pos >> 2;
    unsigned v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const bool in = 4 * (wi + i) < nb + mis;
        v[i] = in ? (kShared ? w[wi + i] : __ldg(w + wi + i)) : 0u;
    }
    const unsigned sh = (unsigned)(pos & 3) * 8;
    const unsigned lo = __byte_perm(__funnelshift_r(v[0], v[1], sh), 0, 0x0123);
    const unsigned hi = __byte_perm(__funnelshift_r(v[1], v[2], sh), 0, 0x0123);
    uint64_t win = ((uint64_t)lo << 32) | hi;
    const int64_t left = nb - n;
    if (left < 8) win &= ~0ull << (8 * (8 - left));
    return win;
}

// The chain of one row: ng groups, states 3, 2, 1, 0 sharing the cursor.
// Returns the bytes consumed (> nb where a read passed the stream's end).
template <int kOrder, bool kShared>
__device__ __forceinline__ int64_t walk(const uint2* tab, const uint8_t* buf,
                                        int64_t nb, const unsigned* st0,
                                        int lr, int64_t ng, unsigned* o) {
    unsigned st[4], prv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j] = st0[j];
    const unsigned mask = (1u << lr) - 1u;
    int64_t n = 0;
    for (int64_t g = 0; g < ng; ++g) {
        uint2 e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned slot = st[j] & mask;
            const uint2* p = tab + (kOrder ? (prv[j] << lr) + slot : slot);
            e[j] = kShared ? *p : __ldg(p);
        }
        uint64_t win = window8<kShared>(buf, n, nb);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int j = 3 - jj;
            unsigned y = (e[j].x >> 8) * (st[j] >> lr) + e[j].y;
            if (y < kAnsTop) {
                y = (y << 16) | (unsigned)(win >> 48);
                win <<= 16;
                n += 2;
            }
            st[j] = y;
            prv[j] = e[j].x & 0xFFu;
        }
        o[g] = prv[0] | (prv[1] << 8) | (prv[2] << 16) | (prv[3] << 24);
    }
    return n;
}

__device__ __forceinline__ bool in_smem(int order, int lr, int64_t stream_smem) {
    return order == 0 && stream_smem > 0 && ((int64_t)1 << lr) <= kSmemEntries;
}

// The grid-wide pass: the tables of the rows that do not decode from
// shared memory, into scratch (B, F) entries. Grid (x: rows, y: slots).
__global__ void ans_table_kernel(const uint8_t* __restrict__ f2s, int64_t F,
                                 const unsigned* __restrict__ dtabs, int64_t T,
                                 const int* __restrict__ lrs, int order,
                                 int64_t stream_smem, uint2* __restrict__ scratch) {
    const int64_t row = blockIdx.x;
    const int lr = lrs[row];
    if (bad_lr(lr, order, F) || in_smem(order, lr, stream_smem)) return;
    const int64_t n = (int64_t)(order ? 256 : 1) << lr;
    const uint8_t* map = f2s + row * F;
    const unsigned* freq = dtabs + row * 2 * T;
    const unsigned* cum = freq + T;
    uint2* t = scratch + row * F;
    const unsigned mask = (1u << lr) - 1u;
    for (int64_t i = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.y * blockDim.x) {
        const unsigned sym = map[i];
        const unsigned ti = order ? (((unsigned)(i >> lr)) << 8) + sym : sym;
        t[i] = dec_entry(sym, (unsigned)i & mask, __ldg(freq + ti), __ldg(cum + ti));
    }
}

__global__ void __launch_bounds__(kDecThreads)
ans_decode_kernel(const uint8_t* __restrict__ bufs, int64_t S,
                  const int* __restrict__ nbytes,
                  const unsigned* __restrict__ states0,
                  const uint8_t* __restrict__ f2s, int64_t F,
                  const unsigned* __restrict__ dtabs, int64_t T,
                  const int* __restrict__ ngroups,
                  const int* __restrict__ lrs, int order, int64_t G,
                  int64_t stream_smem, const uint2* __restrict__ scratch,
                  unsigned* __restrict__ out, int* __restrict__ nread) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t row = blockIdx.x;
    const int tid = threadIdx.x;
    const uint8_t* buf = bufs + row * S;
    int64_t nb = nbytes[row];
    nb = nb < 0 ? 0 : (nb > S ? S : nb);
    int64_t ng = ngroups[row];
    ng = ng < 0 ? 0 : (ng > G ? G : ng);
    const int lr = lrs[row];
    const bool bad = bad_lr(lr, order, F);
    if (bad) ng = 0;
    unsigned* o = out + row * G;
    const unsigned* st0 = states0 + row * 4;

    if (!bad && in_smem(order, lr, stream_smem)) {
        uint2* tab = (uint2*)smem;
        unsigned* sfreq = (unsigned*)(tab + (F < kSmemEntries ? F : kSmemEntries));
        unsigned* scum = sfreq + 256;
        uint8_t* sbuf = (uint8_t*)(scum + 256);
        const unsigned* freq = dtabs + row * 2 * T;
        for (int i = tid; i < 256; i += kDecThreads) {
            sfreq[i] = __ldg(freq + i);
            scum[i] = __ldg(freq + T + i);
        }
        // the stream, zero past nb (window8 reads up to 12 bytes past n)
#pragma unroll 8
        for (int64_t i = tid; i < stream_smem; i += kDecThreads)
            sbuf[i] = i < nb ? __ldg(buf + i) : 0;
        __syncthreads();
        const uint8_t* map = f2s + row * F;
        for (int i = tid; i < (1 << lr); i += kDecThreads) {
            const unsigned sym = __ldg(map + i);
            tab[i] = dec_entry(sym, (unsigned)i, sfreq[sym], scum[sym]);
        }
        __syncthreads();
        if (tid == 0) {
            const int64_t n = walk<0, true>(tab, sbuf, nb, st0, lr, ng, o);
            nread[row] = n > nb ? -1 : (int)n;
        }
    } else if (tid == 0) {
        int64_t n = 0;
        if (!bad) {
            const uint2* tab = scratch + row * F;
            n = order ? walk<1, false>(tab, buf, nb, st0, lr, ng, o)
                      : walk<0, false>(tab, buf, nb, st0, lr, ng, o);
        }
        nread[row] = (bad || n > nb) ? -1 : (int)n;
    }
    // the groups past ngroups are zero; warp 0 holds the walker
    for (int64_t i = ng + tid - 32; tid >= 32 && i < G; i += kDecThreads - 32)
        o[i] = 0u;
}

// Shared memory of a decode CTA, and whether scratch tables are needed
struct DecLayout {
    int64_t stream_smem;   // bytes of the staged stream, 0: no row in smem
    int64_t smem;          // dynamic shared memory of the launch
    int64_t scratch;       // bytes of scratch tables (B, F) the call needs
};

DecLayout dec_layout(int64_t S, int64_t F, int64_t order, int64_t B) {
    DecLayout l;
    l.stream_smem = (order == 0 && S <= kStreamCap) ? ((S + 3) & ~(int64_t)3) + 16 : 0;
    const int64_t entries = F < kSmemEntries ? F : kSmemEntries;
    l.smem = l.stream_smem ? entries * 8 + 2 * 256 * 4 + l.stream_smem : 0;
    l.scratch = (order == 1 || F > kSmemEntries || !l.stream_smem) ? B * F * 8 : 0;
    return l;
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
// ngroups (B,) int32, lrs (B,) int32, scratch of scratch_bytes (at least
// kz_ans_decode_scratch's) -> out (B, G, 4) uint8, nread (B,) int32 (-1: a
// read past nbytes, or a logRange the map cannot hold). Two launches: the
// scratch tables, then one CTA per row.
int kz_ans_decode(const void* bufs, int64_t S, const void* nbytes,
                  const void* states0, const void* f2s, int64_t F,
                  const void* dtabs, int64_t T, const void* ngroups,
                  const void* lrs, int64_t order, int64_t B, int64_t G,
                  void* out, void* nread, void* scratch, int64_t scratch_bytes,
                  void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const DecLayout l = dec_layout(S, F, order, B);
    if (scratch_bytes < l.scratch) return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(
        ans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (rc != cudaSuccess) return (int)rc;
    if (l.scratch) {
        const int64_t per_row = (int64_t)(order ? 256 : 1) << 16;
        const int64_t need = F < per_row ? F : per_row;
        const unsigned gy = (unsigned)((need + 255) / 256 < 1024 ? (need + 255) / 256 : 1024);
        ans_table_kernel<<<dim3((unsigned)B, gy), 256, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)f2s, F, (const unsigned*)dtabs, T, (const int*)lrs,
            (int)order, l.stream_smem, (uint2*)scratch);
        rc = cudaGetLastError();
        if (rc != cudaSuccess) return (int)rc;
    }
    ans_decode_kernel<<<(unsigned)B, kDecThreads, (size_t)l.smem,
                        (cudaStream_t)stream>>>(
        (const uint8_t*)bufs, S, (const int*)nbytes, (const unsigned*)states0,
        (const uint8_t*)f2s, F, (const unsigned*)dtabs, T, (const int*)ngroups,
        (const int*)lrs, (int)order, G, l.stream_smem, (const uint2*)scratch,
        (unsigned*)out, (int*)nread);
    return (int)cudaGetLastError();
}

// bytes of scratch that kz_ans_decode needs for these shapes (0: none)
int64_t kz_ans_decode_scratch(int64_t S, int64_t F, int64_t order, int64_t B) {
    return dec_layout(S, F, order, B).scratch;
}

}  // extern "C"
