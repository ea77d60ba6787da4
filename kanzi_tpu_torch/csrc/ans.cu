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
// multiply-add), so a chunk takes its group count times one step. No table
// word depends on a state, so the design takes the table traffic off the
// chain and runs the four states side by side:
// - a CTA of 512 threads holds one order-1 row or four order-0 rows (an
//   order-0 row's 256-entry table, 5 KiB, sits in shared memory whole);
// - warps 4-15 gather the five table words of every symbol of the next
//   tile of groups into shared memory (double-buffered, one barrier a
//   tile) while warps 0-3 run the chains of the tile before;
// - lane r of warp j runs state j of the CTA's row r, one group an
//   iteration, with the entries two groups ahead read ahead; the
//   reciprocal division is one __umulhi. A state's step stores its would-be
//   pair at the group's slot of a shared-memory stage and its emit bit in
//   a mask word, so nothing on the chain waits on another state;
// - during the next tile, warp 4 + r compacts row r's staged pairs in
//   (group, state) order, by the emit masks and a warp prefix sum, and
//   appends them at the row's pair count, p = 0, 1, ...;
// - when the chains are done, the whole CTA reverses [0, P) in place, which
//   puts the pairs in stream order (pair p at slot P-1-p, the JAX
//   compaction), and zeroes [P, 4G). Each thread swaps pairs of slots that
//   no other thread touches, so P = 4G (every step emits) needs no scratch.

// K6 kz_ans_decode replaces kanzi_tpu/ops/ans.py: decode_chunks, a lax.scan
// over groups decoding states 3, 2, 1, 0 that share one byte cursor.
// Bound: bytes on the roofline (microseconds). On the card, the latency of
// one chain per chunk: each group's four lookups need the states of the
// group before, and its renorm reads the cursor that those states moved.
// Design:
// - one CTA per row; thread 0 walks the chain, the other threads build the
//   row's table, stage its stream and zero the output past ngroups;
// - one 8-byte entry per freq slot, (symbol | freq << 8, slot - cumFreq),
//   both planes read as u32 as kanzi_tpu reads them: one dependent load
//   per state where there were two (map, then freq and cumFreq). That
//   holds freq whole below 2^24, as in every host table; a row with a freq
//   at or above it is wide: its entries hold (freq, slot - cumFreq) and the
//   walk loads the slot's symbol from the slot -> symbol map beside each
//   (on an H100 the extra load made every row 12-19 % slower, so a narrow
//   row does without it);
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

constexpr int kEncThreads = 512;     // warps 0-3 run the chains, 4-15 gather

// rows a CTA and groups a tile: an order-0 (uint8) CTA carries four rows,
// an order-1 (uint16) CTA one row; 2048 entries a tile
template <typename Sym> struct EncShape {
    static constexpr bool kOrder0 = sizeof(Sym) == 1;
    static constexpr int kRows = kOrder0 ? 4 : 1;
    static constexpr int kTile = 512 / kRows;
    // entries of one row in a tile buffer: 4 a group, 8 that the chain's
    // read-ahead may touch, and one more so that rows r and r + 1 of a
    // chain warp read other banks
    static constexpr int kRowEnt = 4 * kTile + 9;
    static constexpr int kEnt = kRows * kRowEnt;
    // u16 pair slots of one row in a tile's stage (4 a group, padded for
    // the banks) and u32 emit masks (one a state and 32 groups)
    static constexpr int kRowStage = 4 * kTile + 2;
    static constexpr int kMaskWords = kTile / 32;
    // shared memory: two buffers of (uint4 xMax, bias, cmplFreq, invFreq)
    // and u32 shifts, two stages and two mask sets, one compacted stage,
    // then the order-0 tables as uint4 and u32
    static constexpr size_t kSmem = 2 * (size_t)kEnt * 20
        + 3 * (size_t)kRows * kRowStage * 2 + 2 * (size_t)kRows * 4 * kMaskWords * 4
        + (kOrder0 ? (size_t)kRows * 256 * 20 : 0);
};

template <typename Sym>
__global__ void __launch_bounds__(kEncThreads)
ans_encode_kernel(const Sym* __restrict__ syms,
                  const int* __restrict__ ngroups,
                  const unsigned* __restrict__ tables,
                  int64_t B, int64_t G, int64_t S,
                  uint16_t* __restrict__ pairs,
                  int* __restrict__ npairs,
                  unsigned* __restrict__ states) {
    using Sh = EncShape<Sym>;
    constexpr int R = Sh::kRows, T = Sh::kTile, E = Sh::kEnt, RS = Sh::kRowStage;
    constexpr int MW = Sh::kMaskWords;
    constexpr bool kOrder0 = Sh::kOrder0;
    constexpr int kGather0 = 4 * 32;          // first gather thread
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* ent = (uint4*)smem;                       // [2][E]
    uint4* tab4 = ent + 2 * E;                       // [R][256], order 0
    unsigned* shr = (unsigned*)(tab4 + (kOrder0 ? R * 256 : 0));   // [2][E]
    unsigned* tsh = shr + 2 * E;                     // [R][256], order 0
    unsigned* fmask = tsh + (kOrder0 ? R * 256 : 0); // [2][R][4][MW]
    uint16_t* stg = (uint16_t*)(fmask + 2 * R * 4 * MW);   // [2][R][RS]
    uint16_t* cmp = stg + 2 * R * RS;                // [R][RS]
    __shared__ int s_ng[R], s_np[R];
    const int tid = threadIdx.x;
    const int64_t row0 = (int64_t)blockIdx.x * R;
    const int64_t W = 4 * G;
    if (tid < R) {
        int64_t ng = row0 + tid < B ? ngroups[row0 + tid] : 0;
        s_ng[tid] = (int)(ng < 0 ? 0 : (ng > G ? G : ng));
    }
    if (kOrder0) {
        for (int i = tid; i < R * 256; i += kEncThreads) {
            const int64_t row = row0 + i / 256;
            unsigned w5[5] = {0u, 0u, 0u, 0u, 0u};
            if (row < B) {
#pragma unroll
                for (int k = 0; k < 5; ++k) w5[k] = __ldg(tables + (row * 5 + k) * S + (i & 255));
            }
            tab4[i] = make_uint4(w5[0], w5[1], w5[2], w5[4]);
            tsh[i] = (w5[3] - 32u) & 31u;
        }
    }
    __syncthreads();
    int maxng = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) maxng = max(maxng, s_ng[r]);
    const int ntiles = (maxng + T - 1) / T;
    const bool vec = ((uintptr_t)syms & (4 * sizeof(Sym) - 1)) == 0;

    // warps 4-15: the entries of tile t, one group of one row an item
    auto gather = [&](int t) {
        uint4* eb = ent + (t & 1) * E;
        unsigned* sb = shr + (t & 1) * E;
        for (int it = tid - kGather0; it < R * T; it += kEncThreads - kGather0) {
            const int r = it / T, gg = it % T, g = t * T + gg;
            if (g >= s_ng[r]) continue;
            const int64_t row = row0 + r;
            const Sym* sp = syms + (row * G + g) * 4;
            unsigned s4[4];
            if (vec) {
                if constexpr (kOrder0) {
                    const uchar4 v = __ldg((const uchar4*)sp);
                    s4[0] = v.x; s4[1] = v.y; s4[2] = v.z; s4[3] = v.w;
                } else {
                    const ushort4 v = __ldg((const ushort4*)sp);
                    s4[0] = v.x; s4[1] = v.y; s4[2] = v.z; s4[3] = v.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) s4[j] = (unsigned)__ldg(sp + j);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int e = r * Sh::kRowEnt + 4 * gg + j;
                if constexpr (kOrder0) {
                    eb[e] = tab4[r * 256 + s4[j]];
                    sb[e] = tsh[r * 256 + s4[j]];
                } else {
                    unsigned w5[5];
#pragma unroll
                    for (int k = 0; k < 5; ++k) w5[k] = __ldg(tables + (row * 5 + k) * S + s4[j]);
                    eb[e] = make_uint4(w5[0], w5[1], w5[2], w5[4]);
                    sb[e] = (w5[3] - 32u) & 31u;
                }
            }
        }
    };
    // warp 4 + r (lane l): the pairs of row r in tile t, in (group, state)
    // order, compacted by the emit masks and appended at the row's slot
    // `base`; returns the new base
    const int lane = tid & 31;
    auto flush = [&](int t, int r, int base) {
        constexpr int gpl = T / 32;              // groups a lane
        static_assert(gpl < 32 && 32 % gpl == 0, "a lane's groups lie in one mask word");
        const int n = min(T, maxng - t * T);     // groups of the tile
        const unsigned* fm = fmask + ((t & 1) * R + r) * 4 * MW;
        const int g0 = lane * gpl;
        const int sh = g0 & 31;
        const int mine = max(0, min(gpl, n - g0));   // this lane's groups in the tile
        const unsigned keep = (1u << mine) - 1u;
        unsigned m[4];
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            m[j] = (fm[j * MW + (g0 >> 5)] >> sh) & keep;
            cnt += __popc(m[j]);
        }
        int incl = cnt;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
            if (lane >= off) incl += v;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
        const uint16_t* sg = stg + ((t & 1) * R + r) * RS;
        uint16_t* c = cmp + r * RS;
        int k = incl - cnt;
        for (int gg = 0; gg < gpl; ++gg) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if ((m[j] >> gg) & 1u) c[k++] = sg[4 * (g0 + gg) + j];
            }
        }
        __syncwarp();
        uint16_t* o = pairs + (row0 + r) * W + base;
        for (int i = lane; i < total; i += 32) o[i] = c[i];
        __syncwarp();
        return base + total;
    };

    // warp j, lane r: state j of row r
    const int j = tid >> 5, r = lane;
    const bool chain = j < 4 && r < R;
    const int ng = chain ? s_ng[r] : 0;
    unsigned x = kAnsTop;
    // warp 4 + r flushes row r and keeps its pair count
    const bool flusher = tid >= kGather0 && j - 4 < R;
    int base = 0;
    if (tid >= kGather0) gather(0);
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
        if (chain) {
            const uint4* eb = ent + (t & 1) * E + r * Sh::kRowEnt + j;
            const unsigned* sb = shr + (t & 1) * E + r * Sh::kRowEnt + j;
            uint16_t* sg = stg + ((t & 1) * R + r) * RS + j;
            unsigned* fm = fmask + ((t & 1) * R + r) * 4 * MW + j * MW;
            const int n = min(T, maxng - t * T);     // the same in every lane
            const int gend = ng - t * T;             // this row's valid groups
            uint4 e = eb[0], e1 = eb[4];             // xMax, bias, cmpl, invFreq
            unsigned sh = sb[0], sh1 = sb[4];
            unsigned bits = 0;
#pragma unroll 4
            for (int g = 0; g < n; ++g) {
                // two groups ahead (stale past gend)
                const uint4 e2 = eb[4 * (g + 2)];
                const unsigned sh2 = sb[4 * (g + 2)];
                const bool v = R == 1 || g < gend;
                const bool flag = v && x >= e.x;
                sg[4 * g] = (uint16_t)(x & 0xFFFFu);
                bits |= (unsigned)flag << (g & 31);
                if ((g & 31) == 31) {
                    fm[g >> 5] = bits;
                    bits = 0;
                }
                unsigned y = flag ? x >> 16 : x;
                y = y + e.y + (__umulhi(y, e.w) >> (sh & 31u)) * e.z;
                x = v ? y : x;
                e = e1;
                sh = sh1;
                e1 = e2;
                sh1 = sh2;
            }
            if (n & 31) fm[n >> 5] = bits;
        } else if (tid >= kGather0) {
            if (flusher && t > 0) base = flush(t - 1, j - 4, base);
            if (t + 1 < ntiles) gather(t + 1);
        }
        __syncthreads();
    }
    if (flusher) {
        if (ntiles > 0) base = flush(ntiles - 1, j - 4, base);
        if (lane == 0) s_np[j - 4] = base;
    }
    if (chain && row0 + r < B) states[(row0 + r) * 4 + j] = x;
    __syncthreads();
    // pairs [0, P) in emission order -> stream order; zero past P
    for (int rr = 0; rr < R && row0 + rr < B; ++rr) {
        const int64_t P = s_np[rr], half = P / 2;
        uint16_t* o = pairs + (row0 + rr) * W;
        // eight swaps a thread in flight; no other thread touches the slots
        for (int64_t i0 = tid; i0 < half; i0 += 8 * kEncThreads) {
            uint16_t a[8], b[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int64_t i = i0 + k * kEncThreads;
                if (i < half) {
                    a[k] = o[i];
                    b[k] = o[P - 1 - i];
                }
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int64_t i = i0 + k * kEncThreads;
                if (i < half) {
                    o[i] = b[k];
                    o[P - 1 - i] = a[k];
                }
            }
        }
        // zeros: u16 up to a 16-byte boundary, then 16 bytes a store
        const int64_t head = (int64_t)(((16 - ((uintptr_t)(o + P) & 15)) & 15) / 2);
        const int64_t z0 = P + (head < W - P ? head : W - P);
        for (int64_t i = P + tid; i < z0; i += kEncThreads) o[i] = 0;
        const int64_t nv = (W - z0) / 8;
        uint4* ov = (uint4*)(o + z0);
        for (int64_t i = tid; i < nv; i += kEncThreads) ov[i] = make_uint4(0u, 0u, 0u, 0u);
        for (int64_t i = z0 + 8 * nv + tid; i < W; i += kEncThreads) o[i] = 0;
        if (tid == 0) npairs[row0 + rr] = (int)P;
    }
}

template <typename Sym>
int launch_encode(const void* syms, const void* ngroups, const void* tables,
                  int64_t B, int64_t G, int64_t S, void* pairs, void* npairs,
                  void* states, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    using Sh = EncShape<Sym>;
    cudaError_t rc = cudaFuncSetAttribute(
        ans_encode_kernel<Sym>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Sh::kSmem);
    if (rc != cudaSuccess) return (int)rc;
    ans_encode_kernel<Sym><<<(unsigned)((B + Sh::kRows - 1) / Sh::kRows),
                             kEncThreads, Sh::kSmem, (cudaStream_t)stream>>>(
        (const Sym*)syms, (const int*)ngroups, (const unsigned*)tables, B, G,
        S, (uint16_t*)pairs, (int*)npairs, (unsigned*)states);
    return (int)cudaGetLastError();
}

// order-0 rows in shared memory: 2^14 entries of 8 bytes and their 2^14
// symbols (lr <= 14) and a byte stream of up to 40 KiB (a chunk's is at
// most 2 * 16384 + 256)
constexpr int64_t kSmemEntries = 1 << 14;
constexpr int64_t kStreamCap = 40960;
constexpr int kDecThreads = 256;

__device__ __forceinline__ bool bad_lr(int lr, int order, int64_t F) {
    return lr < 8 || lr > 16 || ((int64_t)(order ? 256 : 1) << lr) > F;
}

// A freq at or above 2^24 makes its row wide
constexpr unsigned kNarrowFreq = 1u << 24;

// One slot's entry, both planes read as u32 as kanzi_tpu reads them:
// y = slot - cumFreq mod 2^32; x = symbol | freq << 8 in a narrow row
// (every freq below 2^24, as every host table), x = freq in a wide row,
// whose symbols are read beside the entries from the slot -> symbol map
__device__ __forceinline__ uint2 dec_entry(bool wide, unsigned sym, unsigned slot,
                                           unsigned freq, unsigned cum) {
    return make_uint2(wide ? freq : sym | (freq << 8), slot - cum);
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
// kHost: the host decoder's int state, shifted down and compared with
// ANS_TOP signed (a state with bit 31 set: only a hostile stream has one);
// else kanzi_tpu's u32 state.
template <int kOrder, bool kShared, bool kWide, bool kHost>
__device__ __forceinline__ int64_t walk(const uint2* tab, const uint8_t* sym,
                                        const uint8_t* buf, int64_t nb,
                                        const unsigned* st0, int lr, int64_t ng,
                                        unsigned* o) {
    unsigned st[4], prv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j] = st0[j];
    const unsigned mask = (1u << lr) - 1u;
    int64_t n = 0;
    for (int64_t g = 0; g < ng; ++g) {
        uint2 e[4];
        unsigned sy[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned slot = st[j] & mask;
            const unsigned i = kOrder ? (prv[j] << lr) + slot : slot;
            e[j] = kShared ? tab[i] : __ldg(tab + i);
            if (kWide) sy[j] = kShared ? sym[i] : __ldg(sym + i);
        }
        uint64_t win = window8<kShared>(buf, n, nb);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int j = 3 - jj;
            const unsigned down = kHost ? (unsigned)((int)st[j] >> lr) : st[j] >> lr;
            unsigned y = (kWide ? e[j].x : e[j].x >> 8) * down + e[j].y;
            if (kHost ? (int)y < (int)kAnsTop : y < kAnsTop) {
                y = (y << 16) | (unsigned)(win >> 48);
                win <<= 16;
                n += 2;
            }
            st[j] = y;
            prv[j] = kWide ? sy[j] : e[j].x & 0xFFu;
        }
        o[g] = prv[0] | (prv[1] << 8) | (prv[2] << 16) | (prv[3] << 24);
    }
    return n;
}

__device__ __forceinline__ bool in_smem(int order, int lr, int64_t stream_smem) {
    return order == 0 && stream_smem > 0 && ((int64_t)1 << lr) <= kSmemEntries;
}

// Whether each row's freq plane holds a freq at or above 2^24: one CTA of
// kDecThreads a row, for the rows that decode from scratch tables
__global__ void ans_wide_kernel(const unsigned* __restrict__ dtabs, int64_t T,
                                int* __restrict__ wide) {
    const unsigned* freq = dtabs + (int64_t)blockIdx.x * 2 * T;
    int any = 0;
    for (int64_t i = threadIdx.x; i < T; i += blockDim.x) any |= __ldg(freq + i) >= kNarrowFreq;
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) wide[blockIdx.x] = any;
}

// The grid-wide pass: the tables of the rows that do not decode from
// shared memory, into scratch (B, F) entries. Grid (x: rows, y: slots).
__global__ void ans_table_kernel(const uint8_t* __restrict__ f2s, int64_t F,
                                 const unsigned* __restrict__ dtabs, int64_t T,
                                 const int* __restrict__ lrs, int order,
                                 int64_t stream_smem, const int* __restrict__ wides,
                                 uint2* __restrict__ scratch) {
    const int64_t row = blockIdx.x;
    const int lr = lrs[row];
    if (bad_lr(lr, order, F) || in_smem(order, lr, stream_smem)) return;
    const bool wide = wides[row] != 0;
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
        t[i] = dec_entry(wide, sym, (unsigned)i & mask, __ldg(freq + ti), __ldg(cum + ti));
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
                  const int* __restrict__ wides, unsigned* __restrict__ out,
                  int* __restrict__ nread, int host) {
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
        const int64_t entries = F < kSmemEntries ? F : kSmemEntries;
        uint2* tab = (uint2*)smem;
        unsigned* sfreq = (unsigned*)(tab + entries);
        unsigned* scum = sfreq + 256;
        uint8_t* sbuf = (uint8_t*)(scum + 256);
        uint8_t* ssym = sbuf + stream_smem;
        const unsigned* freq = dtabs + row * 2 * T;
        int w = 0;
        for (int i = tid; i < 256; i += kDecThreads) {
            sfreq[i] = __ldg(freq + i);
            scum[i] = __ldg(freq + T + i);
            w |= sfreq[i] >= kNarrowFreq;
        }
        // the stream, zero past nb (window8 reads up to 12 bytes past n)
#pragma unroll 8
        for (int64_t i = tid; i < stream_smem; i += kDecThreads)
            sbuf[i] = i < nb ? __ldg(buf + i) : 0;
        const bool wide = __syncthreads_or(w);
        const uint8_t* map = f2s + row * F;
        for (int i = tid; i < (1 << lr); i += kDecThreads) {
            const unsigned sym = __ldg(map + i);
            if (wide) ssym[i] = (uint8_t)sym;
            tab[i] = dec_entry(wide, sym, (unsigned)i, sfreq[sym], scum[sym]);
        }
        __syncthreads();
        if (tid == 0) {
            const int64_t n =
                host ? (wide ? walk<0, true, true, true>(tab, ssym, sbuf, nb, st0, lr, ng, o)
                             : walk<0, true, false, true>(tab, ssym, sbuf, nb, st0, lr, ng, o))
                     : (wide ? walk<0, true, true, false>(tab, ssym, sbuf, nb, st0, lr, ng, o)
                             : walk<0, true, false, false>(tab, ssym, sbuf, nb, st0, lr, ng, o));
            nread[row] = n > nb ? -1 : (int)n;
        }
    } else if (tid == 0) {
        int64_t n = 0;
        if (!bad) {
            const uint2* tab = scratch + row * F;
            const uint8_t* sym = f2s + row * F;
            if (host && wides[row])
                n = order ? walk<1, false, true, true>(tab, sym, buf, nb, st0, lr, ng, o)
                          : walk<0, false, true, true>(tab, sym, buf, nb, st0, lr, ng, o);
            else if (host)
                n = order ? walk<1, false, false, true>(tab, sym, buf, nb, st0, lr, ng, o)
                          : walk<0, false, false, true>(tab, sym, buf, nb, st0, lr, ng, o);
            else if (wides[row])
                n = order ? walk<1, false, true, false>(tab, sym, buf, nb, st0, lr, ng, o)
                          : walk<0, false, true, false>(tab, sym, buf, nb, st0, lr, ng, o);
            else
                n = order ? walk<1, false, false, false>(tab, sym, buf, nb, st0, lr, ng, o)
                          : walk<0, false, false, false>(tab, sym, buf, nb, st0, lr, ng, o);
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
    int64_t scratch;       // bytes of scratch the call needs: tables (B, F)
                           // and a wide flag per row
};

DecLayout dec_layout(int64_t S, int64_t F, int64_t order, int64_t B) {
    DecLayout l;
    l.stream_smem = (order == 0 && S <= kStreamCap) ? ((S + 3) & ~(int64_t)3) + 16 : 0;
    const int64_t entries = F < kSmemEntries ? F : kSmemEntries;
    l.smem = l.stream_smem ? entries * 9 + 2 * 256 * 4 + l.stream_smem : 0;
    l.scratch = (order == 1 || F > kSmemEntries || !l.stream_smem) ? B * F * 8 + B * 4 : 0;
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
    return launch_encode<uint8_t>(syms, ngroups, tables, B, G, S, pairs,
                                  npairs, states, stream);
}

// as kz_ans_encode_u8, with u16 symbol indices (order 1, S = 65536)
int kz_ans_encode_u16(const void* syms, const void* ngroups, const void* tables,
                      int64_t B, int64_t G, int64_t S, void* pairs,
                      void* npairs, void* states, void* stream) {
    return launch_encode<uint16_t>(syms, ngroups, tables, B, G, S, pairs,
                                   npairs, states, stream);
}

// bufs (B, S) uint8, nbytes (B,) int32, states0 (B, 4) u32, f2s (B, F)
// uint8, dtabs (B, 2, T) int32 planes freq, cumFreq (T = 256 or 65536),
// ngroups (B,) int32, lrs (B,) int32, scratch of scratch_bytes (at least
// kz_ans_decode_scratch's), host (the host decoder's signed state, 0 or
// 1) -> out (B, G, 4) uint8, nread (B,) int32 (-1: a read past nbytes, or a
// logRange the map cannot hold). Where rows read scratch tables, two
// launches build them first (each row's wide flag, then the tables); then
// one CTA per row.
int kz_ans_decode(const void* bufs, int64_t S, const void* nbytes,
                  const void* states0, const void* f2s, int64_t F,
                  const void* dtabs, int64_t T, const void* ngroups,
                  const void* lrs, int64_t order, int64_t B, int64_t G,
                  void* out, void* nread, void* scratch, int64_t scratch_bytes,
                  int64_t host, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const DecLayout l = dec_layout(S, F, order, B);
    if (scratch_bytes < l.scratch) return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(
        ans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (rc != cudaSuccess) return (int)rc;
    int* wides = l.scratch ? (int*)((char*)scratch + B * F * 8) : nullptr;
    if (l.scratch) {
        ans_wide_kernel<<<(unsigned)B, kDecThreads, 0, (cudaStream_t)stream>>>(
            (const unsigned*)dtabs, T, wides);
        const int64_t per_row = (int64_t)(order ? 256 : 1) << 16;
        const int64_t need = F < per_row ? F : per_row;
        const unsigned gy = (unsigned)((need + 255) / 256 < 1024 ? (need + 255) / 256 : 1024);
        ans_table_kernel<<<dim3((unsigned)B, gy), 256, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)f2s, F, (const unsigned*)dtabs, T, (const int*)lrs,
            (int)order, l.stream_smem, wides, (uint2*)scratch);
        rc = cudaGetLastError();
        if (rc != cudaSuccess) return (int)rc;
    }
    ans_decode_kernel<<<(unsigned)B, kDecThreads, (size_t)l.smem,
                        (cudaStream_t)stream>>>(
        (const uint8_t*)bufs, S, (const int*)nbytes, (const unsigned*)states0,
        (const uint8_t*)f2s, F, (const unsigned*)dtabs, T, (const int*)ngroups,
        (const int*)lrs, (int)order, G, l.stream_smem, (const uint2*)scratch, wides,
        (unsigned*)out, (int*)nread, (int)(host != 0));
    return (int)cudaGetLastError();
}

// bytes of scratch that kz_ans_decode needs for these shapes (0: none)
int64_t kz_ans_decode_scratch(int64_t S, int64_t F, int64_t order, int64_t B) {
    return dec_layout(S, F, order, B).scratch;
}

}  // extern "C"
