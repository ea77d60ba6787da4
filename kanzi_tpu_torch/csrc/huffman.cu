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
// advance), so a lane's time is FRAG times the latency of one step, far
// above either roofline bound. Design, to take memory round trips off the
// chain and spread the lanes over the card:
// - a CTA of 8 warps runs 8 lanes, each the first thread of its own warp,
//   so that one lane's steps never wait on another's (the Reader's launch
//   of one 4 MiB block, 1024 lanes, is 128 CTAs);
// - the Reader gives four consecutive lanes one chunk table, so the CTA
//   stages the table of each four lanes, 4096 u16, in shared memory; a
//   lane whose table is not the staged one reads its own through the
//   read-only cache, exactly;
// - each lane keeps the row's words wb..wb+4 around its bit position in
//   registers (the last two loaded ahead), so a step is one funnel shift
//   for the code, one shared-memory load and an add; with every length of
//   the staged table at most 32 (all the host's tables), a step advances
//   at most one word and takes its next code from the words as they are or
//   moved down by one before moving them; a table with a longer length
//   takes a walk that reloads at the new bit position, so any entry is
//   exact;
// - bytes at or past the row's stride read as 0 and are never loaded;
// - symbols go out four at a time as one 32-bit store.
// Both kernels take the table count C: a table_idx outside [0, C) reads no
// table and sets the lane's error flag (K3: nbits -1 and zero words; K4:
// bad[lane] = 1 and zero symbols), which the host reads with the result.

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
                                  int64_t C, int frag, int nwords,
                                  int* __restrict__ words,
                                  int* __restrict__ nbits) {
    __shared__ int tab[256];
    __shared__ unsigned int w[kMaxWords];
    __shared__ int warp_sum[kPackThreads / 32];
    const int lane = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t t = table_idx[lane];
    const bool bad = t < 0 || t >= C;       // no table is read for it
    tab[tid] = bad ? 0 : tables[t * 256 + tid];
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
    if (tid == 0) nbits[lane] = bad ? -1 : all;
}

// A CTA of 8 warps decodes 8 lanes, one a warp; four consecutive lanes
// share one staged table slot.
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecSlots = kDecWarps / 4;

// The aligned words of one lane row, read as big-endian u32: the row's
// bytes start `mis` bytes into word 0 and end in word last, whose bytes at
// or past the row's stride read as 0 (lastmask); words past it read as 0.
// A load always reads a word that holds a byte of the row.
struct RowWords {
    const unsigned* w;
    int last;
    unsigned lastmask;

    __device__ RowWords(const uint8_t* row, int64_t stride) {
        const int mis = (int)((uintptr_t)row & 3);
        w = (const unsigned*)(row - mis);
        const int64_t end = stride + mis, lw = (end - 1) >> 2;
        // a lane reads below bit 2^21 + 64; a longer row is cut there
        constexpr int64_t kCap = 1 << 17;
        last = (int)(lw <= kCap ? lw : kCap);
        lastmask = lw <= kCap ? ~0u << (8 * (4 * (lw + 1) - end)) : ~0u;
    }
    __device__ __forceinline__ unsigned operator()(int wi) const {
        const unsigned v = __byte_perm(__ldg(w + min(wi, last)), 0, 0x0123);
        return wi < last ? v : (wi == last ? v & lastmask : 0u);
    }
};

template <bool kShared>
__device__ __forceinline__ unsigned tab_entry(const uint16_t* tab, unsigned code) {
    return kShared ? (unsigned)tab[code] : (unsigned)__ldg(tab + code);
}

// One lane's FRAG steps, for a table whose every length is at most 32: a
// step advances at most one word, so it takes the next code from the
// words as they are or moved down by one, and issues that lookup before
// it moves them. The sum o + entry keeps o + length in its low 6 bits
// (the symbol lies above bit 7), and the funnel shift reads only the low 5.
template <bool kShared>
__device__ __forceinline__ void walk_lane_fast(const uint8_t* row, int64_t stride,
                                               const uint16_t* tab,
                                               unsigned* __restrict__ dst) {
    const RowWords rw(row, stride);
    int wb = 0;                              // w0..w4: words wb..wb + 4
    unsigned o = 8 * (unsigned)((uintptr_t)row & 3);
    unsigned w0 = rw(0), w1 = rw(1), w2 = rw(2), w3 = rw(3), w4 = rw(4);
    unsigned val = tab_entry<kShared>(tab, __funnelshift_l(w1, w0, o) >> 20);
    unsigned pack = 0;
#pragma unroll 4
    for (int i = 0; i < kFrag; ++i) {
        const unsigned acc = o + val;
        const bool adv = (acc & 32u) != 0;
        // the next lookup is issued before the words move down
        const unsigned nval = tab_entry<kShared>(
            tab, (adv ? __funnelshift_l(w2, w1, acc) : __funnelshift_l(w1, w0, acc)) >> 20);
        o = acc & 31u;
        if (adv) {
            ++wb;
            w0 = w1;
            w1 = w2;
            w2 = w3;
            w3 = w4;
            w4 = rw(wb + 4);
        }
        pack |= ((val >> 8) & 0xFFu) << (8 * (i & 3));
        if ((i & 3) == 3) {
            dst[i >> 2] = pack;
            pack = 0;
        }
        val = nval;
    }
}

// One lane's FRAG steps for any table; tab is a shared-memory table
// (kShared) or a device-memory one.
template <bool kShared>
__device__ __forceinline__ void walk_lane(const uint8_t* row, int64_t stride,
                                          const uint16_t* tab,
                                          unsigned* __restrict__ dst) {
    const RowWords rw(row, stride);
    // the bit position is 32 * wb + o, 0 <= o < 32; w0..w4 are the words
    // wb..wb + 4 (w3, w4 loaded ahead). It stays below 2^21 (FRAG steps of
    // at most 255 bits).
    int wb = 0, o = 8 * (int)((uintptr_t)row & 3);
    unsigned w0 = rw(0), w1 = rw(1), w2 = rw(2), w3 = rw(3), w4 = rw(4);
    unsigned pack = 0;
#pragma unroll 4
    for (int i = 0; i < kFrag; ++i) {
        const unsigned code = __funnelshift_l(w1, w0, o) >> 20;
        const unsigned val = tab_entry<kShared>(tab, code);
        o += (int)(val & 0xFFu);
        if (o < 64) {                        // an advance of at most one word
            if (o >= 32) {
                o -= 32;
                ++wb;
                w0 = w1;
                w1 = w2;
                w2 = w3;
                w3 = w4;
                w4 = rw(wb + 4);
            }
        } else {                             // a length above 32: reload
            wb += o >> 5;
            o &= 31;
            w0 = rw(wb);
            w1 = rw(wb + 1);
            w2 = rw(wb + 2);
            w3 = rw(wb + 3);
            w4 = rw(wb + 4);
        }
        pack |= ((val >> 8) & 0xFFu) << (8 * (i & 3));
        if ((i & 3) == 3) {
            dst[i >> 2] = pack;
            pack = 0;
        }
    }
}

// whether either u16 entry in v has a length (low byte) above 32
__device__ __forceinline__ bool long_len(unsigned v) {
    return (v & 0xFFu) > 32u || ((v >> 16) & 0xFFu) > 32u;
}

__global__ void __launch_bounds__(kDecThreads, 1)
decode_lanes_kernel(const uint8_t* __restrict__ lanes, int64_t L,
                    int64_t stride, const int* __restrict__ table_idx,
                    const uint16_t* __restrict__ dtables, int64_t C,
                    uint8_t* __restrict__ out, int* __restrict__ bad) {
    __shared__ __align__(16) uint16_t tabs[kDecSlots * 4096];
    __shared__ int64_t slot_t[kDecSlots];
    __shared__ int slot_long[kDecSlots];     // the staged table has a length above 32
    const int64_t base = (int64_t)blockIdx.x * kDecWarps;
    const int tid = threadIdx.x;
    if (tid < kDecSlots) {
        const int64_t l = base + 4 * tid;
        const int64_t t = l < L ? table_idx[l] : -1;
        slot_t[tid] = (t >= 0 && t < C) ? t : -1;
        slot_long[tid] = 0;
    }
    __syncthreads();
    const bool vec = ((uintptr_t)dtables & 15) == 0;
#pragma unroll
    for (int k = 0; k < kDecSlots; ++k) {
        const int64_t t = slot_t[k];
        if (t < 0) continue;
        const uint16_t* src = dtables + t * 4096;
        bool longer = false;                 // a length above 32
        if (vec) {
            for (int i = tid; i < 512; i += kDecThreads) {
                const uint4 v = __ldg((const uint4*)src + i);
                ((uint4*)(tabs + k * 4096))[i] = v;
                longer |= long_len(v.x) | long_len(v.y) | long_len(v.z) | long_len(v.w);
            }
        } else {
            for (int i = tid; i < 4096; i += kDecThreads) {
                const uint16_t v = __ldg(src + i);
                tabs[k * 4096 + i] = v;
                longer |= long_len(v);
            }
        }
        if (longer) atomicOr(&slot_long[k], 1);
    }
    __syncthreads();
    const int lid = tid >> 5;                // the lane's place in the CTA
    const int64_t lane = base + lid;
    if ((tid & 31) != 0 || lane >= L) return;
    const int64_t t = table_idx[lane];
    unsigned* dst = (unsigned*)(out + lane * kFrag);
    const bool oob = t < 0 || t >= C;
    bad[lane] = oob ? 1 : 0;
    if (oob) {                               // no table is read for it
        for (int i = 0; i < kFrag / 4; ++i) dst[i] = 0u;
        return;
    }
    const uint8_t* row = lanes + lane * stride;
    const int k = lid >> 2;
    if (slot_t[k] == t && !slot_long[k])
        walk_lane_fast<true>(row, stride, tabs + k * 4096, dst);
    else if (slot_t[k] == t)
        walk_lane<true>(row, stride, tabs + k * 4096, dst);
    else
        walk_lane<false>(row, stride, dtables + t * 4096, dst);
}

}  // namespace

extern "C" {

// syms (L, frag) uint8, lane_len/table_idx (L,) int32, tables (C, 256)
// int32 -> words (L, nwords) int32, nbits (L,) int32 (-1: table_idx
// outside [0, C)). frag <= 4096.
int kz_pack_lanes_u8(const void* syms, const void* lane_len,
                     const void* table_idx, const void* tables, int64_t C,
                     int64_t L, int64_t frag, int64_t nwords, void* words,
                     void* nbits, void* stream) {
    if (L > 0)
        pack_lanes_kernel<uint8_t><<<(unsigned)L, kPackThreads, 0,
                                     (cudaStream_t)stream>>>(
            (const uint8_t*)syms, (const int*)lane_len, (const int*)table_idx,
            (const int*)tables, C, (int)frag, (int)nwords, (int*)words,
            (int*)nbits);
    return (int)cudaGetLastError();
}

// as kz_pack_lanes_u8, with int32 symbols
int kz_pack_lanes_i32(const void* syms, const void* lane_len,
                      const void* table_idx, const void* tables, int64_t C,
                      int64_t L, int64_t frag, int64_t nwords, void* words,
                      void* nbits, void* stream) {
    if (L > 0)
        pack_lanes_kernel<int><<<(unsigned)L, kPackThreads, 0,
                                 (cudaStream_t)stream>>>(
            (const int*)syms, (const int*)lane_len, (const int*)table_idx,
            (const int*)tables, C, (int)frag, (int)nwords, (int*)words,
            (int*)nbits);
    return (int)cudaGetLastError();
}

// lanes (L, stride) uint8, table_idx (L,) int32, dtables (C, 4096) uint16
// -> out (L, 4096) uint8, bad (L,) int32 (1: table_idx outside [0, C)).
int kz_decode_lanes(const void* lanes, int64_t L, int64_t stride,
                    const void* table_idx, const void* dtables, int64_t C,
                    void* out, void* bad, void* stream) {
    if (L > 0)
        decode_lanes_kernel<<<(unsigned)((L + kDecWarps - 1) / kDecWarps), kDecThreads, 0,
                              (cudaStream_t)stream>>>(
            (const uint8_t*)lanes, L, stride, (const int*)table_idx,
            (const uint16_t*)dtables, C, (uint8_t*)out, (int*)bad);
    return (int)cudaGetLastError();
}

}  // extern "C"
