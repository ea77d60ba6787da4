// Huffman lane pack (K3) and lane decode (K4): the device half of the
// 4-lane chunk layout of the Huffman codec (reference
// v2/entropy/HuffmanCodec.go:435-511 encode, :807-976 decode).
//
// K3 kz_pack_lanes replaces kanzi_tpu/ops/huffman.py: pack_lanes, an XLA
// gather + cumsum + scatter-add program.
// Bound: bytes. Per lane it reads FRAG symbols and writes 1538 words; on
// the card, the latency of a CTA's few dependent phases times the waves of
// CTAs an SM runs. Design: one CTA of 256 threads per lane, two barriers
// before the words go out; thread t owns the 16 consecutive symbols
// [16t, 16t+16):
// - it loads them with 16-byte loads (one for uint8 symbols, four for
//   int32) where the row is 16-byte aligned, else one at a time, while the
//   lane's table index and its 256-entry code table (staged in shared
//   memory) load;
// - a block-wide exclusive scan of the per-thread bit counts (warp
//   shuffles, then one pass over the 8 warp totals) gives every code its
//   bit offset;
// - a lane whose table is narrow (code < 2^len, len <= 32: every host
//   table) runs a bit writer per thread; any other table takes each code's
//   high and low parts as the plain version computes them (shift counts
//   clamped, so no CUDA shift reaches 32), summed mod 2^32 per word as the
//   JAX scatter-add sums them: exact for codes wider than their length and
//   for any length. Either way a thread's words come in word order: it
//   stores each word it alone covers, and only the first and last words
//   it touches, which it may share with other threads, are merged with a
//   shared atomicAdd;
// - the words go out with 16-byte stores as int32 bit patterns of the
//   big-endian u32 stream.
// A negative entry used by a valid symbol (a negative length) makes the
// lane write no part, as a bad table index does: nbits -1 and zero words.
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

// Symbols [i0, i0 + 16) of a row into s[]; those at or past n (the lane's
// valid count) read as 0. A 16-byte-aligned row takes 16-byte loads (one
// for uint8 symbols, four for int32), issued before n is known; any other
// row, or a thread whose symbols reach past frag, loads one valid symbol
// at a time.
__device__ __forceinline__ void load_items(const uint8_t* row, int i0, int n,
                                           int frag, int (&s)[kItems]) {
    if (((uintptr_t)row & 15) == 0 && i0 + kItems <= frag) {
        const uint4 v = __ldg((const uint4*)(row + i0));
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < kItems; ++k)
            s[k] = i0 + k < n ? (int)((u[k >> 2] >> (8 * (k & 3))) & 0xFFu) : 0;
    } else {
#pragma unroll
        for (int k = 0; k < kItems; ++k) s[k] = i0 + k < n ? (int)row[i0 + k] : 0;
    }
}

__device__ __forceinline__ void load_items(const int* row, int i0, int n,
                                           int frag, int (&s)[kItems]) {
    if (((uintptr_t)row & 15) == 0 && i0 + kItems <= frag) {
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
            const int4 v = __ldg((const int4*)(row + i0) + q);
            s[4 * q] = v.x;
            s[4 * q + 1] = v.y;
            s[4 * q + 2] = v.z;
            s[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) s[k] = i0 + k < n ? s[k] : 0;
    } else {
#pragma unroll
        for (int k = 0; k < kItems; ++k) s[k] = i0 + k < n ? row[i0 + k] : 0;
    }
}

// One thread's parts into the lane's words (zeroed shared memory), in word
// order: the first and last words a thread touches may be shared with
// other threads and are added with a shared atomicAdd; every word between
// them is its own and is stored.
//
// Fast path, for a lane whose table entries are all narrow (code < 2^len)
// and at most 32 bits long, as every host table's are: a bit writer. The
// codes are shifted into a 64-bit accumulator; each full word goes out as
// it fills. Narrow codes do not overlap, so this is the plain version's sum.
__device__ __forceinline__ void put_narrow(unsigned* w, const int (&code)[kItems],
                                           int off, int nwords) {
    int wi = off >> 5;
    int nb = off & 31;               // bits held; the first ones are 0 here
    uint64_t acc = 0;
    bool first = true;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int len = code[k] >> 12;
        acc = (acc << len) | (unsigned)(code[k] & 0xFFF);
        nb += len;
        if (nb >= 32) {
            nb -= 32;
            const unsigned word = (unsigned)(acc >> nb);
            acc &= (1ull << nb) - 1;
            if (wi < nwords) {
                if (first) atomicAdd(&w[wi], word);
                else w[wi] = word;
            }
            first = false;
            ++wi;
        }
    }
    if (nb > 0 && wi < nwords) atomicAdd(&w[wi], (unsigned)(acc << (32 - nb)));
}

// Any codes: each code's high and low parts as the plain version computes
// them (shift counts clamped, so no CUDA shift reaches 32), summed mod 2^32
// per word, words past nwords dropped. A thread's parts come in word order,
// so it sums a word's parts in a register before it writes the word.
__device__ void put_any(unsigned* w, const int (&code)[kItems], int off,
                        int nwords) {
    int cur = -1;
    unsigned acc = 0u;
    bool first = true;
    auto add = [&](int wi, unsigned v) {
        if (v == 0u || wi >= nwords) return;
        if (wi != cur) {
            if (cur >= 0) {
                if (first) atomicAdd(&w[cur], acc);
                else w[cur] = acc;
                first = false;
            }
            cur = wi;
            acc = 0u;
        }
        acc += v;
    };
    for (int k = 0; k < kItems; ++k) {
        const int len = code[k] >> 12;
        const unsigned val = (unsigned)(code[k] & 0xFFF);
        const int wi = off >> 5;
        const int s1 = 32 - (off & 31) - len;
        if (s1 >= 0) {
            add(wi, s1 < 32 ? val << s1 : 0u);   // 32: a zero length at bit 0
        } else {
            add(wi, val >> (-s1 < 31 ? -s1 : 31));
            add(wi + 1, val << (32 + s1 > 0 ? 32 + s1 : 0));
        }
        off += len;
    }
    if (cur >= 0) atomicAdd(&w[cur], acc);
}

template <typename Sym>
__global__ void __launch_bounds__(kPackThreads)
pack_lanes_kernel(const Sym* __restrict__ syms,
                  const int* __restrict__ lane_len,
                  const int* __restrict__ table_idx,
                  const int* __restrict__ tables,
                  int64_t C, int frag, int nwords,
                  int* __restrict__ words,
                  int* __restrict__ nbits) {
    __shared__ __align__(16) unsigned w[kMaxWords + 2];
    __shared__ int tab[256];
    __shared__ int warp_sum[kPackThreads / 32];
    const int lane = blockIdx.x;
    const int tid = threadIdx.x;
    const int lv = lane_len[lane];
    const int64_t t = table_idx[lane];
    const int n = lv < 0 ? 0 : (lv > frag ? frag : lv);
    const int i0 = tid * kItems;
    // the symbols load first: they do not wait on the table
    int code[kItems];
    load_items(syms + (int64_t)lane * frag, i0, n, frag, code);
    const bool bad_idx = t < 0 || t >= C;   // no table is read for it
    const int e = bad_idx ? 0 : __ldg(tables + t * 256 + tid);
    tab[tid] = e;
    for (int i = tid; i < (nwords + 3) / 4; i += kPackThreads)
        ((uint4*)w)[i] = make_uint4(0u, 0u, 0u, 0u);
    // the lane takes the bit writer when every entry of its table is
    // narrow and at most 32 bits long (a negative entry is flagged below,
    // if a valid symbol uses it)
    const int el = e >> 12;
    const bool narrow = __syncthreads_and(
        e < 0 || (el <= 32 && (el >= 12 || ((e & 0xFFF) >> el) == 0)));

    int total = 0;
    bool neg = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int c = i0 + k < n ? tab[code[k] & 0xFF] : 0;
        neg |= c < 0;
        code[k] = c;
        total += c >> 12;
    }

    // block-wide exclusive scan of the per-thread bit counts; the barrier
    // also tells every thread whether any entry was negative
    const int lid = tid & 31;
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lid >= off) incl += v;
    }
    if (lid == 31) warp_sum[tid >> 5] = incl;
    // a negative entry (a negative length) flags the lane as a bad index does
    const bool bad = __syncthreads_or(neg) || bad_idx;
    int warp_base = 0;
    int all = 0;
#pragma unroll
    for (int q = 0; q < kPackThreads / 32; ++q) {
        const int s = warp_sum[q];
        if (q < (tid >> 5)) warp_base += s;
        all += s;
    }
    if (!bad) {
        const int off = warp_base + incl - total;
        if (narrow) put_narrow(w, code, off, nwords);
        else put_any(w, code, off, nwords);
    }
    __syncthreads();

    // out: four words a 16-byte store from the first aligned word on
    int* out = words + (int64_t)lane * nwords;
    const int head = (int)(((16 - ((uintptr_t)out & 15)) & 15) >> 2);
    const int h = head < nwords ? head : nwords;
    if (tid < h) out[tid] = (int)w[tid];
    const int nvec = (nwords - h) >> 2;
    for (int i = tid; i < nvec; i += kPackThreads) {
        const int b = h + 4 * i;
        ((int4*)(out + h))[i] = make_int4((int)w[b], (int)w[b + 1], (int)w[b + 2],
                                          (int)w[b + 3]);
    }
    const int tail = h + 4 * nvec + tid;
    if (tail < nwords) out[tail] = (int)w[tail];
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
// outside [0, C), or a negative entry for a valid symbol). frag <= 4096.
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
