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
// Design, so that a step is the chain's own ALU work:
// - one CTA of four warps per row; the first thread of warp 0 runs the
//   chain, alone in its warp;
// - the CTA stages the row's tables (cumFreq, freq as u32, as kanzi_tpu
//   reads them) in shared memory; warps 1-3 read each 1 KiB tile of the
//   row with 16-byte loads and write each byte's (cumFreq, freq) pair into
//   a double-buffered shared tile a tile ahead of the chain, which loads
//   the pairs of each group of four bytes while it computes the group
//   before;
// - a byte's renormalization is one pass of predicated selects; a second
//   emission in one byte needs the range left below 2^32, or within 2^32
//   of 2^60, by the first (as where freq is 0 or 1, or the shift is past
//   63): a cheap test flags it and the group of four bytes is redone
//   exactly, so the chain takes no branch a byte;
// - the chain appends its words to a double-buffered shared stage, which
//   the helpers copy out in order, coalesced, during the next tile; at
//   the end the whole CTA zeroes [nwords, 2N) with 16-byte stores.
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
// - a 4096-entry slot table (cumFreq, freq), both u32 as kanzi_tpu reads
//   them, and a 4096-byte slot -> symbol table beside it in shared memory:
//   two loads a byte, issued together at the estimate;
// - the k-th 28-bit read (bit 60 + 28k of the row) computed by the CTA
//   into shared memory up front, as the plain version's `reads`, indexed
//   by the read count; the walker holds the next two in registers;
// - the symbols staged in shared memory and written out by all threads.
// A read whose bits reach past the row's bits returns 0 there and makes
// the row's nreads -1, the error flag the host reads back.
// The engine's launch (`bound` given) follows the host decoder
// (native/src/range.cpp decodeByte) on hostile rows too: the state is u64
// as the host's, the quotient is checked against the host's slot table
// (grown to the block's largest, its stale slots in the row), and a range
// of 0 or a third word a byte flags the row, where the host decoder throws
// or reads on to the stream's end. A slot table past 4096 entries (logRange
// 13-15) takes the wide variant: slot -> symbol in shared memory, the
// (cumFreq, freq) pair read by symbol.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kM60 = (1ull << 60) - 1;
constexpr uint64_t kTop = kM60;                  // TOP_RANGE
constexpr uint64_t kBottom = 0xFFFFull;          // BOTTOM_RANGE
constexpr uint64_t kRangeMask = 0x0FFFFFFF00000000ull;

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

constexpr int kEncThreads = 128;     // warp 0: the chain; warps 1-3: helpers
constexpr int kEncHelpers = kEncThreads - 32;
constexpr int kEncTile = 1024;       // bytes a tile (a multiple of 16)

// Helper h of the helper warps writes (cumFreq, freq) of the tile's bytes
// [0, n) into p: 16-byte loads of the row where the tile start is 16-byte
// aligned and the 16 bytes lie in the row, else one byte at a time.
__device__ __forceinline__ void stage_pairs(const uint8_t* src, int64_t left,
                                            int n, const unsigned* tab,
                                            uint2* p, int h) {
    const bool vec = ((uintptr_t)src & 15) == 0;
    for (int g = h; 16 * g < n; g += kEncHelpers) {
        if (vec && 16 * g + 16 <= left) {
            const uint4 v = __ldg((const uint4*)src + g);
            const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const unsigned b = (u[j >> 2] >> (8 * (j & 3))) & 0xFFu;
                p[16 * g + j] = make_uint2(tab[b], tab[256 + b]);
            }
        } else {
            for (int j = 16 * g; j < 16 * g + 16 && j < n; ++j) {
                const unsigned b = src[j];
                p[j] = make_uint2(tab[b], tab[256 + b]);
            }
        }
    }
}

// Whether the state renormalizes (emits a word): the top 28 of the 60
// bits of low and low + rng agree, or rng is small. low may carry bits
// above 59: they never reach bits 32..59 of the sum, and a shift by 28
// drops them; rng stays masked, since it is shifted down.
__device__ __forceinline__ bool emits(uint64_t low, uint64_t rng) {
    const unsigned hi = (unsigned)(low >> 32);
    const bool diff = ((hi ^ (unsigned)((low + rng) >> 32)) & 0x0FFFFFFFu) != 0u;
    return !(diff && rng > kBottom);
}

// One emission: a small range whose top bits differ from low's is clamped
// as the reference does; bits 32..59 of low go out; both shift by 28.
__device__ __forceinline__ void emit(uint64_t& low, uint64_t& rng,
                                     unsigned* __restrict__ st, int& k) {
    const unsigned hi = (unsigned)(low >> 32);
    if (((hi ^ (unsigned)((low + rng) >> 32)) & 0x0FFFFFFFu) != 0u)
        rng = (0ull - low) & kBottom;
    st[k++] = hi & 0x0FFFFFFFu;
    low <<= 28;
    rng = (rng << 28) & kM60;
}

// One byte exactly: the update, then up to two emissions.
__device__ __forceinline__ void step_exact(uint2 e, int sh, uint64_t& low,
                                           uint64_t& rng, unsigned* __restrict__ st,
                                           int& k) {
    const uint64_t r2 = rng >> sh;
    low += (uint64_t)e.x * r2;
    rng = ((uint64_t)e.y * r2) & kM60;
    if (emits(low, rng)) {
        emit(low, rng, st, k);
        if (emits(low, rng)) emit(low, rng, st, k);
    }
}

// One byte with one renormalization pass, as selects (the word is stored
// at k whether or not it is emitted). `rare` is set where a second pass
// could emit: after an emission, only rng < 2^32 or rng >= 2^60 - 2^32
// can keep the top bits of low and low + rng equal, or rng small.
__device__ __forceinline__ void step_select(uint2 e, int sh, uint64_t& low,
                                            uint64_t& rng, unsigned* __restrict__ st,
                                            int& k, bool& rare) {
    const uint64_t r2 = rng >> sh;
    const uint64_t lowp = low + (uint64_t)e.x * r2;
    const uint64_t rngp = ((uint64_t)e.y * r2) & kM60;
    const unsigned hi = (unsigned)(lowp >> 32);
    const bool diff = ((hi ^ (unsigned)((lowp + rngp) >> 32)) & 0x0FFFFFFFu) != 0u;
    const bool big = rngp > kBottom;
    // no emission where diff && big; a clamp, then an emission, where
    // diff && !big; an emission where !diff
    const uint64_t lows = lowp << 28;
    const uint64_t rng_diff = big ? rngp : ((0ull - lowp) & kBottom) << 28;
    rng = diff ? rng_diff : (rngp << 28) & kM60;
    low = diff && big ? lowp : lows;
    const bool e1 = !(diff && big);
    st[k] = hi & 0x0FFFFFFFu;
    k += (int)e1;
    rare |= e1 && (unsigned)(rng >> 32) - 1u >= 0x0FFFFFFEu;
}

constexpr int kEncGroup = 4;

// The chain over one tile of n bytes, in groups of four: each byte one
// select pass, the group's pairs loaded a group ahead; a group where a
// second pass could emit (rare on a host table's data) is redone exactly
// from its starting state. Emitted words go to st. Returns the count.
__device__ __forceinline__ int encode_tile(const uint2* __restrict__ p, int n,
                                           int sh, uint64_t& low, uint64_t& rng,
                                           unsigned* __restrict__ st) {
    int k = 0;
    int i = 0;
    uint2 e[kEncGroup];
#pragma unroll
    for (int j = 0; j < kEncGroup; ++j) e[j] = p[j];
    for (; i + kEncGroup <= n; i += kEncGroup) {
        uint2 nx[kEncGroup];
#pragma unroll
        for (int j = 0; j < kEncGroup; ++j) nx[j] = p[i + kEncGroup + j];
        const uint64_t low0 = low, rng0 = rng;
        const int k0 = k;
        bool rare = false;
#pragma unroll
        for (int j = 0; j < kEncGroup; ++j) step_select(e[j], sh, low, rng, st, k, rare);
        if (rare) {
            low = low0;
            rng = rng0;
            k = k0;
#pragma unroll
            for (int j = 0; j < kEncGroup; ++j) step_exact(e[j], sh, low, rng, st, k);
        }
#pragma unroll
        for (int j = 0; j < kEncGroup; ++j) e[j] = nx[j];
    }
    for (; i < n; ++i) step_exact(p[i], sh, low, rng, st, k);
    return k;
}

// Helpers (or the whole CTA: stride) copy the n words of st to dst.
__device__ __forceinline__ void flush_words(int* dst, const unsigned* st, int n,
                                            int h, int stride) {
    for (int i = h; i < n; i += stride) dst[i] = (int)st[i];
}

__global__ void __launch_bounds__(kEncThreads)
range_encode_kernel(const uint8_t* __restrict__ syms, int64_t N,
                    const int* __restrict__ nvalid,
                    const int* __restrict__ tables,
                    const int* __restrict__ shifts,
                    int* __restrict__ words, int* __restrict__ nwords,
                    unsigned* __restrict__ lows) {
    __shared__ unsigned tab[512];
    __shared__ __align__(16) uint2 pairs[2][kEncTile + 2 * kEncGroup];
    __shared__ unsigned wst[2][2 * kEncTile];
    __shared__ int64_t wbase[2];
    __shared__ int wcount[2];
    const int64_t row = blockIdx.x;
    const int tid = threadIdx.x;
    const uint8_t* s = syms + row * N;
    int64_t nv = nvalid[row];
    nv = nv < 0 ? 0 : (nv > N ? N : nv);
    const int sh = clamp_shift(shifts[row]);
    int* w = words + row * 2 * N;
    const int ntiles = (int)((nv + kEncTile - 1) / kEncTile);
    auto tile_len = [&](int t) {
        const int64_t r = nv - (int64_t)t * kEncTile;
        return (int)(r < kEncTile ? r : kEncTile);
    };

    for (int i = tid; i < 512; i += kEncThreads) tab[i] = (unsigned)tables[row * 512 + i];
    __syncthreads();
    if (tid >= 32 && ntiles > 0) stage_pairs(s, N, tile_len(0), tab, pairs[0], tid - 32);
    __syncthreads();

    // tile t: thread 0 runs the chain on pairs[t & 1] into wst[t & 1]; the
    // helpers stage tile t + 1 and flush tile t - 1's words
    uint64_t low = 0, rng = kTop;
    int64_t k = 0;
    for (int t = 0; t < ntiles; ++t) {
        const int b = t & 1;
        if (tid == 0) {
            const int c = encode_tile(pairs[b], tile_len(t), sh, low, rng, wst[b]);
            wbase[b] = k;
            wcount[b] = c;
            k += c;
        } else if (tid >= 32) {
            const int64_t next = (int64_t)(t + 1) * kEncTile;
            if (t + 1 < ntiles)
                stage_pairs(s + next, N - next, tile_len(t + 1), tab, pairs[b ^ 1], tid - 32);
            if (t > 0)
                flush_words(w + wbase[b ^ 1], wst[b ^ 1], wcount[b ^ 1], tid - 32,
                            kEncHelpers);
        }
        __syncthreads();
    }
    // the last tile's words, then zeros over [nwords, 2N), by the whole CTA
    int64_t total = 0;
    if (ntiles > 0) {
        const int b = (ntiles - 1) & 1;
        flush_words(w + wbase[b], wst[b], wcount[b], tid, kEncThreads);
        total = wbase[b] + wcount[b];
    }
    const int64_t end = 2 * N;
    const int64_t head0 = (int64_t)(((16 - ((uintptr_t)(w + total) & 15)) & 15) >> 2);
    const int64_t head = head0 < end - total ? head0 : end - total;
    if (tid < head) w[total + tid] = 0;
    const int64_t a = total + head;
    const int64_t nvec = (end - a) >> 2;
    for (int64_t i = tid; i < nvec; i += kEncThreads)
        ((int4*)(w + a))[i] = make_int4(0, 0, 0, 0);
    const int64_t tail = a + 4 * nvec + tid;
    if (tail < end) w[tail] = 0;
    if (tid == 0) {
        nwords[row] = (int)k;
        lows[2 * row] = (unsigned)low;
        lows[2 * row + 1] = (unsigned)(low >> 32) & 0x0FFFFFFFu;
    }
}

constexpr int kDecThreads = 256;
constexpr int64_t kSlots = 4096;        // a narrow slot table (logRange <= 12)
constexpr int64_t kWideSlots = 32768;   // the format's logRange 15
constexpr int64_t kStage = 32768;       // symbols staged per segment
constexpr int64_t kSmemMax = 232448;    // dynamic shared memory of a CTA
// narrow: slot table (cumFreq, freq) 8 bytes a slot, slot -> symbol 1 byte
// a slot, the row's tables 2048 bytes; wide: slot -> symbol and the
// tables, the pair read from the tables by symbol. Then the reads and the
// symbol stage. Each slot table has one slot more (index F, a copy of F -
// 1's), for a strict quotient past the table, which the row flags anyway.
constexpr int64_t kSymPad = 16;         // slot -> symbol: F + 1 bytes, aligned
__host__ __device__ constexpr int64_t tab_bytes(bool wide) {
    return wide ? kWideSlots + kSymPad + 2048
                : (kSlots + 1) * 8 + kSlots + kSymPad + 2048;
}

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

// The quotient min(d / r2, cap) (r2 == 0 gives cap) in two halves.
// estimate(): float32 d * rcp(r2), capped at capf and truncated. rcp.approx
// is within 1 ulp, so the estimate's relative error is below 2^-21 and it
// lies within 1 of the exact quotient capped at capf (<= 32768); r2 == 0
// gives rcp +inf and capf. correct(): one 64 x 64 -> 128-bit multiply and a
// compare move it by 1 (d may use all 64 bits: the host decoder's state).
__device__ __forceinline__ unsigned estimate(uint64_t d, uint64_t r2, float capf) {
    float rcp;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(__ull2float_rn(r2)));
    return __float2uint_rz(fminf(__fmul_rn(__ull2float_rn(d), rcp), capf));
}

// kWide: q up to 32768 and r2 below 2^52 can carry q * r2 past 2^64, so
// its high half is checked too; with 4096 slots they cannot.
template <bool kWide>
__device__ __forceinline__ unsigned correct(unsigned q, uint64_t d, uint64_t r2,
                                            unsigned cap) {
    const uint64_t p = (uint64_t)q * r2;
    if ((kWide && __umul64hi((uint64_t)q, r2) != 0ull) || p > d) --q;
    else if (d - p >= r2) ++q;
    return q < cap ? q : cap;
}

struct DecLayout {
    int64_t kmax;     // the last read index the plain version computes
    int64_t kcap;     // reads held in shared memory
    int64_t stage;    // bytes of the symbol stage
    int64_t smem;     // dynamic shared memory of the launch
};

__host__ __device__ DecLayout dec_layout(int64_t S, int64_t glen, bool wide) {
    DecLayout l;
    const int64_t reads_cap = (kSmemMax - tab_bytes(wide) - kStage) / 4;
    l.kmax = 8 * S < 60 ? 0 : (8 * S - 60) / 28 + 1;
    l.kcap = l.kmax + 1 < reads_cap ? l.kmax + 1 : reads_cap;
    const int64_t g = (glen + 15) & ~(int64_t)15;
    l.stage = g < 16 ? 16 : (g < kStage ? g : kStage);
    l.smem = tab_bytes(wide) + 4 * l.kcap + l.stage;
    return l;
}

// kWide: a slot table of 32768 entries (the row's logRange above 12, or an
// earlier chunk's); its (cumFreq, freq) pair is read from the row's tables
// by symbol, one load after the symbol's. kStrict (`bound` given): the
// host decoder's rules (module comment); else kanzi_tpu's. Both are
// template arguments so that each variant's step carries only its own work.
template <bool kWide, bool kStrict>
__global__ void __launch_bounds__(kDecThreads)
range_decode_kernel(const uint8_t* __restrict__ bufs, int64_t S,
                    const int* __restrict__ nbytes,
                    const int* __restrict__ tables,
                    const uint8_t* __restrict__ f2s,
                    const int* __restrict__ shifts,
                    const int* __restrict__ nvalid, int64_t glen,
                    uint8_t* __restrict__ out, int* __restrict__ nreads,
                    const int* __restrict__ nbits,
                    const int* __restrict__ bound) {
    constexpr int64_t F = kWide ? kWideSlots : kSlots;
    extern __shared__ __align__(16) unsigned char smem[];
    const DecLayout l = dec_layout(S, glen, kWide);
    uint2* comb = (uint2*)smem;                          // narrow only
    uint8_t* slot_sym = kWide ? (uint8_t*)smem : (uint8_t*)(comb + kSlots + 1);
    unsigned* tab = (unsigned*)(slot_sym + F + kSymPad);
    unsigned* reads = tab + 512;
    uint8_t* stage = (uint8_t*)(reads + l.kcap);

    const int64_t row = blockIdx.x;
    const int tid = threadIdx.x;
    const uint8_t* buf = bufs + row * S;
    int64_t nb = nbytes[row];
    nb = nb < 0 ? 0 : (nb > S ? S : nb);
    // the row's bits: the reads wholly inside them are its own
    int64_t nbit = nbits ? (int64_t)nbits[row] : 8 * nb;
    nbit = nbit < 0 ? 0 : (nbit > 8 * nb ? 8 * nb : nbit);
    const int sh = clamp_shift(shifts[row]);
    int64_t nv = nvalid[row];
    nv = nv < 0 ? 0 : (nv > glen ? glen : nv);
    uint8_t* o = out + row * glen;
    // the host decoder's rules: a u64 state, and the quotient checked
    // against its slot table; kanzi_tpu's: 60 bits, the quotient capped
    constexpr uint64_t m = kStrict ? ~0ull : kM60;
    constexpr unsigned capq = kStrict ? (unsigned)F : (unsigned)(F - 1);
    const unsigned lim = kStrict ? (unsigned)(bound[row] < 0 ? 0 : bound[row]) : 0u;

    for (int i = tid; i < 512; i += kDecThreads) tab[i] = (unsigned)tables[row * 512 + i];
#pragma unroll 4
    for (int64_t k = tid; k < l.kcap; k += kDecThreads) reads[k] = read28(buf, nb, k);
    __syncthreads();
    // slot -> symbol, and (narrow) slot -> (cumFreq, freq) as u32, the
    // plain version's comb
    const uint8_t* map = f2s + row * F;
    for (int i = tid; i <= F; i += kDecThreads) {
        const int sym = map[i < F ? i : F - 1];
        if (!kWide) comb[i] = make_uint2(tab[sym], tab[256 + sym]);
        slot_sym[i] = (uint8_t)sym;
    }
    __syncthreads();

    // the walker's state lives in thread 0's registers across segments;
    // `code` holds code - low (mod 2^64 or 2^60), the quotient's dividend
    uint64_t code = 0, low = 0, rng = kTop;
    int64_t nr = 0;
    bool bad = false;
    unsigned qmax = 0, nx0 = 0, nx1 = 0;
    auto read_at = [&](int64_t k) -> unsigned {
        k = k < l.kmax ? k : l.kmax;
        return k < l.kcap ? reads[k] : read28(buf, nb, k);
    };
    auto entry = [&](unsigned q, uint8_t& sym) -> uint2 {
        sym = slot_sym[q];
        return kWide ? make_uint2(tab[sym], tab[256 + sym]) : comb[q];
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
    constexpr float capf = (float)F;
    for (int64_t base = 0; base < glen; base += l.stage) {
        const int64_t len = glen - base < l.stage ? glen - base : l.stage;
        const int64_t end = nv - base < len ? nv - base : len;
        if (tid == 0) {
            for (int64_t i = 0; i < end; ++i) {
                const uint64_t r2 = rng >> sh;
                // the entry at the estimate loads while the estimate is
                // checked; a corrected quotient loads again (rarely)
                const unsigned qe = estimate(code, r2, capf);
                const unsigned qs = qe < F - 1 ? qe : (unsigned)(F - 1);
                uint8_t sym;
                uint2 e = entry(qs, sym);
                const unsigned q = correct<kWide>(qe, code, r2, capq);
                if (q != qs) e = entry(q, sym);     // q == F: the pad slot
                const uint64_t step = (uint64_t)e.x * r2;
                low = (low + step) & m;
                code = (code - step) & m;
                rng = ((uint64_t)e.y * r2) & kM60;
                stage[i] = sym;
                // the host decoder throws at a quotient past its slot
                // table (a range of 0 emits a third word, flagged below)
                if (kStrict) qmax = q > qmax ? q : qmax;
                if (renorm_done(low, rng)) continue;
                code = ((code << 28) & m) | nx0;
                low = (low << 28) & m;
                rng = (rng << 28) & kM60;
                if (renorm_done(low, rng)) {
                    ++nr;
                    nx0 = nx1;
                    nx1 = read_at(nr + 1);
                    continue;
                }
                code = ((code << 28) & m) | nx1;
                low = (low << 28) & m;
                rng = (rng << 28) & kM60;
                nr += 2;
                nx0 = read_at(nr);
                nx1 = read_at(nr + 1);
                // a third word: the host decoder's loop goes on to the
                // stream's end (a range of 0 always comes here)
                if (kStrict) bad |= emits(low, rng);
            }
        }
        __syncthreads();
        for (int64_t i = tid; i < len; i += kDecThreads) o[base + i] = i < end ? stage[i] : 0;
        __syncthreads();
    }
    if (tid == 0) {
        // reads 0 .. kbad-1 lie inside the row's bits (the plain version
        // counts them among its kmax + 1)
        int64_t kbad = nbit < 88 ? 0 : (nbit - 88) / 28 + 1;
        kbad = kbad < l.kmax + 1 ? kbad : l.kmax + 1;
        const bool err = bad || (kStrict && qmax >= lim) || nr > kbad || (nv > 0 && nbit < 60);
        nreads[row] = err ? -1 : (int)nr;
    }
}

}  // namespace

extern "C" {

// syms (B, N) uint8, nvalid (B,) int32, tables (B, 2, 256) int32 planes
// cumFreq, freq, shifts (B,) int32 -> words (B, 2N) int32 28-bit values in
// stream order, nwords (B,) int32, lows (B, 2) u32 limbs (lo, hi). One CTA
// per row.
int kz_range_encode(const void* syms, int64_t N, const void* nvalid,
                    const void* tables, const void* shifts, int64_t B,
                    void* words, void* nwords, void* lows, void* stream) {
    if (B > 0)
        range_encode_kernel<<<(unsigned)B, kEncThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)syms, N, (const int*)nvalid, (const int*)tables,
            (const int*)shifts, (int*)words, (int*)nwords, (unsigned*)lows);
    return (int)cudaGetLastError();
}

// bufs (B, S) uint8, nbytes (B,) int32, tables (B, 2, 256) int32, f2s
// (B, F) uint8 with F 4096 or 32768, shifts (B,) int32, nvalid (B,) int32
// -> out (B, glen) uint8, nreads (B,) int32 (-1: a read past the row's bits,
// or with `bound` a state the host decoder fails on). nbits (B,) int32 or
// null: the row's bits (8 * nbytes); bound (B,) int32 or null: the host
// decoder's rules and slot table sizes. One CTA per row.
int kz_range_decode(const void* bufs, int64_t S, const void* nbytes,
                    const void* tables, const void* f2s, int64_t F,
                    const void* shifts, const void* nvalid, int64_t B,
                    int64_t glen, void* out, void* nreads, const void* nbits,
                    const void* bound, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    if (F != kSlots && F != kWideSlots) return (int)cudaErrorInvalidValue;
    const bool wide = F == kWideSlots;
    const DecLayout l = dec_layout(S, glen, wide);
    auto kernel = wide ? (bound ? range_decode_kernel<true, true>
                                : range_decode_kernel<true, false>)
                       : (bound ? range_decode_kernel<false, true>
                                : range_decode_kernel<false, false>);
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (rc != cudaSuccess) return (int)rc;
    kernel<<<(unsigned)B, kDecThreads, (size_t)l.smem, (cudaStream_t)stream>>>(
        (const uint8_t*)bufs, S, (const int*)nbytes, (const int*)tables,
        (const uint8_t*)f2s, (const int*)shifts, (const int*)nvalid, glen,
        (uint8_t*)out, (int*)nreads, (const int*)nbits, (const int*)bound);
    return (int)cudaGetLastError();
}

}  // extern "C"
