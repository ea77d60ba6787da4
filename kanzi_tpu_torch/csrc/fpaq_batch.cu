// Batched FPAQ binary arithmetic encode (K11).
//
// kz_fpaq_encode replaces kanzi_tpu/ops/fpaq_batch.py: encode_blocks, an
// XLA scan of one step per byte (eight bit steps in a fori_loop) over B
// streams in lockstep, on u64 arithmetic emulated with 16-bit limbs, whose
// flush words are compacted per row after the scan.
//
// Bound: on the roofline, bytes (a byte read and at most one 4-byte word
// written per four input bytes). On the card, latency: every bit's split
// needs the interval the bit before left, so a stream is one chain of
// dependent integer operations a bit, and the batch is the only
// parallelism (one stream a CTA).
//
// Design: the model runs off the coder's chain. A bit's probability
// depends on the data only (its context is tbl * 256 + (bits >> (8 - k)),
// tbl the previous valid byte's top two bits; the update depends on the
// bit), never on low or high. So one CTA a row splits the two:
// - the producer, warp 1: its lanes copy a ring half's bytes (kHalf of
//   them) into shared memory, then its lane 0 walks them with the four
//   256-entry u16 tables in shared memory (a byte's eight contexts are
//   distinct: all eight loaded, then all eight stored) and writes each
//   byte's eight pre-update probabilities, 16 bytes, into the ring;
// - the consumer, lane 0 of warp 0: the interval chain only. It takes a
//   byte's probabilities with one 16-byte shared load (issued a byte
//   ahead) and its bits from a register, keeps low and high - low with no
//   branch (both outcomes computed and selected, the flush word stored
//   under a predicate at its index, dropped at or past T but counted, the
//   flush shift a select), and multiplies 48 x 16 bits as two 32-bit
//   multiplies: high - low < 2^56 always holds, so (high - low) >> 8 has
//   48 bits (Coder below);
// - the two meet at each ring half on named barriers over their 64
//   threads: "half b filled" (producer arrives, consumer waits) and "half
//   b consumed" (consumer arrives, producer waits before refilling it).
//   Both count the halves from nbytes, and the consumer arrives on
//   "consumed" only for a half the producer will refill, so no barrier is
//   left half arrived;
// - warps 2 and 3 wait; after the chain all 128 threads zero the row past
//   its flush count.
// The bit-1 update p - floor((p - 65472) / 64) is a floor division of a
// possibly negative int, written with shifts of non-negative values only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHalf = 256;          // input bytes a ring half

// floor(d / 64) for any int d, with no right shift of a negative value
__device__ __forceinline__ int floor_div64(int d) {
    return d >= 0 ? (d >> 6) : ~((~d) >> 6);
}

// named barriers over warps 0 and 1: ids 1 + b (half b filled) and 3 + b
// (half b consumed); id 0 is __syncthreads
__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

struct Ring {
    uint4 probs[2][kHalf + 1];      // a byte's eight u16 probabilities; +1: the
    uint8_t vals[2][kHalf + 1];     // consumer's load a byte ahead stays inside
};

// warp 1: the model
__device__ void produce(const uint8_t* __restrict__ src, int64_t nb, int64_t nh,
                        uint16_t* probs, Ring& ring, int lane) {
    int tbl = 0;
    for (int64_t h = 0; h < nh; ++h) {
        const int b = (int)(h & 1);
        if (h >= 2) bar_sync(3 + b);
        const int64_t base = h * kHalf;
        const int cnt = (int)(nb - base < kHalf ? nb - base : kHalf);
        for (int i = lane; i < cnt; i += 32) ring.vals[b][i] = src[base + i];
        __syncwarp();
        if (lane == 0) {
            for (int i = 0; i < cnt; ++i) {
                const unsigned val = ring.vals[b][i];
                uint16_t* pt = probs + tbl * 256;
                const unsigned bits = val + 256u;
                unsigned p[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) p[k] = pt[bits >> (8 - k)];
                ring.probs[b][i] = make_uint4(p[0] | p[1] << 16, p[2] | p[3] << 16,
                                              p[4] | p[5] << 16, p[6] | p[7] << 16);
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const unsigned q = ((val >> (7 - k)) & 1u)
                        ? p[k] - (unsigned)floor_div64((int)p[k] - 65472)
                        : p[k] - (p[k] >> 6);
                    pt[bits >> (8 - k)] = (uint16_t)q;
                }
                tbl = (int)(val >> 6);
            }
        }
        __syncwarp();
        bar_arrive(1 + b);
    }
}

// *p = v where c holds, as a predicated store (no branch)
__device__ __forceinline__ void store_if(unsigned* p, unsigned v, bool c) {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.global.u32 [%0], %1;\n\t}"
                 ::"l"(p), "r"(v), "r"((unsigned)c));
}

// (d >> 8) * p >> 8 for d < 2^56, p < 2^16: a 48 x 16-bit product as one
// 32 x 32 -> 64 multiply and one 32-bit multiply-add into its high word
__device__ __forceinline__ uint64_t split_of(uint64_t d, unsigned p) {
    const uint64_t d8 = d >> 8;
    uint64_t prod;
    asm("{\n\t.reg .u32 lo, hi;\n\t"
        "mul.wide.u32 %0, %1, %3;\n\t"
        "mov.b64 {lo, hi}, %0;\n\t"
        "mad.lo.u32 hi, %2, %3, hi;\n\t"
        "mov.b64 %0, {lo, hi};\n\t}"
        : "=l"(prod) : "r"((unsigned)d8), "r"((unsigned)(d8 >> 32)), "r"(p));
    return prod >> 8;
}

// Two things bound the chain: its depth, and its issue slots, since each
// 32-bit integer instruction of a warp holds the SM sub-partition's 16-lane
// integer pipe two cycles, one lane active or 32. So the state is low and
// r = high - low (no subtraction opens a bit), and a bit is few
// instructions: the outcomes' sums low + split, (low + 1) + split and
// (r - 1) - split all start from the split (low + 1, r - 1 and high =
// low + r are ready before it), the flush test is on the selected pair,
// the word is high >> 24, and the store's address is end - room from one
// multiply-add, `room` counting the slots left before T (the flush count
// is T - room).
struct Coder {
    uint64_t low, r;
    int room;
    unsigned* end;

    __device__ __forceinline__ void bit(unsigned one, unsigned p) {
        const bool b1 = one != 0u;
        const uint64_t low1 = low + 1u, rm1 = r - 1u, high = low + r;
        const uint64_t split = split_of(r, p);
        const uint64_t h = b1 ? low + split : high;
        const uint64_t l = b1 ? low : low1 + split;
        const uint64_t rr = b1 ? split : rm1 - split;
        const bool flush = ((l ^ h) >> 24) == 0;
        store_if(end - room, (unsigned)(h >> 24), flush & (room > 0));
        room -= flush;
        low = flush ? l << 32 : l;
        r = flush ? (rr << 32) | 0xFFFFFFFFull : rr;
    }
};

// lane 0 of warp 0: the interval chain
__device__ Coder consume(int64_t nb, int64_t nh, const Ring& ring, unsigned* words,
                         int T, int lane) {
    Coder c{0ull, 0x00FFFFFFFFFFFFFFull, T, words + T};
    for (int64_t h = 0; h < nh; ++h) {
        const int b = (int)(h & 1);
        bar_sync(1 + b);
        if (lane == 0) {
            const int64_t base = h * kHalf;
            const int cnt = (int)(nb - base < kHalf ? nb - base : kHalf);
            uint4 q = ring.probs[b][0];
            unsigned val = ring.vals[b][0];
            for (int i = 0; i < cnt; ++i) {
                const uint4 cq = q;
                const unsigned cv = val;
                q = ring.probs[b][i + 1];
                val = ring.vals[b][i + 1];
                const unsigned w[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    c.bit(cv & (0x80u >> k), (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
            }
        }
        __syncwarp();
        if (h + 2 < nh) bar_arrive(3 + b);
    }
    return c;
}

__global__ void __launch_bounds__(kThreads)
fpaq_encode_kernel(const uint8_t* __restrict__ data, const int* __restrict__ nbytes,
                   int64_t T, unsigned* __restrict__ words, int* __restrict__ nwords,
                   int* __restrict__ low_out) {
    __shared__ uint16_t probs[1024];
    __shared__ Ring ring;
    __shared__ int64_t s_nw;
    const int64_t row = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = threadIdx.x; i < 1024; i += kThreads) probs[i] = 32768;
    __syncthreads();
    unsigned* w = words + row * T;
    int64_t nb = nbytes[row];
    nb = nb < 0 ? 0 : (nb > T ? T : nb);
    const int64_t nh = (nb + kHalf - 1) / kHalf;
    if (warp == 1) {
        produce(data + row * T, nb, nh, probs, ring, lane);
    } else if (warp == 0) {
        const Coder c = consume(nb, nh, ring, w, (int)T, lane);
        if (lane == 0) {
            const int nw = (int)T - c.room;
            nwords[row] = nw;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                low_out[row * 4 + k] = (int)((c.low >> (16 * k)) & 0xFFFFu);
            s_nw = nw < T ? nw : T;
        }
    }
    __syncthreads();
    for (int64_t i = s_nw + threadIdx.x; i < T; i += kThreads) w[i] = 0u;
}

}  // namespace

extern "C" {

// data (B, T) uint8 with T < 2^31 (the flush count is an int32), nbytes
// (B,) int32 (clamped to [0, T]) -> words (B, T)
// u32 flush words in emission order, zero past them (indices >= T dropped),
// nwords (B,) int32 (every flush counted), low (B, 4) int32 16-bit limbs
// of the final low, least significant first.
int kz_fpaq_encode(const void* data, const void* nbytes, int64_t B, int64_t T,
                   void* words, void* nwords, void* low, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    if (T >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    fpaq_encode_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int*)nbytes, T, (unsigned*)words, (int*)nwords,
        (int*)low);
    return (int)cudaGetLastError();
}

}  // extern "C"
