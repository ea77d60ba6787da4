// kanzi_tpu_torch native host runtime: common definitions.
//
// This is the C++ half of the framework: the bit-serial hot loops (entropy
// coder inner loops, suffix sort, match finders, content-aware transforms)
// that the device cannot run profitably live here; the batchable kernels live
// in kanzi_tpu_torch/ops as CUDA kernels. All bitstream semantics are MSB-first,
// matching the KANZ v6 contract (reference: v2/bitstream/*.go).
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace kz {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i8 = int8_t;
using i16 = int16_t;
using i32 = int32_t;
using i64 = int64_t;

struct Error : std::runtime_error {
    explicit Error(const std::string& msg) : std::runtime_error(msg) {}
};

// Context passed across the Python <-> C++ boundary. Mirrors the subset of
// the reference's ctx map the kernels consume (v2/io/CompressedStream.go:77).
struct Ctx {
    i32 bsVersion;      // bitstream version (6)
    i32 blockSize;      // container block size
    i32 size;           // current input size hint
    i32 entropyType;    // entropy codec id (text codec variant selection)
    i32 dataType;       // in/out: detected DataType
    i32 lzVariant;      // LZ_TYPE / LZX_TYPE / LZP_TYPE
    i32 sbrtMode;       // SBRT mode
    i32 textCodecVariant;
    i32 packOnlyDNA;
    i32 extra;          // TPAQX
    i32 jobs;
    i32 histo[256];     // optional shared histogram (textcodec <-> alias)
    i32 hasHisto;
};

static inline u32 log2_32(u32 x) {  // floor(log2(x)), x >= 1
    return 31u - __builtin_clz(x);
}

// Map the interior of [p, p+bytes) to transparent hugepages (mem.cpp).
// Best effort; call once per pool growth, not per block.
void adviseHugePages(void* p, size_t bytes);
int thpMode();  // KANZI_TORCH_THP: 0 off, 1 advise-before-touch, 2 collapse-after

// Grow-only scratch pool: resize-if-smaller. On growth the OLD CONTENTS ARE
// DISCARDED (every pool using this rewrites its contents per call) so the
// replacement allocation can be advised for hugepages BEFORE first touch —
// fresh pages then fault in as 2 MiB directly, instead of faulting 4K and
// paying a MADV_COLLAPSE copy (+ possible compaction stall) afterwards.
template <typename T>
inline T* hugePoolGrow(std::vector<T>& v, size_t n) {
    if (v.size() < n) {
        bool grew = v.capacity() < n;
        if (grew && thpMode() == 1) {
            // advise BEFORE first touch: a fresh mmap'd reserve then faults
            // 2 MiB pages directly (no 4K-fault + collapse-copy double
            // cost), and when malloc instead returns a warm already-faulted
            // chunk (raised M_MMAP_THRESHOLD in-process), the same call's
            // MADV_COLLAPSE converts those present pages — so no second
            // advise after resize is needed (reserve guarantees resize
            // cannot move the allocation)
            std::vector<T>().swap(v);  // release before allocating the bigger run
            v.reserve(n);
            adviseHugePages(v.data(), n * sizeof(T));
        }
        v.resize(n);
        // measurement-only mode 2: collapse strictly after first touch
        if (grew && thpMode() == 2) adviseHugePages(v.data(), n * sizeof(T));
    }
    return v.data();
}

// ---------------------------------------------------------------------------
// MSB-first bit writer over a caller-provided byte buffer.
// ---------------------------------------------------------------------------
class OBS {
  public:
    OBS(u8* buf, i64 cap) : buf_(buf), cap_(cap), pos_(0), acc_(0), avail_(64) {}

    inline void writeBit(int bit) { writeBits((u64)(bit & 1), 1); }

    inline void writeBits(u64 value, u32 count) {
        // count in [1..64]
        acc_ |= ((value << (64 - count)) >> (64 - avail_));
        if (count >= avail_) {
            u32 remaining = count - avail_;
            push(acc_);
            acc_ = (remaining == 0) ? 0 : (value << (64 - remaining));
            avail_ = 64 - remaining;
        } else {
            avail_ -= count;
        }
    }

    void writeArray(const u8* bits, u64 count) {
        u64 remaining = count;
        u64 start = 0;
        if ((avail_ & 7) == 0) {
            while (avail_ != 64 && remaining >= 8) {
                writeBits(bits[start], 8);
                start++;
                remaining -= 8;
            }
            u64 nbytes = remaining >> 3;
            if (nbytes) {
                need(nbytes);
                std::memcpy(buf_ + pos_, bits + start, nbytes);
                pos_ += (i64)nbytes;
                start += nbytes;
                remaining -= nbytes << 3;
            }
        } else if (remaining >= 64) {
            u32 r = 64 - avail_, a = avail_;
            while (remaining >= 64) {
                u64 val = be64(bits + start);
                push(acc_ | (val >> r));
                acc_ = val << a;
                avail_ = a;
                start += 8;
                remaining -= 64;
            }
        }
        while (remaining >= 8) {
            writeBits(bits[start], 8);
            start++;
            remaining -= 8;
        }
        if (remaining > 0)
            writeBits((u64)bits[start] >> (8 - remaining), (u32)remaining);
    }

    // Exact bit count written so far.
    inline u64 written() const { return (u64)pos_ * 8 + (64 - avail_); }

    // Flush the partial accumulator, padding the last byte with low zeros.
    void close() {
        while (avail_ < 64) {
            need(1);
            buf_[pos_++] = (u8)(acc_ >> 56);
            acc_ <<= 8;
            avail_ += 8;
        }
        avail_ = 64;
        acc_ = 0;
    }

  private:
    inline static u64 be64(const u8* p) {
        u64 v;
        std::memcpy(&v, p, 8);
        return __builtin_bswap64(v);
    }

    inline void need(u64 n) {
        if (pos_ + (i64)n > cap_) throw Error("output buffer overflow");
    }

    inline void push(u64 val) {
        need(8);
        u64 be = __builtin_bswap64(val);
        std::memcpy(buf_ + pos_, &be, 8);
        pos_ += 8;
    }

    u8* buf_;
    i64 cap_;
    i64 pos_;
    u64 acc_;
    u32 avail_;
};

// ---------------------------------------------------------------------------
// MSB-first bit reader over a byte buffer.
// ---------------------------------------------------------------------------
class IBS {
  public:
    IBS(const u8* buf, i64 len) : buf_(buf), nbits_((u64)len * 8), pos_(0) {}

    inline int readBit() { return (int)readBits(1); }

    inline u64 readBits(u32 count) {
        // count in [1..64]
        if (count > 56) {
            u64 hi = readBits(28);
            u64 lo = readBits(count - 28);
            return (hi << (count - 28)) | lo;
        }
        u64 end = pos_ + count;
        if (end > nbits_) throw Error("no more data in bitstream");
        u64 first = pos_ >> 3;
        u32 headBits = (u32)(pos_ & 7);
        u64 bufBytes = (nbits_ + 7) >> 3;
        u64 window;
        if (first + 8 <= bufBytes) {
            std::memcpy(&window, buf_ + first, 8);
            window = __builtin_bswap64(window);
        } else {
            window = 0;
            for (u64 b = first; b < bufBytes; b++)
                window |= ((u64)buf_[b]) << (56 - 8 * (b - first));
        }
        pos_ = end;
        return (window << headBits) >> (64 - count);
    }

    void readArray(u8* dst, u64 count) {
        u64 end = pos_ + count;
        if (end > nbits_) throw Error("no more data in bitstream");
        u64 nbytes = (count + 7) >> 3;
        u64 first = pos_ >> 3;
        u32 k = (u32)(pos_ & 7);
        if (k == 0) {
            std::memcpy(dst, buf_ + first, nbytes);
        } else {
            u64 bufBytes = (nbits_ + 7) >> 3;
            u64 main = (first + nbytes < bufBytes) ? nbytes
                                                   : (bufBytes - first - 1);
            const u8* p = buf_ + first;
            // dependency-free shift: auto-vectorizes
            for (u64 i = 0; i < main; i++)
                dst[i] = (u8)((p[i] << k) | (p[i + 1] >> (8 - k)));
            for (u64 i = main; i < nbytes; i++) {
                u8 lo = (first + i + 1 < bufBytes) ? p[i + 1] : 0;
                dst[i] = (u8)((p[i] << k) | (lo >> (8 - k)));
            }
        }
        u32 rem = (u32)(count & 7);
        if (rem) dst[nbytes - 1] &= (u8)(0xFF << (8 - rem));
        pos_ = end;
    }

    inline u64 read() const { return pos_; }
    inline bool hasMore() const { return pos_ < nbits_; }

  private:
    const u8* buf_;
    u64 nbits_;
    u64 pos_;
};

}  // namespace kz
