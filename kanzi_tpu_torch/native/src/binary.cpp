// Binary arithmetic coder shell for context-mixing predictors (CM/TPAQ/TPAQX)
// plus the CM predictor itself.
//
// Format spec: reference v2/entropy/BinaryEntropyCodec.go (56-bit coder,
// split = ((high-low)>>4)*pred>>8, chunked with varint byte counts and
// 56-bit resync words; coder state carries across chunks) and
// v2/entropy/CMPredictor.go (BCM-style counters: fast/medium order-1 bank +
// SSE-like run-aware bank, rates 2/4/6).
//
// Inherently bit-serial; the framework gets throughput by running many
// blocks concurrently (threads on host, lanes on chip).

#include <memory>

#include "entropy_common.h"

namespace kz {

static constexpr u64 BIN_TOP = 0x00FFFFFFFFFFFFFFull;
static constexpr u64 BMASK_0_56 = 0x00FFFFFFFFFFFFFFull;
static constexpr u64 BMASK_0_24 = 0x0000000000FFFFFFull;
static constexpr u64 BMASK_0_32 = 0x00000000FFFFFFFFull;
static constexpr i64 BIN_MAX_BLOCK = (i64)1 << 30;
static constexpr i64 BIN_MAX_CHUNK = (i64)1 << 26;

// ---------------------------------------------------------------------------
// CM predictor (reference: v2/entropy/CMPredictor.go)
// ---------------------------------------------------------------------------
class CMPredictor {
  public:
    explicit CMPredictor(const Ctx& ctx) {
        // bsVersion < 4 differences (CMPredictor.go:55,71-77,126-131):
        // counter2[16] initialized to 15<<12, and get() refines through an
        // interpolated SSE step instead of the averaged form
        isV3_ = ctx.bsVersion > 0 && ctx.bsVersion < 4;
        ctx_ = 1;
        runMask_ = 0;
        c1_ = c2_ = 0;
        idx_ = 0;
        for (int i = 0; i < 256; i++) {
            for (int j = 0; j <= 256; j++) counter1_[i][j] = 65536 >> 1;
            for (int j = 0; j < 16; j++) {
                counter2_[i + i][j] = j << 12;
                counter2_[i + i + 1][j] = j << 12;
            }
            counter2_[i + i][16] = isV3_ ? (15 << 12) : 65535;
            counter2_[i + i + 1][16] = isV3_ ? (15 << 12) : 65535;
        }
    }

    inline void update(int bit) {
        i32* pc2 = counter2_[ctx_ | runMask_];
        i32* pc1 = counter1_[ctx_];
        if (bit == 0) {
            pc1[256] -= (pc1[256] >> 2);
            pc1[c1_] -= (pc1[c1_] >> 4);
            pc2[idx_] -= (pc2[idx_] >> 6);
            pc2[idx_ + 1] -= (pc2[idx_ + 1] >> 6);
            ctx_ += ctx_;
        } else {
            pc1[256] -= ((pc1[256] - 65536 + 16) >> 2);
            pc1[c1_] -= ((pc1[c1_] - 65536 + 16) >> 4);
            pc2[idx_] -= ((pc2[idx_] - 65536 + 16) >> 6);
            pc2[idx_ + 1] -= ((pc2[idx_ + 1] - 65536 + 16) >> 6);
            ctx_ += ctx_ + 1;
        }
        if (ctx_ > 255) {
            c2_ = c1_;
            c1_ = (u8)ctx_;
            ctx_ = 1;
            runMask_ = (c1_ == c2_) ? 0x100 : 0;
        }
    }

    inline int get() {
        i32* pc2 = counter2_[ctx_ | runMask_];
        i32* pc1 = counter1_[ctx_];
        int p = (int)(13 * (pc1[256] + pc1[c1_]) + 6 * pc1[c2_]) >> 5;
        idx_ = p >> 12;
        int x2 = pc2[idx_ + 1];
        int x1 = pc2[idx_];
        if (isV3_) {
            int ssep = x1 + (((x2 - x1) * (p & 4095)) >> 12);
            return (p + 3 * ssep + 32) >> 6;  // [0..4095]
        }
        return (p + p + 3 * (x1 + x2) + 64) >> 7;  // [0..4095]
    }

  private:
    bool isV3_;
    u8 c1_, c2_;
    i32 ctx_, runMask_;
    int idx_;
    i32 counter1_[256][257];
    i32 counter2_[512][17];
};

// ---------------------------------------------------------------------------
// Coder shell
// ---------------------------------------------------------------------------
template <class P>
static void binEncode(OBS& obs, const u8* block, i64 count, P& pred) {
    if (count > BIN_MAX_BLOCK) throw Error("binary codec: block too large");
    u64 low = 0, high = BIN_TOP;
    std::vector<u8> buffer;
    i64 index = 0;

    auto flush = [&]() {
        u32 v = (u32)(high >> 24);
        buffer[index] = (u8)(v >> 24);
        buffer[index + 1] = (u8)(v >> 16);
        buffer[index + 2] = (u8)(v >> 8);
        buffer[index + 3] = (u8)v;
        index += 4;
        low <<= 32;
        high = (high << 32) | BMASK_0_32;
    };

    auto encodeBit = [&](int bit, int pr) {
        u64 split = (((high - low) >> 4) * (u64)(u32)pr) >> 8;
        if (bit == 0)
            low += split + 1;
        else
            high = low + split;
        pred.update(bit);
        if ((low ^ high) < ((u64)1 << 24)) flush();
    };

    i64 length = count;
    if (count >= BIN_MAX_CHUNK)
        length = (count < 8 * BIN_MAX_CHUNK) ? count >> 3 : count >> 4;
    else if (count < 64)
        length = 64;
    buffer.resize(length + (length >> 3) + 8);

    i64 startChunk = 0;
    while (startChunk < count) {
        i64 chunkSize = std::min(length, count - startChunk);
        const u8* buf = block + startChunk;
        index = 0;
        for (i64 i = 0; i < chunkSize; i++) {
            u8 val = buf[i];
            for (int b = 7; b >= 0; b--) encodeBit((val >> b) & 1, pred.get());
        }
        writeVarInt(obs, (u32)index);
        obs.writeArray(buffer.data(), 8 * (u64)index);
        startChunk += chunkSize;
        if (startChunk < count) obs.writeBits(low | BMASK_0_24, 56);
    }
    obs.writeBits(low | BMASK_0_24, 56);  // dispose
}

template <class P>
static void binDecode(IBS& ibs, u8* block, i64 count, P& pred) {
    if (count > BIN_MAX_BLOCK) throw Error("binary codec: block too large");
    u64 low = 0, high = BIN_TOP, current = 0;
    std::vector<u8> buffer;
    i64 index = 0;

    auto readWord = [&]() {
        low = (low << 32) & BMASK_0_56;
        high = ((high << 32) | BMASK_0_32) & BMASK_0_56;
        // structural refill bound (see fpaq.cpp): corrupted chunks read
        // zeros at the guard instead of depending on window dynamics
        u32 val = 0;
        if (index + 4 <= (i64)buffer.size()) {
            val = ((u32)buffer[index] << 24) | ((u32)buffer[index + 1] << 16) |
                  ((u32)buffer[index + 2] << 8) | buffer[index + 3];
            index += 4;
        }
        current = ((current << 32) | val) & BMASK_0_56;
    };

    auto decodeBit = [&](int pr) -> int {
        u64 split = ((((high - low) >> 4) * (u64)(u32)pr) >> 8) + low;
        int bit;
        if (split >= current) {
            bit = 1;
            high = split;
            pred.update(1);
        } else {
            bit = 0;
            low = split + 1;
            pred.update(0);
        }
        if ((low ^ high) < ((u64)1 << 24)) readWord();
        return bit;
    };

    i64 length = count;
    if (count >= BIN_MAX_CHUNK)
        length = (count < 8 * BIN_MAX_CHUNK) ? count >> 3 : count >> 4;
    else if (count < 64)
        length = 64;
    i64 bufSize = length + (length >> 3);
    buffer.resize(bufSize + 8);

    i64 startChunk = 0;
    while (startChunk < count) {
        i64 chunkSize = std::min(length, count - startChunk);
        u32 szBytes = readVarInt(ibs);
        if ((i64)szBytes > bufSize) throw Error("binary codec: invalid bitstream");
        current = ibs.readBits(56);
        std::memset(buffer.data() + szBytes, 0, 8);
        if (szBytes != 0) ibs.readArray(buffer.data(), 8 * (u64)szBytes);
        index = 0;
        u8* buf = block + startChunk;
        for (i64 i = 0; i < chunkSize; i++) {
            int val = 0;
            for (int b = 7; b >= 0; b--) val |= decodeBit(pred.get()) << b;
            buf[i] = (u8)val;
        }
        startChunk += chunkSize;
    }
}

// TPAQ predictor (tpaq.cpp)
class TPAQPredictor;
TPAQPredictor* newTPAQ(const Ctx& ctx, bool extra);
void freeTPAQ(TPAQPredictor*);
int tpaqGet(TPAQPredictor*);
void tpaqUpdate(TPAQPredictor*, int bit);

struct TPAQHandle {
    TPAQPredictor* p;
    explicit TPAQHandle(const Ctx& ctx, bool extra) : p(newTPAQ(ctx, extra)) {}
    ~TPAQHandle() { freeTPAQ(p); }
    inline int get() { return tpaqGet(p); }
    inline void update(int bit) { tpaqUpdate(p, bit); }
};

void binaryEncode(OBS& obs, const u8* block, i64 len, int predictor, const Ctx& ctx) {
    if (predictor == 0) {
        auto pred = std::make_unique<CMPredictor>(ctx);
        binEncode(obs, block, len, *pred);
    } else {
        TPAQHandle pred(ctx, predictor == 2);
        binEncode(obs, block, len, pred);
    }
}

void binaryDecode(IBS& ibs, u8* block, i64 len, int predictor, const Ctx& ctx) {
    if (predictor == 0) {
        auto pred = std::make_unique<CMPredictor>(ctx);
        binDecode(ibs, block, len, *pred);
    } else {
        TPAQHandle pred(ctx, predictor == 2);
        binDecode(ibs, block, len, pred);
    }
}

}  // namespace kz
