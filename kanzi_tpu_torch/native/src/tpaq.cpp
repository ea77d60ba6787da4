// TPAQ/TPAQX context-mixing bit predictor (Tangelo/PAQ lineage).
//
// Format spec: reference v2/entropy/TPAQPredictor.go, AdaptiveProbMap.go.
// 256-state bit-history FSMs over 7-8 hashed contexts, an LZ-like match
// model over a ring buffer, a per-context 8-input integer neural mixer with
// decaying learn rate, and 1-2 logistic APM/SSE stages. Table sizes scale
// with the block size (x4 in TPAQX).
//
// The numeric tables (state transitions, state->prediction map, match
// prediction curve) are format constants shared with the reference.
//
// All integer arithmetic is carried out with wrap-around (via u32) to match
// Go's defined int32 overflow semantics.

#include <memory>

#include "entropy_common.h"

namespace kz {

static constexpr i32 TPAQ_MAX_LENGTH = 88;
static constexpr i32 TPAQ_BUFFER_SIZE = 64 * 1024 * 1024;
static constexpr i32 TPAQ_HASH_SIZE = 16 * 1024 * 1024;
static constexpr i32 MASK_80808080 = (i32)0x80808080;
static constexpr i32 MASK_F0F0F000 = (i32)0xF0F0F000;
static constexpr i32 MASK_4F4FFFFF = (i32)0x4F4FFFFF;
static constexpr i32 MASK_FFFF0000 = (i32)0xFFFF0000;
static constexpr i32 TPAQ_HASH = 0x7FEB352D;
static constexpr i32 BEGIN_LEARN_RATE = 60 << 7;
static constexpr i32 END_LEARN_RATE = 11 << 7;

static const u8 STATE_TRANSITIONS[2][256] = {
    // bit 0
    {
        1, 3, 143, 4, 5, 6, 7, 8, 9, 10,
        11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
        31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
        51, 52, 47, 54, 55, 56, 57, 58, 59, 60,
        61, 62, 63, 64, 65, 66, 67, 68, 69, 6,
        71, 71, 71, 61, 75, 56, 77, 78, 77, 80,
        81, 82, 83, 84, 85, 86, 87, 88, 77, 90,
        91, 92, 80, 94, 95, 96, 97, 98, 99, 90,
        101, 94, 103, 101, 102, 104, 107, 104, 105, 108,
        111, 112, 113, 114, 115, 116, 92, 118, 94, 103,
        119, 122, 123, 94, 113, 126, 113, 128, 129, 114,
        131, 132, 112, 134, 111, 134, 110, 134, 134, 128,
        128, 142, 143, 115, 113, 142, 128, 148, 149, 79,
        148, 142, 148, 150, 155, 149, 157, 149, 159, 149,
        131, 101, 98, 115, 114, 91, 79, 58, 1, 170,
        129, 128, 110, 174, 128, 176, 129, 174, 179, 174,
        176, 141, 157, 179, 185, 157, 187, 188, 168, 151,
        191, 192, 188, 187, 172, 175, 170, 152, 185, 170,
        176, 170, 203, 148, 185, 203, 185, 192, 209, 188,
        211, 192, 213, 214, 188, 216, 168, 84, 54, 54,
        221, 54, 55, 85, 69, 63, 56, 86, 58, 230,
        231, 57, 229, 56, 224, 54, 54, 66, 58, 54,
        61, 57, 222, 78, 85, 82, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0,
    },
    // bit 1
    {
        2, 163, 169, 163, 165, 89, 245, 217, 245, 245,
        233, 244, 227, 74, 221, 221, 218, 226, 243, 218,
        238, 242, 74, 238, 241, 240, 239, 224, 225, 221,
        232, 72, 224, 228, 223, 225, 238, 73, 167, 76,
        237, 234, 231, 72, 31, 63, 225, 237, 236, 235,
        53, 234, 53, 234, 229, 219, 229, 233, 232, 228,
        226, 72, 74, 222, 75, 220, 167, 57, 218, 70,
        168, 72, 73, 74, 217, 76, 167, 79, 79, 166,
        162, 162, 162, 162, 165, 89, 89, 165, 89, 162,
        93, 93, 93, 161, 100, 93, 93, 93, 93, 93,
        161, 102, 120, 104, 105, 106, 108, 106, 109, 110,
        160, 134, 108, 108, 126, 117, 117, 121, 119, 120,
        107, 124, 117, 117, 125, 127, 124, 139, 130, 124,
        133, 109, 110, 135, 110, 136, 137, 138, 127, 140,
        141, 145, 144, 124, 125, 146, 147, 151, 125, 150,
        127, 152, 153, 154, 156, 139, 158, 139, 156, 139,
        130, 117, 163, 164, 141, 163, 147, 2, 2, 199,
        171, 172, 173, 177, 175, 171, 171, 178, 180, 172,
        181, 182, 183, 184, 186, 178, 189, 181, 181, 190,
        193, 182, 182, 194, 195, 196, 197, 198, 169, 200,
        201, 202, 204, 180, 205, 206, 207, 208, 210, 194,
        212, 184, 215, 193, 184, 208, 193, 163, 219, 168,
        94, 217, 223, 224, 225, 76, 227, 217, 229, 219,
        79, 86, 165, 217, 214, 225, 216, 216, 234, 75,
        214, 237, 74, 74, 163, 217, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0,
    },
};

static const i32 STATE_MAP[256] = {
    -31, -400, 406, -547, -642, -743, -827, -901,
    -901, -974, -945, -955, -1060, -1031, -1044, -956,
    -994, -1035, -1147, -1069, -1111, -1145, -1096, -1084,
    -1171, -1199, -1062, -1498, -1199, -1199, -1328, -1405,
    -1275, -1248, -1167, -1448, -1441, -1199, -1357, -1160,
    -1437, -1428, -1238, -1343, -1526, -1331, -1443, -2047,
    -2047, -2044, -2047, -2047, -2047, -232, -414, -573,
    -517, -768, -627, -666, -644, -740, -721, -829,
    -770, -963, -863, -1099, -811, -830, -277, -1036,
    -286, -218, -42, -411, 141, -1014, -1028, -226,
    -469, -540, -573, -581, -594, -610, -628, -711,
    -670, -144, -408, -485, -464, -173, -221, -310,
    -335, -375, -324, -413, -99, -179, -105, -150,
    -63, -9, 56, 83, 119, 144, 198, 118,
    -42, -96, -188, -285, -376, 107, -138, 38,
    -82, 186, -114, -190, 200, 327, 65, 406,
    108, -95, 308, 171, -18, 343, 135, 398,
    415, 464, 514, 494, 508, 519, 92, -123,
    343, 575, 585, 516, -7, -156, 209, 574,
    613, 621, 670, 107, 989, 210, 961, 246,
    254, -12, -108, 97, 281, -143, 41, 173,
    -209, 583, -55, 250, 354, 558, 43, 274,
    14, 488, 545, 84, 528, 519, 587, 634,
    663, 95, 700, 94, -184, 730, 742, 162,
    -10, 708, 692, 773, 707, 855, 811, 703,
    790, 871, 806, 9, 867, 840, 990, 1023,
    1409, 194, 1397, 183, 1462, 178, -23, 1403,
    247, 172, 1, -32, -170, 72, -508, -46,
    -365, -26, -146, 101, -18, -163, -422, -461,
    -146, -69, -78, -319, -334, -232, -99, 0,
    47, -74, 0, -452, 14, -57, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1,
};

static const i32 MATCH_PRED[TPAQ_MAX_LENGTH] = {
    0, 64, 128, 192, 256, 320, 384, 448,
    512, 576, 640, 704, 768, 832, 896, 960,
    1024, 1038, 1053, 1067, 1082, 1096, 1111, 1125,
    1139, 1154, 1168, 1183, 1197, 1211, 1226, 1240,
    1255, 1269, 1284, 1298, 1312, 1327, 1341, 1356,
    1370, 1385, 1399, 1413, 1428, 1442, 1457, 1471,
    1486, 1500, 1514, 1529, 1543, 1558, 1572, 1586,
    1601, 1615, 1630, 1644, 1659, 1673, 1687, 1702,
    1716, 1731, 1745, 1760, 1774, 1788, 1803, 1817,
    1832, 1846, 1861, 1875, 1889, 1904, 1918, 1933,
    1947, 1961, 1976, 1990, 2005, 2019, 2034, 2047,
};

static inline i32 mul32(i32 a, i32 b) { return (i32)((u32)a * (u32)b); }

static inline i32 hashTPAQ(i32 x, i32 y) {
    i32 h = mul32(x, TPAQ_HASH) ^ mul32(y, TPAQ_HASH);
    return (h >> 1) ^ (h >> 9) ^ (x >> 2) ^ (y >> 3) ^ TPAQ_HASH;
}

static inline i32 createContext(i32 ctxID, i32 cx) {
    u32 c = (u32)cx * 987654323u + (u32)ctxID;
    c = (c << 16) | (c >> 16);
    return (i32)(c * 123456791u + (u32)ctxID);  // wrap-add, no signed overflow
}

// Logistic adaptive probability map (SSE stage)
class LogisticAPM {
  public:
    LogisticAPM(int n, u32 rate) : rate_(rate), index_(0) {
        data_.resize((size_t)n * 33);
        for (int j = 0; j <= 32; j++)
            data_[j] = (u16)(kzSquash((j - 16) * 128) << 4);
        for (int i = 1; i < n; i++)
            std::memcpy(&data_[(size_t)i * 33], &data_[0], 33 * sizeof(u16));
        gradient_[0] = 0;
        gradient_[1] = 65528 + (1 << rate_);
    }

    int get(int bit, int pr, int ctx) {
        int g = gradient_[bit];
        data_[index_ + 1] = (u16)(data_[index_ + 1] + ((g - data_[index_ + 1]) >> rate_));
        data_[index_] = (u16)(data_[index_] + ((g - data_[index_]) >> rate_));
        pr = stretchTable()[pr];
        index_ = ((pr + 2048) >> 7) + 33 * ctx;
        int w = pr & 127;
        return ((int)data_[index_ + 1] * w + (int)data_[index_] * (128 - w)) >> 11;
    }

  private:
    std::vector<u16> data_;
    u32 rate_;
    int index_;
    int gradient_[2];
};

struct TPAQMixer {
    int pr;
    i32 skew;
    i32 w[8];
    i32 p[8];
    i32 learnRate;

    void init() {
        pr = 2048;
        skew = 0;
        for (int i = 0; i < 8; i++) w[i] = 32768;
        for (int i = 0; i < 8; i++) p[i] = 0;  // the reference zero-inits;
        // update() may read p[] before the mixer's first get() when the
        // active mixer switches, so stale inputs change the bitstream
        learnRate = BEGIN_LEARN_RATE;
    }

    inline void update(int bit) {
        // product fits in i32 (|diff| < 4096, learnRate <= 7680)
        i32 err = (i32)(((i64)((bit << 12) - pr) * learnRate) >> 10);
        if (err == 0) return;
        learnRate += ((END_LEARN_RATE - learnRate) >> 31);
        skew += err;
        for (int i = 0; i < 8; i++) w[i] += (i32)(((i64)p[i] * err) >> 12);
    }

    inline int get(i32 p0, i32 p1, i32 p2, i32 p3, i32 p4, i32 p5, i32 p6, i32 p7) {
        p[0] = p0; p[1] = p1; p[2] = p2; p[3] = p3;
        p[4] = p4; p[5] = p5; p[6] = p6; p[7] = p7;
        i32 sum = (i32)((u32)mul32(w[0], p0) + (u32)mul32(w[1], p1) +
                        (u32)mul32(w[2], p2) + (u32)mul32(w[3], p3) +
                        (u32)mul32(w[4], p4) + (u32)mul32(w[5], p5) +
                        (u32)mul32(w[6], p6) + (u32)mul32(w[7], p7) +
                        (u32)skew + 65536u);
        pr = kzSquash(sum >> 17);
        return pr;
    }
};

class TPAQMixer;  // fwd (defined above)

struct TPAQPools {
    std::vector<u8> big, small0, small1, buf;
    std::vector<i32> hashes;
    std::vector<TPAQMixer> mixers;
};

static TPAQPools& tpaqPools() {
    static thread_local TPAQPools p;
    return p;
}

class TPAQPredictor {
  public:
    TPAQPredictor(const Ctx& ctx, bool extra) : extra_(extra) {
        u32 statesSize = 1u << 28;
        u32 mixersSize = 1u << 12;
        u32 hashSize = TPAQ_HASH_SIZE;
        u32 extraMem = extra ? 1 : 0;
        u32 bufferSize = TPAQ_BUFFER_SIZE;

        u32 rbsz = ctx.blockSize > 0 ? (u32)ctx.blockSize : 32768;
        if (rbsz >= 64u * 1024 * 1024) statesSize = 1u << 28;
        else if (rbsz >= 16u * 1024 * 1024) statesSize = 1u << 27;
        else if (rbsz >= 4u * 1024 * 1024) statesSize = 1u << 26;
        else if (rbsz >= 1024u * 1024) statesSize = 1u << 24;
        else statesSize = 1u << 22;

        u32 absz = ctx.size > 0 ? (u32)ctx.size : rbsz;
        if (absz >= 32u * 1024 * 1024) mixersSize = 1u << 16;
        else if (absz >= 16u * 1024 * 1024) mixersSize = 1u << 15;
        else if (absz >= 8u * 1024 * 1024) mixersSize = 1u << 14;
        else if (absz >= 4u * 1024 * 1024) mixersSize = 1u << 13;
        else if (absz >= 1024u * 1024) mixersSize = 1u << 11;
        else mixersSize = 1u << 8;

        bufferSize = std::min(bufferSize, rbsz);
        u32 mxsz = (absz < (1u << 26)) ? absz * 16 : (1u << 30);
        hashSize = std::min(hashSize, mxsz);

        mixersSize <<= (2 * extraMem);
        statesSize <<= (2 * extraMem);
        hashSize <<= (2 * extraMem);
        // The 1 GiB cap ("java compatibility") only applies to v6+ streams:
        // TPAQPredictor.go:322-324 caps only when bsVersion > 5, so a v5
        // stream with extra memory keeps the uncapped table and would
        // mis-decode if we capped it here.  bsVersion==0 means "not set"
        // (writer side / default ctx) and behaves as current-version.
        if (ctx.bsVersion == 0 || ctx.bsVersion > 5)
            hashSize = std::min(hashSize, 1024u * 1024 * 1024);

        // All large tables come from a thread-local grow-only pool: the
        // predictor is rebuilt per block, and repeated fresh allocations of
        // ~300 MB would pay the (very slow on this host) first-touch fault
        // cost every block. Pooled pages are faulted once per thread; the
        // per-block re-init below is a plain warm memset.
        TPAQPools& pools = tpaqPools();
        auto grow8 = [](std::vector<u8>& v, size_t n) -> u8* {
            hugePoolGrow(v, n);  // hashed-context tables: hugepages cut the
                                 // per-access TLB walk on the ~GB tables
            std::memset(v.data(), 0, n);
            return v.data();
        };
        if (pools.mixers.size() < mixersSize) pools.mixers.resize(mixersSize);
        mixers_ = pools.mixers.data();
        for (u32 i = 0; i < mixersSize; i++) mixers_[i].init();
        mixer_ = &mixers_[0];
        pr_ = 2048;
        c0_ = 1;
        bpos_ = 8;
        bigStatesMap_ = grow8(pools.big, statesSize);
        smallStatesMap0_ = grow8(pools.small0, 1u << 16);
        smallStatesMap1_ = grow8(pools.small1, 1u << 24);
        hashes_ = hugePoolGrow(pools.hashes, (size_t)hashSize);
        std::memset(hashes_, 0, (size_t)hashSize * sizeof(i32));
        buffer_ = grow8(pools.buf, bufferSize);
        statesMask_ = (i32)(statesSize - 1);
        mixersMask_ = (i32)(mixersSize - 1) & ~1;
        hashMask_ = (i32)(hashSize - 1);
        bufferMask_ = (i32)(bufferSize - 1);
        cp0_ = &smallStatesMap0_[0];
        cp1_ = &smallStatesMap1_[0];
        cp2_ = cp3_ = cp4_ = cp5_ = cp6_ = &bigStatesMap_[0];

        if (extra_) {
            sse0_ = std::make_unique<LogisticAPM>(256, 6);
            sse1_ = std::make_unique<LogisticAPM>(65536, 7);
        } else {
            sse0_ = std::make_unique<LogisticAPM>(256, 7);
        }
    }

    inline int get() const { return pr_; }

    void update(int bit) {
        mixer_->update(bit);
        c0_ += c0_ + (i32)bit;
        bpos_--;

        if (bpos_ == 0) {
            buffer_[pos_ & bufferMask_] = (u8)c0_;
            pos_++;
            c8_ = (i32)(((u32)c8_ << 8) | ((u32)(c4_ >> 24) & 0xFF));
            c4_ = (i32)(((u32)c4_ << 8) | ((u32)c0_ & 0xFF));
            hash_ = (i32)(((u32)(mul32(hash_, TPAQ_HASH)) << 4) + (u32)c4_) & hashMask_;
            c0_ = 1;
            bpos_ = 8;
            binCount_ += (c4_ >> 7) & 1;

            if (matchLen_ != 0)
                mixer_ = &mixers_[(c4_ & mixersMask_) + 1];
            else
                mixer_ = &mixers_[c4_ & mixersMask_];

            ctx0_ = (c4_ & 0xFF) << 8;
            ctx1_ = (c4_ & 0xFFFF) << 8;
            ctx2_ = createContext(2, c4_ & 0x00FFFFFF);
            ctx3_ = createContext(3, c4_);

            if (binCount_ < (pos_ >> 2)) {
                // mostly text or mixed
                ctx4_ = createContext(ctx1_, c4_ ^ (c8_ & 0xFFFF));
                // Go's >> on int32 is arithmetic
                ctx5_ = (c8_ & MASK_F0F0F000) | ((c4_ & MASK_F0F0F000) >> 4);
                if (extra_) {
                    i32 h1 = ((c4_ & MASK_80808080) == 0) ? (c4_ & MASK_4F4FFFFF)
                                                          : (c4_ & MASK_80808080);
                    i32 h2 = ((c8_ & MASK_80808080) == 0) ? (c8_ & MASK_4F4FFFFF)
                                                          : (c8_ & MASK_80808080);
                    ctx6_ = hashTPAQ((i32)((u32)h1 << 2), h2 >> 2);
                }
            } else {
                // mostly binary
                ctx4_ = createContext(TPAQ_HASH + matchLen_, c4_ ^ (c4_ & 0x000FFFFF));
                ctx5_ = ctx0_ | (i32)((u32)c8_ << 16);
                if (extra_) ctx6_ = hashTPAQ(c4_ & MASK_FFFF0000, c8_ >> 16);
            }

            findMatch();
            matchVal_ = (i32)buffer_[matchPos_ & bufferMask_] | 0x100;
            hashes_[hash_] = pos_;
        }

        const u8* table = STATE_TRANSITIONS[bit];
        *cp0_ = table[*cp0_];
        *cp1_ = table[*cp1_];
        *cp2_ = table[*cp2_];
        *cp3_ = table[*cp3_];
        *cp4_ = table[*cp4_];
        *cp5_ = table[*cp5_];
        i32 c = c0_;
        cp0_ = &smallStatesMap0_[ctx0_ + c];
        i32 p0 = STATE_MAP[*cp0_];
        cp1_ = &smallStatesMap1_[ctx1_ + c];
        i32 p1 = STATE_MAP[*cp1_];
        cp2_ = &bigStatesMap_[(i32)((u32)ctx2_ + (u32)c) & statesMask_];
        i32 p2 = STATE_MAP[*cp2_];
        cp3_ = &bigStatesMap_[(i32)((u32)ctx3_ + (u32)c) & statesMask_];
        i32 p3 = STATE_MAP[*cp3_];
        cp4_ = &bigStatesMap_[(i32)((u32)ctx4_ + (u32)c) & statesMask_];
        i32 p4 = STATE_MAP[*cp4_];
        cp5_ = &bigStatesMap_[(ctx5_ ^ c) & statesMask_];
        i32 p5 = STATE_MAP[*cp5_];

        i32 p7 = 0;
        if (matchLen_ != 0) p7 = getMatchContextPred();

        int p;
        if (!extra_) {
            p = mixer_->get(p0, p1, p2, p3, p4, p5, p7, p7);
            if (binCount_ < (pos_ >> 3))
                p = (3 * sse0_->get(bit, p, (int)c0_) + p) >> 2;
        } else {
            *cp6_ = table[*cp6_];
            cp6_ = &bigStatesMap_[(i32)((u32)ctx6_ + (u32)c) & statesMask_];
            i32 p6 = STATE_MAP[*cp6_];
            p = mixer_->get(p0, p1, p2, p3, p4, p5, p6, p7);
            if (binCount_ < (pos_ >> 3)) {
                p = sse1_->get(bit, p, (int)(ctx0_ + c));
            } else {
                // In the reference the sse1 refinement applies to BOTH
                // sub-cases here; only the sse0 stage is gated on
                // binCount >= pos>>2 (v2/entropy/TPAQPredictor.go:489-497).
                if (binCount_ >= (pos_ >> 2))
                    p = (3 * sse0_->get(bit, p, (int)c0_) + p) >> 2;
                p = (3 * sse1_->get(bit, p, (int)(ctx0_ + c)) + p) >> 2;
            }
        }

        pr_ = p + (int)((u32)(p - 2048) >> 31);
    }

  private:
    void findMatch() {
        if (matchLen_ > 0) {
            if (matchLen_ < TPAQ_MAX_LENGTH) matchLen_++;
            matchPos_++;
        } else {
            matchPos_ = hashes_[hash_];
            if (matchPos_ != 0 && pos_ - matchPos_ <= bufferMask_) {
                i32 r = matchLen_ + 2;
                i32 s = pos_ - r;
                i32 t = matchPos_ - r;
                while (r <= TPAQ_MAX_LENGTH) {
                    if (buffer_[(s - 1) & bufferMask_] != buffer_[(t - 1) & bufferMask_]) break;
                    if (buffer_[s & bufferMask_] != buffer_[t & bufferMask_]) break;
                    r += 2;
                    s -= 2;
                    t -= 2;
                }
                matchLen_ = r - 2;
            }
        }
    }

    i32 getMatchContextPred() {
        i32 m = matchVal_ >> (bpos_ - 1);
        if (c0_ == (m >> 1)) {
            i32 p = MATCH_PRED[matchLen_ - 1];
            return ((m & 1) == 0) ? -p : p;
        }
        matchLen_ = 0;
        return 0;
    }

    int pr_ = 2048;
    i32 c0_ = 1, c4_ = 0, c8_ = 0;
    u32 bpos_ = 8;
    i32 pos_ = 0, binCount_ = 0;
    i32 matchLen_ = 0, matchPos_ = 0, matchVal_ = 0;
    i32 hash_ = 0;
    i32 statesMask_, mixersMask_, hashMask_, bufferMask_;
    std::unique_ptr<LogisticAPM> sse0_, sse1_;
    TPAQMixer* mixers_;
    TPAQMixer* mixer_;
    u8* buffer_;
    i32* hashes_;
    u8 *bigStatesMap_, *smallStatesMap0_, *smallStatesMap1_;
    u8 *cp0_, *cp1_, *cp2_, *cp3_, *cp4_, *cp5_, *cp6_;
    i32 ctx0_ = 0, ctx1_ = 0, ctx2_ = 0, ctx3_ = 0, ctx4_ = 0, ctx5_ = 0, ctx6_ = 0;
    bool extra_;
};

TPAQPredictor* newTPAQ(const Ctx& ctx, bool extra) { return new TPAQPredictor(ctx, extra); }
void freeTPAQ(TPAQPredictor* p) { delete p; }
int tpaqGet(TPAQPredictor* p) { return p->get(); }
void tpaqUpdate(TPAQPredictor* p, int bit) { p->update(bit); }

}  // namespace kz
