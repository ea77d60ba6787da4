#include <cmath>
#include "entropy_common.h"

namespace kz {

void computeHistogram(const u8* block, i64 len, i32* freqs) {
    std::memset(freqs, 0, 256 * sizeof(i32));
    // 4-way split to break the dependency chain
    i32 h0[256] = {0}, h1[256] = {0}, h2[256] = {0}, h3[256] = {0};
    i64 n = 0;
    for (; n + 4 <= len; n += 4) {
        h0[block[n]]++;
        h1[block[n + 1]]++;
        h2[block[n + 2]]++;
        h3[block[n + 3]]++;
    }
    for (; n < len; n++) h0[block[n]]++;
    for (int i = 0; i < 256; i++) freqs[i] = h0[i] + h1[i] + h2[i] + h3[i];
}

int encodeAlphabet(OBS& obs, const int* alphabet, int count) {
    // Full alphabet: 2 bits. Partial: 1 + 5 bits + 8*(lastMask+1) presence
    // bitmap (reference: v2/entropy/EntropyUtils.go:38-67).
    if (count > 256) throw Error("alphabet too large");
    if (count == 0) {
        obs.writeBit(0);  // FULL
        obs.writeBit(1);  // ALPHABET_0
    } else if (count == 256) {
        obs.writeBit(0);  // FULL
        obs.writeBit(0);  // ALPHABET_256
    } else {
        obs.writeBit(1);  // PARTIAL
        u8 masks[32] = {0};
        for (int i = 0; i < count; i++)
            masks[alphabet[i] >> 3] |= (u8)(1 << (alphabet[i] & 7));
        int lastMask = alphabet[count - 1] >> 3;
        obs.writeBits((u64)lastMask, 5);
        obs.writeArray(masks, 8 * (u64)(lastMask + 1));
    }
    return count;
}

int decodeAlphabet(IBS& ibs, int* alphabet) {
    if (ibs.readBit() == 0) {  // FULL
        if (ibs.readBit() == 1) return 0;
        for (int i = 0; i < 256; i++) alphabet[i] = i;
        return 256;
    }
    int lastMask = (int)ibs.readBits(5);
    u8 masks[32] = {0};
    ibs.readArray(masks, 8 * (u64)(lastMask + 1));
    int count = 0;
    for (int i = 0; i <= lastMask; i++) {
        for (int j = 0; j < 8; j++) {
            if ((masks[i] >> j) & 1) {
                if (count >= 256) throw Error("invalid alphabet");
                alphabet[count++] = i * 8 + j;
            }
        }
    }
    return count;
}

int normalizeFrequencies(i32* freqs, int freqsLen, int* alphabet, int totalFreq, int scale) {
    // Error-spreading normalization; determines ANS/Range tables so the
    // integer steps match the reference exactly
    // (v2/entropy/EntropyUtils.go:123-260).
    if (freqsLen > 256) throw Error("invalid alphabet size");
    if (scale < 256 || scale > 65536) throw Error("invalid range");
    if (freqsLen == 0 || totalFreq == 0) return 0;

    int alphabetSize = 0;
    if (totalFreq == scale) {
        for (int i = 0; i < 256; i++)
            if (freqs[i] != 0) alphabet[alphabetSize++] = i;
        return alphabetSize;
    }

    int sumScaledFreq = 0, sumFreq = 0, idxMax = 0;
    for (int i = 0; i < freqsLen; i++) {
        alphabet[i] = 0;
        int f = freqs[i];
        if (f == 0) continue;
        i64 sf = (i64)f * scale;
        int scaledFreq;
        if (sf <= totalFreq)
            scaledFreq = 1;
        else
            scaledFreq = (int)((sf + (totalFreq >> 1)) / totalFreq);
        alphabet[alphabetSize++] = i;
        sumScaledFreq += scaledFreq;
        freqs[i] = scaledFreq;
        sumFreq += f;
        if (scaledFreq > freqs[idxMax]) idxMax = i;
        if (sumFreq >= totalFreq) break;
    }

    if (alphabetSize == 0) return 0;
    if (alphabetSize == 1) {
        freqs[alphabet[0]] = scale;
        return 1;
    }
    if (sumScaledFreq == scale) return alphabetSize;

    int delta = sumScaledFreq - scale;
    int errThr = freqs[idxMax] >> 4;
    int absDelta = delta < 0 ? -delta : delta;
    int inc;
    if (absDelta <= errThr) {
        freqs[idxMax] -= delta;
        return alphabetSize;
    }
    if (delta < 0) {
        delta += errThr;
        freqs[idxMax] += errThr;
        inc = 1;
        delta = -delta;
    } else {
        delta -= errThr;
        freqs[idxMax] -= errThr;
        inc = -1;
    }

    int round = 1;
    while (round < 6 && delta > 0) {
        int adjustments = 0;
        round++;
        for (int k = 0; k < alphabetSize; k++) {
            int idx = alphabet[k];
            if (freqs[idx] <= 2) continue;  // don't distort/zero tiny freqs
            freqs[idx] += inc;
            adjustments++;
            delta--;
            if (delta == 0) break;
        }
        if (adjustments == 0) break;
    }

    freqs[idxMax] = std::max(freqs[idxMax] - delta, 1);

    // DELIBERATE divergence from the reference (EntropyUtils.go:232-258):
    // when every scaled frequency is <= 2 and the residual exceeds
    // idxMax's headroom (small near-uniform chunk at a shrunken logRange —
    // only the Range codec's fit-to-chunk scale can get here), the
    // reference exits with sum(freqs) > scale and emits a header its OWN
    // decoder rejects (RangeCodec.go:461) — compress succeeds, decompress
    // fails. Found again by the round-4 container fuzz. Repair
    // deterministically: strip the excess one step at a time from entries
    // still > 1 (never zeroing a present symbol; scale >= 256 >=
    // alphabetSize guarantees termination). Only previously-undecodable
    // headers change, so no working stream's bytes move (golden fixtures
    // unchanged).
    int sum = 0;
    for (int k = 0; k < alphabetSize; k++) sum += freqs[alphabet[k]];
    int excess = sum - scale;
    while (excess > 0) {
        int changed = 0;
        for (int k = 0; k < alphabetSize && excess > 0; k++) {
            int idx = alphabet[k];
            if (freqs[idx] > 1) {
                freqs[idx]--;
                excess--;
                changed++;
            }
        }
        if (changed == 0)
            throw Error("normalization: scale smaller than alphabet");
    }
    return alphabetSize;
}

int writeVarInt(OBS& obs, u32 value) {
    int res = 1;
    while (value >= 128) {
        obs.writeBits((u64)(0x80 | (value & 0x7F)), 8);
        value >>= 7;
        res++;
    }
    obs.writeBits((u64)value, 8);
    return res;
}

u32 readVarInt(IBS& ibs) {
    u32 res = 0;
    u32 shift = 0;
    for (int i = 0; i < 4; i++) {
        u32 value = (u32)ibs.readBits(8);
        res |= (value & 0x7F) << shift;
        if (value < 128) return res;
        shift += 7;
    }
    u32 value = (u32)ibs.readBits(8);
    return res | ((value & 0x0F) << 28);
}

ExpGolombEncoder::ExpGolombEncoder(OBS& obs, bool signed_) : obs_(obs) {
    // cache[v] = (bit count << 9) | bit pattern
    cache_[0] = 0;
    for (int v = 1; v < 256; v++) {
        if (!signed_) {
            // the reference table mirrors for v > 127: codes abs(int8(v))
            int sv = (i8)v;
            u32 a = (u32)(sv < 0 ? -sv : sv);  // abs(-128) = 128
            if (v == 128) a = 128;
            u32 log2v = log2_32(a + 1);
            u32 len = 2 * log2v + 1;
            u32 bits = a + 1;  // log2v zeros then binary(a+1)
            cache_[v] = (len << 9) | bits;
        } else {
            int sv = (i8)v;
            u32 a = (u32)(sv < 0 ? -sv : sv);
            u32 log2v = log2_32(a + 1);
            u32 len = 2 * log2v + 2;
            u32 val = ((a + 1 - (1u << log2v)) << 1) | (u32)(sv < 0 ? 1 : 0);
            u32 bits = (1u << (log2v + 1)) | val;
            cache_[v] = (len << 9) | bits;
        }
    }
}

void ExpGolombEncoder::encodeByte(u8 val) {
    if (val == 0) {
        obs_.writeBit(1);
        return;
    }
    u32 emit = cache_[val];
    obs_.writeBits((u64)(emit & 0x1FF), emit >> 9);
}

u8 ExpGolombDecoder::decodeByte() {
    if (ibs_.readBit() == 1) return 0;
    u32 log2v = 1;
    while (ibs_.readBit() == 0) log2v++;
    log2v &= 7;  // clamp, no corruption detection (matches reference)
    if (signed_) {
        u32 val = (u32)ibs_.readBits(log2v + 1);
        u32 res = (val >> 1) + (1u << log2v) - 1;
        if (val & 1) res = ~res + 1;
        return (u8)res;
    }
    u32 val = (u32)ibs_.readBits(log2v);
    return (u8)((1u << log2v) - 1 + val);
}

}  // namespace kz

namespace kz {

static const int INV_EXP[33] = {
    0, 8, 22, 47, 88, 160, 283, 492,
    848, 1451, 2459, 4117, 6766, 10819, 16608, 24127,
    32768, 41409, 48928, 54717, 58770, 61419, 63077, 64085,
    64688, 65044, 65253, 65376, 65448, 65489, 65514, 65528,
    65536,
};

struct SquashStretch {
    i32 squash[4096];
    i32 stretch[4096];
    SquashStretch() {
        for (int x = -2047; x <= 2047; x++) {
            int w = x & 127;
            int y = (x >> 7) + 16;
            squash[x + 2047] = (INV_EXP[y] * (128 - w) + INV_EXP[y + 1] * w) >> 11;
        }
        squash[4095] = 4095;
        int pi = 0;
        for (int x = -2047; x <= 2047; x++) {
            int i = squash[x + 2047];
            while (pi <= i) stretch[pi++] = x;
        }
        stretch[4095] = 2047;
    }
};

static const SquashStretch& sqst() {
    static SquashStretch t;
    return t;
}

const i32* squashTable() { return sqst().squash; }
const i32* stretchTable() { return sqst().stretch; }

}  // namespace kz

namespace kz {

// Integer log2 tables and first-order entropy estimation
// (reference: v2/internal/Global.go:59-214); used in transform decisions,
// so the integer arithmetic is format-visible.
struct Log2Table {
    u32 log2_4096[257];
    Log2Table() {
        log2_4096[0] = 0;
        for (int x = 1; x <= 256; x++)
            log2_4096[x] = (u32)(4096.0 * std::log2((double)x) + 0.5);
    }
};

static const Log2Table& l2t() {
    static Log2Table t;
    return t;
}

u32 log2Scaled1024(u32 x) {
    if (x < 256) return (l2t().log2_4096[x] + 2) >> 2;
    u32 log = log2_32(x);
    if ((x & (x - 1)) == 0) return log << 10;
    return ((log - 7) * 1024) + ((l2t().log2_4096[x >> (log - 7)] + 2) >> 2);
}

i32 firstOrderEntropy1024(i64 blockLen, const i32* histo) {
    if (blockLen == 0) return 0;
    u64 sum = 0;
    u32 logLength1024 = log2Scaled1024((u32)blockLen);
    for (int i = 0; i < 256; i++) {
        if (histo[i] == 0) continue;
        u32 log1024 = log2Scaled1024((u32)histo[i]);
        sum += (((u64)histo[i] * (u64)(logLength1024 - log1024)) >> 3);
    }
    return (i32)(sum / (u64)blockLen);
}

}  // namespace kz
