// Shared entropy machinery: alphabet encoding, frequency normalization,
// varints, Exp-Golomb byte codec, histograms.
//
// These routines determine the coding tables and therefore the bitstream;
// their integer arithmetic follows the reference spec exactly
// (v2/entropy/EntropyUtils.go:38-296, v2/entropy/ExpGolombCodec.go).
#pragma once

#include "kz.h"

namespace kz {

constexpr int INCOMPRESSIBLE_THRESHOLD = 973;

void computeHistogram(const u8* block, i64 len, i32* freqs);  // order 0, 256 bins

// alphabet: sorted symbol values; returns count written.
int encodeAlphabet(OBS& obs, const int* alphabet, int count);
// fills alphabet[256]; returns symbol count.
int decodeAlphabet(IBS& ibs, int* alphabet);

// Scales freqs so their sum equals `scale`; fills alphabet; returns alphabet
// size. freqs is indexed by the same indices the caller iterates (usually
// symbol value over a 256-wide array).
int normalizeFrequencies(i32* freqs, int freqsLen, int* alphabet, int totalFreq, int scale);

int writeVarInt(OBS& obs, u32 value);
u32 readVarInt(IBS& ibs);

// Exp-Golomb byte codec (signed or unsigned).
class ExpGolombEncoder {
  public:
    ExpGolombEncoder(OBS& obs, bool signed_);
    void encodeByte(u8 val);

  private:
    OBS& obs_;
    u32 cache_[256];
};

class ExpGolombDecoder {
  public:
    ExpGolombDecoder(IBS& ibs, bool signed_) : ibs_(ibs), signed_(signed_) {}
    u8 decodeByte();

  private:
    IBS& ibs_;
    bool signed_;
};

}  // namespace kz

namespace kz {
// 12-bit logistic squash/stretch tables (reference: v2/internal/Global.go:89-144)
const i32* squashTable();   // [4096]
const i32* stretchTable();  // [4096]

static inline int kzSquash(int d) {
    if (d >= 2048) return 4095;
    if (d <= -2048) return 0;
    return squashTable()[d + 2047];
}
}  // namespace kz
