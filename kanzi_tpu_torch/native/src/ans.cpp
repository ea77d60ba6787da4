// rANS order-0 / order-1 codec, 4 interleaved states (ryg_rans style).
//
// Format spec: reference v2/entropy/ANSRangeCodec.go.
// Per chunk: 3-bit logRange, then per-context alphabet + log-max-bit-packed
// frequencies (chunks of 8/6 symbols, first frequency inferred), then a
// varint payload byte count, four 32-bit final states, and the payload.
// The encoder runs the 4 states over the chunk in reverse order with
// reciprocal-multiply division; the decoder runs them forward. Order 1 uses
// 256 contexts (previous byte) with the 4 lanes starting at chunk quarters.
//
// The 4-state layout is the device-kernel vector axis (kanzi_tpu/ops/ans.py
// batches lanes across chunks); this host version is the bit-exactness
// oracle and single-chip fallback.

#include "entropy_common.h"

namespace kz {

static constexpr int ANS_TOP = 1 << 15;
static constexpr int ANS0_CHUNK_SIZE = 16384;
static constexpr int ANS_MAX_CHUNK_SIZE = 1 << 27;
static constexpr u32 ANS_DEFAULT_LOG_RANGE = 12;

struct EncSymbol {
    int xMax;
    int bias;
    int cmplFreq;
    u32 invShift;
    u64 invFreq;

    void reset(int cumFreq, int freq, u32 logRange) {
        freq = std::min(freq, (1 << logRange) - 1);
        xMax = ((ANS_TOP >> logRange) << 16) * freq;
        cmplFreq = (1 << logRange) - freq;
        if (freq < 2) {
            invFreq = 0xFFFFFFFF;
            invShift = 32;
            bias = cumFreq + (1 << logRange) - 1;
        } else {
            u32 shift = 0;
            while (freq > (1 << shift)) shift++;
            invFreq = ((((u64)1 << (shift + 31)) + (u64)(freq - 1)) / (u64)freq) & 0xFFFFFFFF;
            invShift = 32 + shift - 1;
            bias = cumFreq;
        }
    }
};

struct DecSymbol {
    int cumFreq;
    int freq;

    void reset(int cumFreq_, int freq_, u32 logRange) {
        freq = std::min(freq_, (1 << logRange) - 1);
        cumFreq = cumFreq_;
    }
};

// order-0 histogram with 257 stride (last = total)
static void histoO0Total(const u8* block, i64 len, i32* freqs) {
    computeHistogram(block, len, freqs);
    freqs[256] = (i32)len;
}

// order-1 histogram over one quarter, 257 stride, prv=0 seed
// (semantics of v2/internal/Global.go:260-303 applied per encoder lane)
static void histoO1Total(const u8* block, i64 len, i32* freqs) {
    u32 prv = 0;
    for (i64 i = 0; i < len; i++) {
        freqs[257 * prv + block[i]]++;
        freqs[257 * prv + 256]++;
        prv = block[i];
    }
}

// one chunk's stats + header: normalize per context, reset symbol tables,
// emit 3-bit logRange + per-context alphabet/frequency header. Shared by the
// host encoder and the device-engine prepare step. Returns total alphabet
// size across contexts.
static void ansEncodeHeaderOne(OBS& obs, const int* alphabet, int alphabetSize,
                               const i32* frequencies, u32 logRange) {
    encodeAlphabet(obs, alphabet, alphabetSize);
    if (alphabetSize <= 1) return;
    int chkSize = alphabetSize < 64 ? 6 : 8;
    u32 llr = 3;
    while ((1u << llr) <= logRange) llr++;
    for (int i = 1; i < alphabetSize; i += chkSize) {
        int maxv = frequencies[alphabet[i]] - 1;
        u32 logMax = 0;
        int endj = std::min(i + chkSize, alphabetSize);
        for (int j = i + 1; j < endj; j++)
            if (frequencies[alphabet[j]] - 1 > maxv) maxv = frequencies[alphabet[j]] - 1;
        while ((1 << logMax) <= maxv) logMax++;
        obs.writeBits(logMax, llr);
        if (logMax == 0) continue;
        for (int j = i; j < endj; j++)
            obs.writeBits((u64)(frequencies[alphabet[j]] - 1), logMax);
    }
}

static int ansUpdateFrequencies(OBS& obs, i32* freqs, EncSymbol* symbols,
                                int order, u32 logRange) {
    int res = 0;
    int endk = 255 * order + 1;
    obs.writeBits(logRange - 8, 3);
    int alphabet[256];
    for (int k = 0; k < endk; k++) {
        i32* f = freqs + 257 * (size_t)k;
        EncSymbol* symb = symbols + ((size_t)k << 8);
        int alphabetSize = normalizeFrequencies(f, 256, alphabet, f[256], 1 << logRange);
        if (alphabetSize > 0) {
            int sum = 0;
            for (int i = 0, count = 0; i < 256; i++) {
                if (f[i] == 0) continue;
                symb[i].reset(sum, f[i], logRange);
                sum += f[i];
                count++;
                if (count >= alphabetSize) break;
            }
        }
        ansEncodeHeaderOne(obs, alphabet, alphabetSize, f, logRange);
        res += alphabetSize;
    }
    return res;
}

static void ansHistogram(const u8* block, i64 len, i32* freqs, int order) {
    if (order == 0) {
        histoO0Total(block, len, freqs);
    } else {
        i64 quarter = len >> 2;
        if (quarter == 0) {
            histoO1Total(block, len, freqs);
        } else {
            for (int q = 0; q < 4; q++)
                histoO1Total(block + q * quarter, quarter, freqs);
        }
    }
}

class ANSEncoder {
  public:
    // chunkSizeArg <= 0 selects the default (16 KiB; x256 for order 1)
    ANSEncoder(OBS& obs, int order, int chunkSizeArg = 0)
        : obs_(obs), order_(order) {
        int cs = chunkSizeArg > 0 ? chunkSizeArg : ANS0_CHUNK_SIZE;
        if (order == 1) cs = std::min(cs << 8, ANS_MAX_CHUNK_SIZE);
        chunkSize_ = cs;
        logRange_ = std::max(ANS_DEFAULT_LOG_RANGE - (u32)order, 8u);
        int dim = 255 * order + 1;
        freqs_.resize((size_t)dim * 257);
        symbols_.resize((size_t)dim * 256);
    }

    void write(const u8* block, i64 len) {
        if (len <= 32) {
            obs_.writeArray(block, 8 * (u64)len);
            return;
        }
        i64 size = std::min(2 * len, (i64)(chunkSize_ + (chunkSize_ >> 3)));
        size = std::max(size, (i64)65536);
        buffer_.resize(size);
        i64 startChunk = 0;
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)chunkSize_, len);
            int alphabetSize = rebuildStatistics(block + startChunk, endChunk - startChunk);
            if (order_ == 1 || alphabetSize > 1)
                encodeChunk(block + startChunk, (int)(endChunk - startChunk));
            startChunk = endChunk;
        }
    }

  private:
    int rebuildStatistics(const u8* block, i64 len) {
        std::fill(freqs_.begin(), freqs_.end(), 0);
        ansHistogram(block, len, freqs_.data(), order_);
        return ansUpdateFrequencies(obs_, freqs_.data(), symbols_.data(),
                                    order_, logRange_);
    }

    inline void encodeSymbol(i64& n, int& st, const EncSymbol& sym) {
        int x = (st >= sym.xMax) ? 1 : 0;
        buffer_[n] = (u8)st;
        n -= x;
        buffer_[n] = (u8)(st >> 8);
        n -= x;
        st >>= (-x & 16);
        st = st + sym.bias + (int)(((u64)st * sym.invFreq) >> sym.invShift) * sym.cmplFreq;
    }

    void encodeChunk(const u8* block, int len) {
        int st0 = ANS_TOP, st1 = ANS_TOP, st2 = ANS_TOP, st3 = ANS_TOP;
        i64 n = (i64)buffer_.size() - 1;
        int end4 = len & ~3;

        for (int i = len - 1; i >= end4; i--) buffer_[n--] = block[i];

        if (order_ == 0) {
            const EncSymbol* symb = symbols_.data();
            for (int i = end4 - 1; i > 0; i -= 4) {
                encodeSymbol(n, st0, symb[block[i]]);
                encodeSymbol(n, st1, symb[block[i - 1]]);
                encodeSymbol(n, st2, symb[block[i - 2]]);
                encodeSymbol(n, st3, symb[block[i - 3]]);
            }
        } else if (len > 1) {
            int quarter = end4 >> 2;
            // 2-3 byte order-1 chunks index block[-1] in the reference
            // (ANSRangeCodec.go:353-357 panics); raise a clean error instead
            // of reading out of bounds
            if (quarter == 0) throw Error("invalid ANS1 chunk size");
            int i0 = 1 * quarter - 2, i1 = 2 * quarter - 2, i2 = 3 * quarter - 2,
                i3 = end4 - 2;
            int prv0 = block[i0 + 1], prv1 = block[i1 + 1], prv2 = block[i2 + 1],
                prv3 = block[i3 + 1];
            while (i0 >= 0) {
                int cur0 = block[i0];
                encodeSymbol(n, st0, symbols_[(cur0 << 8) | prv0]);
                int cur1 = block[i1];
                encodeSymbol(n, st1, symbols_[(cur1 << 8) | prv1]);
                int cur2 = block[i2];
                encodeSymbol(n, st2, symbols_[(cur2 << 8) | prv2]);
                int cur3 = block[i3];
                encodeSymbol(n, st3, symbols_[(cur3 << 8) | prv3]);
                prv0 = cur0;
                prv1 = cur1;
                prv2 = cur2;
                prv3 = cur3;
                i0--;
                i1--;
                i2--;
                i3--;
            }
            encodeSymbol(n, st0, symbols_[prv0]);
            encodeSymbol(n, st1, symbols_[prv1]);
            encodeSymbol(n, st2, symbols_[prv2]);
            encodeSymbol(n, st3, symbols_[prv3]);
        }

        n++;
        writeVarInt(obs_, (u32)((i64)buffer_.size() - n));
        obs_.writeBits((u64)(u32)st0, 32);
        obs_.writeBits((u64)(u32)st1, 32);
        obs_.writeBits((u64)(u32)st2, 32);
        obs_.writeBits((u64)(u32)st3, 32);
        if ((i64)buffer_.size() != n)
            obs_.writeArray(buffer_.data() + n, 8 * (u64)((i64)buffer_.size() - n));
    }

    OBS& obs_;
    int order_;
    int chunkSize_;
    u32 logRange_;
    std::vector<i32> freqs_;
    std::vector<EncSymbol> symbols_;
    std::vector<u8> buffer_;
};

// One chunk's decode tables from the bitstream: 3-bit logRange + per-context
// alphabet/frequency headers -> freq->symbol map + (cumFreq, freq) tables.
// Shared by the host decoder and the device-engine decode prepare.
static int ansDecodeHeaderTables(IBS& ibs, int order, u32& logRange,
                                 i32* freqs, DecSymbol* symbols,
                                 std::vector<u8>& f2s, int* alphabet) {
    logRange = 8 + (u32)ibs.readBits(3);
    if (logRange > 16) throw Error("invalid ANS range");
    int res = 0;
    int dim = 255 * order + 1;
    int scale = 1 << logRange;
    f2s.resize((size_t)dim * scale);
    u32 llr = 3;
    while ((1u << llr) <= logRange) llr++;
    for (int k = 0; k < dim; k++) {
        int alphabetSize = decodeAlphabet(ibs, alphabet);
        if (alphabetSize == 0) continue;
        i32* f = freqs + ((size_t)k << 8);
        if (alphabetSize != 256) std::memset(f, 0, 256 * sizeof(i32));
        int chkSize = alphabetSize < 64 ? 6 : 8;
        int sum = 0;
        for (int i = 1; i < alphabetSize; i += chkSize) {
            u32 logMax = (u32)ibs.readBits(llr);
            if (((i64)1 << logMax) > scale) throw Error("invalid ANS frequency size");
            int endj = std::min(i + chkSize, alphabetSize);
            for (int j = i; j < endj; j++) {
                int freq = 1;
                if (logMax > 0) {
                    freq = 1 + (int)ibs.readBits(logMax);
                    if (freq <= 0 || freq >= scale) throw Error("invalid ANS frequency");
                }
                f[alphabet[j]] = freq;
                sum += freq;
            }
        }
        if (scale <= sum) throw Error("invalid ANS frequency sum");
        f[alphabet[0]] = scale - sum;
        sum = 0;
        DecSymbol* symb = symbols + ((size_t)k << 8);
        u8* freq2sym = f2s.data() + ((size_t)k << logRange);
        for (int i = 0; i < 256; i++) {
            if (f[i] == 0) continue;
            for (int j = f[i] - 1; j >= 0; j--) freq2sym[sum + j] = (u8)i;
            symb[i].reset(sum, f[i], logRange);
            sum += f[i];
        }
        res += alphabetSize;
    }
    return res;
}

class ANSDecoder {
  public:
    ANSDecoder(IBS& ibs, int order, int chunkSizeArg = 0, int bsVersion = 6)
        : ibs_(ibs), order_(order), bsVersion_(bsVersion) {
        // Prior to bitstream v4 the default chunk size was 32768
        // (ANSRangeCodec.go:560-563)
        int cs = chunkSizeArg > 0 ? chunkSizeArg
                 : (bsVersion > 0 && bsVersion < 4 ? 32768 : ANS0_CHUNK_SIZE);
        if (order == 1) cs = std::min(cs << 8, ANS_MAX_CHUNK_SIZE);
        chunkSize_ = cs;
        logRange_ = ANS_DEFAULT_LOG_RANGE;
        int dim = 255 * order + 1;
        freqs_.resize((size_t)dim * 256);
        symbols_.resize((size_t)dim * 256);
    }

    void read(u8* block, i64 len) {
        if (len <= 32) {
            ibs_.readArray(block, 8 * (u64)len);
            return;
        }
        i64 startChunk = 0;
        int alphabet[256];
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)chunkSize_, len);
            int alphabetSize = decodeHeader(alphabet);
            if (alphabetSize == 0) throw Error("invalid ANS header");
            if (order_ == 0 && alphabetSize == 1) {
                std::memset(block + startChunk, alphabet[0], endChunk - startChunk);
            } else if (bsVersion_ == 1) {
                decodeChunkV1(block + startChunk, (int)(endChunk - startChunk));
            } else {
                if (!decodeChunk(block + startChunk, (int)(endChunk - startChunk)))
                    throw Error("invalid ANS chunk size");
            }
            startChunk = endChunk;
        }
    }

  private:
    int decodeHeader(int* alphabet) {
        return ansDecodeHeaderTables(ibs_, order_, logRange_, freqs_.data(),
                                     symbols_.data(), f2s_, alphabet);
    }

    inline void decodeSymbol(i64& n, int& st, const DecSymbol& sym, int mask) {
        st = sym.freq * (st >> logRange_) + (st & mask) - sym.cumFreq;
        if (st < ANS_TOP) {
            // u32 shift: st can be negative on corrupted input, and a signed
            // left shift of a negative value is UB (caught by UBSAN fuzz)
            st = (int)(((u32)st << 16) | ((u32)buffer_[n] << 8) | buffer_[n + 1]);
            n += 2;
        }
    }

    // Bitstream v1 chunk layout (ANSRangeCodec.go:759-843): two interleaved
    // states for order 0 (one for order 1), renormalization pulls byte
    // PAIRS while the state is below 2^15, odd tail byte stored raw at the
    // end of the renorm buffer.
    void decodeChunkV1(u8* block, int len) {
        u32 sz = readVarInt(ibs_) & (ANS_MAX_CHUNK_SIZE - 1);
        int st0 = (int)ibs_.readBits(32);
        int st1 = 0;
        if (order_ == 0) st1 = (int)ibs_.readBits(32);
        if (sz == 0) return;
        if ((i64)buffer_.size() < (i64)sz + ((i64)sz >> 3) + 64)
            buffer_.resize((size_t)sz + (sz >> 3) + 64);
        ibs_.readArray(buffer_.data(), 8 * (u64)sz);
        std::memset(buffer_.data() + sz, 0,
                    std::min((size_t)64, buffer_.size() - sz));

        i64 n = 0;
        u32 lr = logRange_;
        int mask = (1 << lr) - 1;

        if (order_ == 0) {
            const u8* freq2sym = f2s_.data();
            const DecSymbol* symb = symbols_.data();
            int end2 = (len & ~1) - 1;
            for (int i = 0; i < end2; i += 2) {
                u8 cur1 = freq2sym[st1 & mask];
                block[i] = cur1;
                const DecSymbol& sym1 = symb[cur1];
                u8 cur0 = freq2sym[st0 & mask];
                block[i + 1] = cur0;
                const DecSymbol& sym0 = symb[cur0];
                st1 = sym1.freq * (st1 >> lr) + (st1 & mask) - sym1.cumFreq;
                st0 = sym0.freq * (st0 >> lr) + (st0 & mask) - sym0.cumFreq;
                while ((u32)st1 < (u32)ANS_TOP && n + 1 < (i64)buffer_.size()) {
                    st1 = (int)(((u32)st1 << 8) | buffer_[n]);
                    st1 = (int)(((u32)st1 << 8) | buffer_[n + 1]);
                    n += 2;
                }
                while ((u32)st0 < (u32)ANS_TOP && n + 1 < (i64)buffer_.size()) {
                    st0 = (int)(((u32)st0 << 8) | buffer_[n]);
                    st0 = (int)(((u32)st0 << 8) | buffer_[n + 1]);
                    n += 2;
                }
            }
            if (len & 1) block[len - 1] = buffer_[sz - 1];
        } else {
            int prv = 0;
            for (int i = 0; i < len; i++) {
                u8 cur = f2s_[((size_t)prv << lr) + (st0 & mask)];
                block[i] = cur;
                const DecSymbol& sym = symbols_[(prv << 8) + cur];
                st0 = sym.freq * (st0 >> lr) + (st0 & mask) - sym.cumFreq;
                while ((u32)st0 < (u32)ANS_TOP && n + 1 < (i64)buffer_.size()) {
                    st0 = (int)(((u32)st0 << 8) | buffer_[n]);
                    st0 = (int)(((u32)st0 << 8) | buffer_[n + 1]);
                    n += 2;
                }
                prv = cur;
            }
        }
    }

    bool decodeChunk(u8* block, int len) {
        u32 sz = readVarInt(ibs_);
        if (sz >= ANS_MAX_CHUNK_SIZE) return false;
        int st0 = (int)ibs_.readBits(32);
        int st1 = (int)ibs_.readBits(32);
        int st2 = (int)ibs_.readBits(32);
        int st3 = (int)ibs_.readBits(32);
        if (len == 0) return true;

        i64 minBufSize = std::max((i64)2 * len, (i64)256);
        if ((i64)sz > minBufSize) return false;  // corrupted stream
        if ((i64)buffer_.size() < minBufSize + 64) buffer_.resize(minBufSize + 64);
        ibs_.readArray(buffer_.data(), 8 * (u64)sz);
        std::memset(buffer_.data() + sz, 0, std::min((i64)64, (i64)buffer_.size() - sz));

        i64 n = 0;
        u32 lr = logRange_;
        int mask = (1 << lr) - 1;
        int end4 = len & ~3;

        if (order_ == 0) {
            const u8* freq2sym = f2s_.data();
            const DecSymbol* symb = symbols_.data();
            for (int i = 0; i < end4; i += 4) {
                u8 cur3 = freq2sym[st3 & mask];
                block[i] = cur3;
                decodeSymbol(n, st3, symb[cur3], mask);
                u8 cur2 = freq2sym[st2 & mask];
                block[i + 1] = cur2;
                decodeSymbol(n, st2, symb[cur2], mask);
                u8 cur1 = freq2sym[st1 & mask];
                block[i + 2] = cur1;
                decodeSymbol(n, st1, symb[cur1], mask);
                u8 cur0 = freq2sym[st0 & mask];
                block[i + 3] = cur0;
                decodeSymbol(n, st0, symb[cur0], mask);
            }
        } else {
            int quarter = end4 >> 2;
            int i0 = 0, i1 = quarter, i2 = 2 * quarter, i3 = 3 * quarter;
            int prv0 = 0, prv1 = 0, prv2 = 0, prv3 = 0;
            while (i0 < quarter) {
                u8 cur3 = f2s_[((size_t)prv3 << lr) + (st3 & mask)];
                block[i3] = cur3;
                decodeSymbol(n, st3, symbols_[(prv3 << 8) + cur3], mask);
                u8 cur2 = f2s_[((size_t)prv2 << lr) + (st2 & mask)];
                block[i2] = cur2;
                decodeSymbol(n, st2, symbols_[(prv2 << 8) + cur2], mask);
                u8 cur1 = f2s_[((size_t)prv1 << lr) + (st1 & mask)];
                block[i1] = cur1;
                decodeSymbol(n, st1, symbols_[(prv1 << 8) + cur1], mask);
                u8 cur0 = f2s_[((size_t)prv0 << lr) + (st0 & mask)];
                block[i0] = cur0;
                decodeSymbol(n, st0, symbols_[(prv0 << 8) + cur0], mask);
                prv3 = cur3;
                prv2 = cur2;
                prv1 = cur1;
                prv0 = cur0;
                i0++;
                i1++;
                i2++;
                i3++;
            }
        }

        for (int i = end4; i < len; i++) block[i] = buffer_[n++];
        return true;
    }

    IBS& ibs_;
    int order_;
    int bsVersion_;
    int chunkSize_;
    u32 logRange_;
    std::vector<i32> freqs_;
    std::vector<DecSymbol> symbols_;
    std::vector<u8> f2s_;
    std::vector<u8> buffer_;
};

void ansEncode(OBS& obs, const u8* block, i64 len, int order) {
    ANSEncoder enc(obs, order);
    enc.write(block, len);
}

// embedded use (ROLZ nested streams)
void ansEncodeChunked(OBS& obs, const u8* block, i64 len, int order, int chunkSize) {
    ANSEncoder enc(obs, order, chunkSize);
    enc.write(block, len);
}

void ansDecodeChunked(IBS& ibs, u8* block, i64 len, int order, int chunkSize,
                      int bsVersion) {
    ANSDecoder dec(ibs, order, chunkSize, bsVersion);
    dec.read(block, len);
}

void ansDecode(IBS& ibs, u8* block, i64 len, int order, int bsVersion) {
    ANSDecoder dec(ibs, order, 0, bsVersion > 0 ? bsVersion : 6);
    dec.read(block, len);
}

}  // namespace kz

// ---------------------------------------------------------------------------
// Device-engine split: the host builds per-chunk normalized tables + headers
// (prepare), the device runs the 4-state encode scan (kanzi_tpu/ops/ans.py),
// and the host splices varint/states/pairs/tails into the payload (assemble)
// — byte-identical to ANSEncoder::write. Mirrors the Huffman engine split
// (kz_huffman_prepare / kz_huffman_assemble).
//
// tables layout per chunk: 5 planes of dim*256 int32 — xMax, bias, cmplFreq,
// invShift, invFreq(u32 bits) — where dim = 1 (order 0) or 256 (order 1).
// flags: 0 = encode on device, 2 = header-only chunk (order-0 single symbol).
// Caller guarantees len > 32 (the raw small-block path stays on host).
extern "C" int kz_ans_prepare(const uint8_t* block, int64_t len, int order,
                              int32_t* tables, uint8_t* hdr, int64_t hdrStride,
                              int32_t* hdrBits, uint8_t* flags) {
    try {
        using namespace kz;
        int chunkSize = order == 1
            ? std::min(ANS0_CHUNK_SIZE << 8, ANS_MAX_CHUNK_SIZE)
            : ANS0_CHUNK_SIZE;
        u32 logRange = std::max(ANS_DEFAULT_LOG_RANGE - (u32)order, 8u);
        size_t dim = order == 1 ? 256 : 1;
        std::vector<i32> freqs(dim * 257);
        std::vector<EncSymbol> symbols(dim * 256);
        int c = 0;
        i64 startChunk = 0;
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)chunkSize, len);
            i64 sz = endChunk - startChunk;
            if (order == 1 && sz > 1 && sz < 4)
                return -2;  // reference panics here; host path raises instead
            std::fill(freqs.begin(), freqs.end(), 0);
            std::memset(symbols.data(), 0, symbols.size() * sizeof(EncSymbol));
            ansHistogram(block + startChunk, sz, freqs.data(), order);
            OBS obs(hdr + (size_t)c * hdrStride, hdrStride);
            int alpha = ansUpdateFrequencies(obs, freqs.data(), symbols.data(),
                                             order, logRange);
            hdrBits[c] = (i32)obs.written();
            obs.close();
            flags[c] = (order == 1 || alpha > 1) ? 0 : 2;
            i32* t = tables + (size_t)c * 5 * dim * 256;
            for (size_t i = 0; i < dim * 256; i++) {
                t[0 * dim * 256 + i] = symbols[i].xMax;
                t[1 * dim * 256 + i] = symbols[i].bias;
                t[2 * dim * 256 + i] = symbols[i].cmplFreq;
                t[3 * dim * 256 + i] = (i32)symbols[i].invShift;
                t[4 * dim * 256 + i] = (i32)(u32)symbols[i].invFreq;
            }
            startChunk = endChunk;
            c++;
        }
        return c;
    } catch (const std::exception&) {
        return -1;
    }
}

// Decode-side device split: parse an ANS payload's chunk structure on the
// host (frequency headers -> freq->symbol maps + (cumFreq,freq) tables,
// varint sizes, initial states, renorm byte streams) so the 4-state forward
// decode can run batched on the device (kanzi_tpu/ops/ans.py decode_chunks).
// flags: 0 = device chunk, 2 = order-0 single-symbol chunk (value in aux).
// Returns the chunk count, or -2 if a chunk uses a non-default logRange
// (caller falls back to the host decoder).
extern "C" int kz_ans_dec_prepare(const uint8_t* payload, int64_t payloadBytes,
                                  int64_t outLen, int order,
                                  int32_t* dtabs, uint8_t* f2s, int64_t f2sStride,
                                  int32_t* states, uint8_t* bufs,
                                  int64_t bufStride, int32_t* bufSz,
                                  uint8_t* flags, uint8_t* aux) {
    try {
        using namespace kz;
        int chunkSize = order == 1
            ? std::min(ANS0_CHUNK_SIZE << 8, ANS_MAX_CHUNK_SIZE)
            : ANS0_CHUNK_SIZE;
        u32 expectLr = std::max(ANS_DEFAULT_LOG_RANGE - (u32)order, 8u);
        size_t dim = order == 1 ? 256 : 1;
        IBS ibs(payload, payloadBytes);
        std::vector<i32> freqs(dim * 256);
        std::vector<DecSymbol> symbols(dim * 256);
        std::vector<u8> f2sLocal;
        int alphabet[256];
        int c = 0;
        i64 startChunk = 0;
        while (startChunk < outLen) {
            i64 endChunk = std::min(startChunk + (i64)chunkSize, outLen);
            i64 len = endChunk - startChunk;
            u32 logRange = 0;
            std::memset(symbols.data(), 0, symbols.size() * sizeof(DecSymbol));
            int alpha = ansDecodeHeaderTables(ibs, order, logRange,
                                              freqs.data(), symbols.data(),
                                              f2sLocal, alphabet);
            if (alpha == 0) return -3;
            if (logRange != expectLr) return -2;
            if ((i64)f2sLocal.size() > f2sStride) return -4;
            if (order == 0 && alpha == 1) {
                flags[c] = 2;
                aux[c] = (u8)alphabet[0];
            } else {
                flags[c] = 0;
                std::memcpy(f2s + (size_t)c * f2sStride, f2sLocal.data(),
                            f2sLocal.size());
                i32* t = dtabs + (size_t)c * 2 * dim * 256;
                for (size_t i = 0; i < dim * 256; i++) {
                    t[i] = symbols[i].freq;
                    t[dim * 256 + i] = symbols[i].cumFreq;
                }
                u32 sz = readVarInt(ibs);
                if (sz >= ANS_MAX_CHUNK_SIZE) return -5;
                for (int j = 0; j < 4; j++)
                    states[4 * c + j] = (i32)ibs.readBits(32);
                if ((i64)sz + 64 > bufStride) return -6;
                if ((i64)sz > std::max((i64)2 * len, (i64)256)) return -5;
                ibs.readArray(bufs + (size_t)c * bufStride, 8 * (u64)sz);
                std::memset(bufs + (size_t)c * bufStride + sz, 0, 64);
                bufSz[c] = (i32)sz;
            }
            startChunk = endChunk;
            c++;
        }
        return c;
    } catch (const std::exception&) {
        return -1;
    }
}

// Splice the device-encoded rANS pair streams into the final entropy payload
// (byte-identical to ANSEncoder::write). pairBytes rows hold each chunk's
// renormalization byte stream already in stream order; states rows hold the
// four final 32-bit states.
extern "C" int64_t kz_ans_assemble(const uint8_t* block, int64_t len, int order,
                                   const uint8_t* hdr, int64_t hdrStride,
                                   const int32_t* hdrBits, const uint8_t* flags,
                                   const uint8_t* pairBytes, int64_t pairStride,
                                   const int32_t* pairCounts,
                                   const int32_t* states,
                                   uint8_t* dst, int64_t cap) {
    try {
        using namespace kz;
        int chunkSize = order == 1
            ? std::min(ANS0_CHUNK_SIZE << 8, ANS_MAX_CHUNK_SIZE)
            : ANS0_CHUNK_SIZE;
        OBS obs(dst, cap);
        i64 startChunk = 0;
        int c = 0;
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)chunkSize, len);
            i64 sz = endChunk - startChunk;
            obs.writeArray(hdr + (size_t)c * hdrStride, (u64)hdrBits[c]);
            if (flags[c] != 2) {
                i64 tail = sz & 3;
                i64 npairs = pairCounts[c];
                writeVarInt(obs, (u32)(2 * npairs + tail));
                for (int j = 0; j < 4; j++)
                    obs.writeBits((u64)(u32)states[4 * c + j], 32);
                if (npairs)
                    obs.writeArray(pairBytes + (size_t)c * pairStride,
                                   16 * (u64)npairs);
                for (i64 i = endChunk - tail; i < endChunk; i++)
                    obs.writeBits(block[i], 8);
            }
            startChunk = endChunk;
            c++;
        }
        u64 bits = obs.written();
        obs.close();
        return (int64_t)bits;
    } catch (const std::exception&) {
        return -1;
    }
}
