// Order-0 range codec (Subbotin style, 64-bit, 28-bit renormalization).
//
// Format spec: reference v2/entropy/RangeCodec.go. 32 KiB chunks; per chunk:
// alphabet + 3-bit logRange + log-max-bit-packed frequencies (first freq
// inferred), then the 60-bit coder stream.

#include <cstdio>
#include <cstdlib>

#include "entropy_common.h"

namespace kz {

static constexpr u64 TOP_RANGE = 0x0FFFFFFFFFFFFFFFull;
static constexpr u64 BOTTOM_RANGE = 0x000000000000FFFFull;
static constexpr u64 RANGE_MASK = 0x0FFFFFFF00000000ull;
static constexpr u32 RANGE_CHUNK_SIZE = 1 << 15;
static constexpr u32 RANGE_LOG_RANGE = 12;

namespace {

struct RangeEncoder {
    OBS& obs;
    u64 low = 0, rng = 0;
    u32 shift = 0;
    int alphabet[256];
    i32 freqs[256];
    u64 cumFreqs[257];

    explicit RangeEncoder(OBS& o) : obs(o) {}

    void encodeHeader(int alphabetSize, u32 lr) {
        encodeAlphabet(obs, alphabet, alphabetSize);
        if (alphabetSize == 0) return;
        obs.writeBits(lr - 8, 3);
        int chkSize = alphabetSize < 64 ? 6 : 8;
        u32 llr = 3;
        while ((1u << llr) <= lr) llr++;
        for (int i = 1; i < alphabetSize; i += chkSize) {
            int maxv = freqs[alphabet[i]] - 1;
            u32 logMax = 0;
            int endj = std::min(i + chkSize, alphabetSize);
            for (int j = i + 1; j < endj; j++)
                if (freqs[alphabet[j]] - 1 > maxv) maxv = freqs[alphabet[j]] - 1;
            while ((1 << logMax) <= maxv) logMax++;
            obs.writeBits(logMax, llr);
            if (logMax == 0) continue;
            for (int j = i; j < endj; j++)
                obs.writeBits((u64)(freqs[alphabet[j]] - 1), logMax);
        }
    }

    inline void encodeByte(u8 b) {
        u64 cumFreq = cumFreqs[b];
        rng >>= shift;
        low += cumFreq * rng;
        rng *= (cumFreqs[b + 1] - cumFreq);
        while (true) {
            if (((low ^ (low + rng)) & RANGE_MASK) != 0) {
                if (rng > BOTTOM_RANGE) break;
                rng = (~low + 1) & BOTTOM_RANGE;
            }
            obs.writeBits(low >> 32, 28);
            rng <<= 28;
            low <<= 28;
        }
    }

    void write(const u8* block, i64 len) {
        i64 startChunk = 0;
        while (startChunk < len) {
            rng = TOP_RANGE;
            low = 0;
            u32 lr = RANGE_LOG_RANGE;
            i64 endChunk = std::min(startChunk + (i64)RANGE_CHUNK_SIZE, len);
            while (lr > 8 && ((i64)1 << lr) > endChunk - startChunk) lr--;
            shift = lr;
            const u8* buf = block + startChunk;
            i64 n = endChunk - startChunk;

            computeHistogram(buf, n, freqs);
            int alphabetSize = normalizeFrequencies(freqs, 256, alphabet, (int)n, 1 << lr);
            if (alphabetSize > 0) {
                cumFreqs[0] = 0;
                for (int i = 0; i < 256; i++)
                    cumFreqs[i + 1] = cumFreqs[i] + (u64)freqs[i];
            }
            encodeHeader(alphabetSize, lr);

            if (alphabetSize <= 1) {
                startChunk = endChunk;
                continue;
            }
            for (i64 i = 0; i < n; i++) encodeByte(buf[i]);
            obs.writeBits(low, 60);
            startChunk = endChunk;
        }
    }
};

struct RangeDecoder {
    IBS& ibs;
    u64 code = 0, low = 0, rng = 0;
    u32 shift = 0;
    int alphabet[256];
    i32 freqs[256];
    u64 cumFreqs[257];
    std::vector<u16> f2s;

    explicit RangeDecoder(IBS& i) : ibs(i) {}

    int decodeHeader() {
        int alphabetSize = decodeAlphabet(ibs, alphabet);
        if (alphabetSize == 0) return 0;
        if (alphabetSize != 256) std::memset(freqs, 0, sizeof(freqs));
        u32 logRange = 8 + (u32)ibs.readBits(3);
        int scale = 1 << logRange;
        shift = logRange;
        int sum = 0;
        int chkSize = alphabetSize < 64 ? 6 : 8;
        u32 llr = 3;
        while ((1u << llr) <= logRange) llr++;
        for (int i = 1; i < alphabetSize; i += chkSize) {
            u32 logMax = (u32)ibs.readBits(llr);
            if (((i64)1 << logMax) > scale) throw Error("invalid range frequency size");
            int endj = std::min(i + chkSize, alphabetSize);
            for (int j = i; j < endj; j++) {
                int freq = 1;
                if (logMax > 0) {
                    freq = 1 + (int)ibs.readBits(logMax);
                    if (freq <= 0 || freq >= scale) throw Error("invalid range frequency");
                }
                freqs[alphabet[j]] = freq;
                sum += freq;
            }
        }
        if (scale <= sum) throw Error("invalid range frequency sum");
        freqs[alphabet[0]] = scale - sum;
        cumFreqs[0] = 0;
        if ((int)f2s.size() < scale) f2s.resize(scale);
        for (int i = 0; i < 256; i++) {
            cumFreqs[i + 1] = cumFreqs[i] + (u64)freqs[i];
            int base = (int)cumFreqs[i];
            for (int j = freqs[i] - 1; j >= 0; j--) f2s[base + j] = (u16)i;
        }
        return alphabetSize;
    }

    inline u8 decodeByte() {
        rng >>= shift;
        int count = (int)((code - low) / rng);
        if (count >= (int)f2s.size()) throw Error("invalid range state");
        u16 symbol = f2s[count];
        u64 cumFreq = cumFreqs[symbol];
        low += cumFreq * rng;
        rng *= (cumFreqs[symbol + 1] - cumFreq);
        while (true) {
            if (((low ^ (low + rng)) & RANGE_MASK) != 0) {
                if (rng > BOTTOM_RANGE) break;
                rng = (~low + 1) & BOTTOM_RANGE;
            }
            code = (code << 28) | ibs.readBits(28);
            rng <<= 28;
            low <<= 28;
        }
        return (u8)symbol;
    }

    void read(u8* block, i64 len) {
        i64 startChunk = 0;
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)RANGE_CHUNK_SIZE, len);
            int alphabetSize = decodeHeader();
            if (alphabetSize == 0) throw Error("invalid range header");
            if (alphabetSize == 1) {
                std::memset(block + startChunk, alphabet[0], endChunk - startChunk);
                startChunk = endChunk;
                continue;
            }
            rng = TOP_RANGE;
            low = 0;
            code = ibs.readBits(60);
            for (i64 i = startChunk; i < endChunk; i++) block[i] = decodeByte();
            startChunk = endChunk;
        }
    }
};

}  // namespace

void rangeEncode(OBS& obs, const u8* block, i64 len) {
    if (len == 0) return;
    RangeEncoder enc(obs);
    enc.write(block, len);
}

void rangeDecode(IBS& ibs, u8* block, i64 len, int bsVersion) {
    (void)bsVersion;
    if (len == 0) return;
    RangeDecoder dec(ibs);
    dec.read(block, len);
}

}  // namespace kz

// ---------------------------------------------------------------------------
// Device-engine split (mirrors kz_ans_prepare / kz_ans_assemble): the host
// builds per-chunk normalized tables + headers, the device runs the 60-bit
// coder scan (kanzi_tpu/ops/range.py), and the host splices headers,
// 28-bit renorm words and the final 60-bit low into the payload —
// byte-identical to RangeEncoder::write.
//
// tables layout per chunk: 2 planes of 256 int32 — cumFreq, freq.
// flags: 0 = encode on device, 2 = header-only chunk (alphabet <= 1).
// ---------------------------------------------------------------------------
extern "C" int kz_range_prepare(const uint8_t* block, int64_t len,
                                int32_t* tables, uint8_t* hdr,
                                int64_t hdrStride, int32_t* hdrBits,
                                uint8_t* flags, int32_t* shifts) {
    try {
        using namespace kz;
        int c = 0;
        i64 startChunk = 0;
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)RANGE_CHUNK_SIZE, len);
            i64 n = endChunk - startChunk;
            u32 lr = RANGE_LOG_RANGE;
            while (lr > 8 && ((i64)1 << lr) > n) lr--;

            OBS obs(hdr + (size_t)c * hdrStride, hdrStride);
            RangeEncoder enc(obs);
            computeHistogram(block + startChunk, n, enc.freqs);
            int alpha = normalizeFrequencies(enc.freqs, 256, enc.alphabet,
                                             (int)n, 1 << lr);
            if (alpha > 0) {
                enc.cumFreqs[0] = 0;
                for (int i = 0; i < 256; i++)
                    enc.cumFreqs[i + 1] = enc.cumFreqs[i] + (u64)enc.freqs[i];
            }
            enc.encodeHeader(alpha, lr);
            hdrBits[c] = (i32)obs.written();
            obs.close();
            flags[c] = alpha <= 1 ? 2 : 0;
            shifts[c] = (i32)lr;
            i32* t = tables + (size_t)c * 2 * 256;
            for (int i = 0; i < 256; i++) {
                t[i] = (i32)enc.cumFreqs[i];
                t[256 + i] = enc.freqs[i];
            }
            startChunk = endChunk;
            c++;
        }
        return c;
    } catch (const std::exception&) {
        return -1;
    }
}

extern "C" int64_t kz_range_assemble(const uint8_t* block, int64_t len,
                                     const uint8_t* hdr, int64_t hdrStride,
                                     const int32_t* hdrBits,
                                     const uint8_t* flags,
                                     const uint32_t* words,
                                     int64_t wordStride,
                                     const int32_t* nwords,
                                     const uint32_t* lows,
                                     uint8_t* dst, int64_t cap) {
    try {
        using namespace kz;
        OBS obs(dst, cap);
        i64 startChunk = 0;
        int c = 0;
        while (startChunk < len) {
            i64 endChunk = std::min(startChunk + (i64)RANGE_CHUNK_SIZE, len);
            obs.writeArray(hdr + (size_t)c * hdrStride, (u64)hdrBits[c]);
            if (flags[c] != 2) {
                const u32* w = words + (size_t)c * wordStride;
                for (i32 k = 0; k < nwords[c]; k++)
                    obs.writeBits((u64)w[k], 28);
                u64 low = ((u64)lows[2 * c + 1] << 32) | lows[2 * c];
                obs.writeBits(low, 60);
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

// Decode-side split, one chunk at a time: the range format carries no
// per-chunk stream length (a chunk's header begins where the previous
// chunk's last renorm read ended), so boundaries are only known after
// decoding — the host parses the header at bitPos, byte-aligns the rest of
// the payload into buf for the device scan, and advances its cursor by
// 60 + 28*nreads afterwards.  meta out: [0]=shift, [1]=flag (0 device /
// 2 single-symbol), [2]=aux symbol.  Returns the bit position just past
// the header, or a negative error code (caller falls back to host decode).
extern "C" int64_t kz_range_dec_chunk(const uint8_t* payload,
                                      int64_t payloadBytes, int64_t bitPos,
                                      int32_t* tables, uint8_t* f2s,
                                      int32_t* meta, uint8_t* buf,
                                      int64_t bufCap) {
    try {
        using namespace kz;
        IBS ibs(payload, payloadBytes);
        for (i64 skip = bitPos; skip > 0;) {
            int b = (int)std::min<i64>(skip, 48);
            ibs.readBits(b);
            skip -= b;
        }
        RangeDecoder dec(ibs);
        int alpha = dec.decodeHeader();
        if (alpha == 0) return -3;
        i64 hdrEnd = (i64)ibs.read();
        if (alpha == 1) {
            meta[0] = 0;
            meta[1] = 2;
            meta[2] = dec.alphabet[0];
            return hdrEnd;
        }
        if ((i64)dec.f2s.size() > 4096) return -4;
        meta[0] = (i32)dec.shift;
        meta[1] = 0;
        meta[2] = 0;
        for (int i = 0; i < 256; i++) {
            tables[i] = (i32)dec.cumFreqs[i];
            tables[256 + i] = dec.freqs[i];
        }
        std::memset(f2s, 0, 4096);
        for (size_t i = 0; i < dec.f2s.size(); i++) f2s[i] = (u8)dec.f2s[i];
        // byte-align the remaining payload bits into buf (+ zero guard)
        i64 rest = payloadBytes * 8 - hdrEnd;
        if (rest < 0) return -5;
        i64 copyBits = std::min(rest, (bufCap - 16) * 8);
        if (copyBits < 0) return -6;
        std::memset(buf, 0, (size_t)bufCap);
        if (copyBits > 0) ibs.readArray(buf, (u64)copyBits);
        return hdrEnd;
    } catch (const std::exception& e) {
        if (std::getenv("KZ_DEBUG")) std::fprintf(stderr, "kz_range_dec_chunk: %s\n", e.what());
        return -1;
    }
}
