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

// One chunk header: the alphabet, the 3-bit logRange and the frequencies
// (the first inferred). Fills freqs and the 257 cumFreqs, whose last is
// 1 << logRange. Returns the alphabet size; 0 is no chunk, and nothing
// else is filled then.
int decodeRangeHeader(IBS& ibs, int* alphabet, i32* freqs, u64* cumFreqs,
                      u32& logRange) {
    int alphabetSize = decodeAlphabet(ibs, alphabet);
    if (alphabetSize == 0) return 0;
    if (alphabetSize != 256) std::memset(freqs, 0, 256 * sizeof(i32));
    logRange = 8 + (u32)ibs.readBits(3);
    int scale = 1 << logRange;
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
    for (int i = 0; i < 256; i++) cumFreqs[i + 1] = cumFreqs[i] + (u64)freqs[i];
    return alphabetSize;
}

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
        u32 logRange = 0;
        int alphabetSize = decodeRangeHeader(ibs, alphabet, freqs, cumFreqs, logRange);
        if (alphabetSize == 0) return 0;
        int scale = 1 << logRange;
        shift = logRange;
        if ((int)f2s.size() < scale) f2s.resize(scale);
        for (int i = 0; i < 256; i++) {
            int base = (int)cumFreqs[i];
            for (int j = freqs[i] - 1; j >= 0; j--) f2s[base + j] = (u16)i;
        }
        return alphabetSize;
    }

    inline u8 decodeByte() {
        rng >>= shift;
        // the quotient is compared before it is narrowed: a hostile state
        // can give one past 2^31, which an int cast would make negative
        const u64 q = (code - low) / rng;
        if (q >= (u64)f2s.size()) throw Error("invalid range state");
        const int count = (int)q;
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

namespace {

// A reader of the payload's bits from bitPos on: it starts at the byte
// that holds bitPos and skips the bits before it in that byte, so a
// header deep in the payload costs what one at its start does. Throws
// where the bit reader from bit 0 would (bitPos past the payload).
kz::IBS readerAt(const uint8_t* payload, int64_t payloadBits, int64_t bitPos) {
    using namespace kz;
    if (bitPos < 0 || bitPos > payloadBits) throw Error("no more data in bitstream");
    const i64 byte = bitPos >> 3;
    IBS ibs(payload + byte, (u64)(payloadBits - 8 * byte), true);
    if (bitPos & 7) ibs.readBits((u32)(bitPos & 7));
    return ibs;
}

}  // namespace

// Decode-side split, one chunk at a time: the range format carries no
// per-chunk stream length (a chunk's header begins where the previous
// chunk's last renorm read ended), so boundaries are only known after
// decoding — the host parses the header at bitPos, byte-aligns the rest of
// the payload into buf for the device scan, and advances its cursor by
// 60 + 28*nreads afterwards.  The payload holds payloadBits bits.  meta
// out: [0]=shift (logRange, 8..15), [1]=flag (0 device / 2 single-symbol),
// [2]=aux symbol.  f2s gets the chunk's 1 << shift slots (up to 32768).
// Returns the bit position just past the header, or a negative error code.
extern "C" int64_t kz_range_dec_chunk(const uint8_t* payload,
                                      int64_t payloadBits, int64_t bitPos,
                                      int32_t* tables, uint8_t* f2s,
                                      int32_t* meta, uint8_t* buf,
                                      int64_t bufCap) {
    try {
        using namespace kz;
        IBS ibs = readerAt(payload, payloadBits, bitPos);
        const i64 base = 8 * (bitPos >> 3);
        RangeDecoder dec(ibs);
        int alpha = dec.decodeHeader();
        if (alpha == 0) return -3;
        i64 hdrEnd = base + (i64)ibs.read();
        if (alpha == 1) {
            meta[0] = (i32)dec.shift;
            meta[1] = 2;
            meta[2] = dec.alphabet[0];
            return hdrEnd;
        }
        meta[0] = (i32)dec.shift;
        meta[1] = 0;
        meta[2] = 0;
        for (int i = 0; i < 256; i++) {
            tables[i] = (i32)dec.cumFreqs[i];
            tables[256 + i] = dec.freqs[i];
        }
        for (size_t i = 0; i < dec.f2s.size(); i++) f2s[i] = (u8)dec.f2s[i];
        // byte-align the remaining payload bits into buf (+ zero guard)
        i64 rest = payloadBits - hdrEnd;
        if (rest < 0) return -5;
        i64 copyBits = std::min(rest, (bufCap - 16) * 8);
        if (copyBits < 0) return -6;
        if (copyBits > 0) ibs.readArray(buf, (u64)copyBits);
        // a zero guard after the copy; nothing past it is read
        const i64 used = (copyBits + 7) >> 3;
        std::memset(buf + used, 0, (size_t)std::min<i64>(16, bufCap - used));
        return hdrEnd;
    } catch (const std::exception& e) {
        if (std::getenv("KZ_DEBUG")) std::fprintf(stderr, "kz_range_dec_chunk: %s\n", e.what());
        return -1;
    }
}

// The host half of one step of a batch's chunk walk: for each row k in
// [0, n), the chunk header of block blocks[k] at bitPos[blocks[k]] of its
// payload (payloads[b], payloadBits[b] bits), parsed as kz_range_dec_chunk
// does. held[b] (RANGE_CHUNK_SIZE slots a block) and heldLen[b] are the
// block's slot table as the host decoder holds it: grown to the largest
// table of the block's chunks so far and never cleared, so each header
// writes its 1 << logRange slots over the table's start. Per row: hdrEnd,
// the bit position past the header or kz_range_dec_chunk's error code
// (the block's table then unchanged); single, the symbol of a header-only
// chunk or -1. A row to decode gets the rest of the payload, its next
// cap - 16 bytes at most (cap >= 16), byte-aligned at bufs + k * bufStride (the
// bytes after them up to bufStride are left as they were: the decode
// reads none of them); its byte and bit counts, its cumFreq and freq
// planes, its logRange, its `sizes[k]` bytes to decode (nvalid) and its
// table's length (bound). Each block is in one row at most. Returns 0,
// or -7 where a row's bytes would not fit bufStride (the caller's
// sizing).
extern "C" int kz_range_dec_step(int32_t n, const int32_t* blocks,
                                 const uint64_t* payloads,
                                 const int64_t* payloadBits,
                                 const int64_t* bitPos, const int32_t* sizes,
                                 uint8_t* held, int32_t* heldLen, int64_t cap,
                                 uint8_t* bufs, int64_t bufStride,
                                 int32_t* nbytes, int32_t* nbits,
                                 int32_t* tables, int32_t* shifts,
                                 int32_t* nvalid, int32_t* bound,
                                 int64_t* hdrEnd, int32_t* single) {
    using namespace kz;
    int alphabet[256];
    i32 freqs[256];
    u64 cumFreqs[257];
    for (int k = 0; k < n; k++) {
        const int b = blocks[k];
        const uint8_t* payload = (const uint8_t*)(uintptr_t)payloads[b];
        const i64 bits = payloadBits[b];
        single[k] = -1;
        try {
            IBS ibs = readerAt(payload, bits, bitPos[b]);
            u32 logRange = 0;
            int alpha = decodeRangeHeader(ibs, alphabet, freqs, cumFreqs, logRange);
            if (alpha == 0) {
                hdrEnd[k] = -3;
                continue;
            }
            const i64 end = 8 * (bitPos[b] >> 3) + (i64)ibs.read();
            const i64 copyBits = std::min(bits - end, (cap - 16) * 8);
            const i64 used = (copyBits + 7) >> 3;
            if (alpha > 1 && used > bufStride) return -7;
            const int scale = 1 << logRange;
            u8* slots = held + (size_t)b * RANGE_CHUNK_SIZE;
            for (int i = 0; i < 256; i++)
                if (freqs[i] > 0) std::memset(slots + cumFreqs[i], i, (size_t)freqs[i]);
            heldLen[b] = std::max(heldLen[b], scale);
            hdrEnd[k] = end;
            if (alpha == 1) {
                single[k] = alphabet[0];
                continue;
            }
            if (copyBits > 0) ibs.readArray(bufs + (size_t)k * bufStride, (u64)copyBits);
            nbytes[k] = (i32)used;
            nbits[k] = (i32)copyBits;
            i32* t = tables + (size_t)k * 512;
            for (int i = 0; i < 256; i++) {
                t[i] = (i32)cumFreqs[i];
                t[256 + i] = freqs[i];
            }
            shifts[k] = (i32)logRange;
            nvalid[k] = sizes[k];
            bound[k] = heldLen[b];
        } catch (const std::exception& e) {
            if (std::getenv("KZ_DEBUG")) std::fprintf(stderr, "kz_range_dec_step: %s\n", e.what());
            hdrEnd[k] = -1;
        }
    }
    return 0;
}
