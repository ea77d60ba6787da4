// Canonical Huffman codec, 4-lane interleaved streams.
//
// Format (reference: v2/entropy/HuffmanCodec.go):
// - 16 KiB chunks; per chunk: alphabet + Exp-Golomb coded code-length deltas
//   (prev starts at 2), then 4 varints (per-lane bit sizes), then the 4
//   independent bit-packed lanes (fragment = chunk/4), then chunk%4 raw bytes.
// - max code length 12 bits; code lengths via Moffat-Katajainen in-place
//   algorithm; over-long codes limited by bit-debt repayment with a
//   normalize-to-2048 fallback.
//
// The 4-lane layout is the SIMD axis the device kernel
// (kanzi_tpu_torch/ops/huffman.py) exploits; this host version is the
// bit-exactness oracle and the single-chip fallback.

#include <algorithm>

#include "entropy_common.h"

namespace kz {

static constexpr int HUF_MIN_CHUNK = 1024;
static constexpr int HUF_MAX_CHUNK = 1 << 14;
static constexpr int HUF_MAX_SYMBOL_SIZE = 12;
static constexpr int HUF_DECODING_MASK = (1 << HUF_MAX_SYMBOL_SIZE) - 1;
static constexpr int HUF_BUFFER_SIZE = (HUF_MAX_SYMBOL_SIZE << 8) + 256;

// Re-sorts symbols into (code length, symbol) order and assigns canonical
// codes (reference :37-77).
static int generateCanonicalCodes(const u8* sizes, u16* codes, int* symbols,
                                  int count, int maxSymbolSize) {
    if (count == 0) return 0;
    if (count > 1) {
        std::vector<u8> buf(HUF_BUFFER_SIZE, 0);
        for (int k = 0; k < count; k++) {
            int s = symbols[k];
            if (s > 255) return -1;
            if (sizes[s] > maxSymbolSize) return -1;
            buf[((int)(sizes[s] - 1) << 8) | s] = 1;
        }
        for (int i = 0, n = 0; n < count; i++) {
            symbols[n] = i & 0xFF;
            n += buf[i];
        }
    }
    u16 code = 0;
    u8 curLen = sizes[symbols[0]];
    for (int k = 0; k < count; k++) {
        int s = symbols[k];
        code = (u16)(code << (sizes[s] - curLen));
        curLen = sizes[s];
        codes[s] = code;
        code++;
    }
    return count;
}

// Moffat & Katajainen in-place minimum-redundancy code lengths.
static void inPlaceSizesPhase1(int* data, int n) {
    for (int s = 0, r = 0, t = 0; t < n - 1; t++) {
        int sum = 0;
        for (int i = 0; i < 2; i++) {
            if (s >= n || (r < t && data[r] < data[s])) {
                sum += data[r];
                data[r] = t;
                r++;
                continue;
            }
            sum += data[s];
            if (s > t) data[s] = 0;
            s++;
        }
        data[t] = sum;
    }
}

static int inPlaceSizesPhase2(int* data, int n) {
    if (n < 2) return 0;
    int levelTop = n - 2;  // root
    int depth = 1;
    int i = n;
    int totalNodesAtLevel = 2;
    while (i > 0) {
        int k = levelTop;
        while (k > 0 && data[k - 1] >= levelTop) k--;
        int internalNodesAtLevel = levelTop - k;
        int leavesAtLevel = totalNodesAtLevel - internalNodesAtLevel;
        for (int j = 0; j < leavesAtLevel; j++) data[--i] = depth;
        totalNodesAtLevel = internalNodesAtLevel << 1;
        levelTop = k;
        depth++;
    }
    return depth - 1;
}

// ranks: (freq<<8|symbol) values; sorted here. On return sizes[] filled.
static int computeCodeLengths(u8* sizes, int* ranks, int count) {
    std::sort(ranks, ranks + count);
    int freqs[256];
    for (int i = 0; i < count; i++) {
        freqs[i] = ranks[i] >> 8;
        ranks[i] &= 0xFF;
        if (freqs[i] == 0) throw Error("invalid code length 0");
    }
    inPlaceSizesPhase1(freqs, count);
    int maxCodeLen = inPlaceSizesPhase2(freqs, count);
    for (int i = 0; i < count; i++) sizes[ranks[i]] = (u8)freqs[i];
    return maxCodeLen;
}

// Length-limiting via bit-debt repayment (reference :216-297).
static int limitCodeLengths(const int* symbols, i32* freqs, u8* sizes,
                            int* ranks, int count) {
    int n = 0, debt = 0;
    while (sizes[ranks[n]] >= HUF_MAX_SYMBOL_SIZE) {
        debt += (int)sizes[ranks[n]] - HUF_MAX_SYMBOL_SIZE;
        sizes[ranks[n]] = HUF_MAX_SYMBOL_SIZE;
        n++;
    }
    std::vector<int> q[6];
    while (n < count) {
        int idx = HUF_MAX_SYMBOL_SIZE - 1 - sizes[ranks[n]];
        if (idx > 5 || debt < (1 << idx)) break;
        q[idx].push_back(ranks[n]);
        n++;
    }
    size_t qpos[6] = {0, 0, 0, 0, 0, 0};
    int idx = 5;
    while (debt > 0 && idx >= 0) {
        if (qpos[idx] >= q[idx].size() || debt < (1 << idx)) {
            idx--;
            continue;
        }
        int r = q[idx][qpos[idx]++];
        sizes[r]++;
        debt -= (1 << idx);
    }
    idx = 0;
    while (debt > 0 && idx < 6) {
        if (qpos[idx] >= q[idx].size()) {
            idx++;
            continue;
        }
        int r = q[idx][qpos[idx]++];
        sizes[r]++;
        debt -= (1 << idx);
    }
    if (debt > 0) {
        // slow path: renormalize to a smaller scale and recompute
        i32 f[256];
        int alpha[256];
        int totalFreq = 0;
        for (int i = 0; i < count; i++) {
            f[i] = freqs[symbols[i]];
            totalFreq += f[i];
        }
        normalizeFrequencies(f, count, alpha, totalFreq, HUF_MAX_CHUNK >> 3);
        for (int i = 0; i < count; i++) {
            freqs[symbols[i]] = f[i];
            ranks[i] = (f[i] << 8) | symbols[i];
        }
        return computeCodeLengths(sizes, ranks, count);
    }
    return HUF_MAX_SYMBOL_SIZE;
}

// Builds codes for one chunk and writes the table header; returns alphabet
// size (reference updateFrequencies :128-214).
static int updateFrequencies(OBS& obs, i32* freqs, u16* codes) {
    int count = 0;
    u8 sizes[256] = {0};
    int alphabet[256];
    for (int i = 0; i < 256; i++) {
        codes[i] = 0;
        if (freqs[i] > 0) alphabet[count++] = i;
    }
    encodeAlphabet(obs, alphabet, count);
    if (count == 0) return 0;

    if (count == 1) {
        codes[alphabet[0]] = 1 << 12;
        sizes[alphabet[0]] = 1;
    } else {
        int ranks[256];
        for (int i = 0; i < count; i++)
            ranks[i] = (freqs[alphabet[i]] << 8) | alphabet[i];
        int maxCodeLen = computeCodeLengths(sizes, ranks, count);
        if (maxCodeLen > HUF_MAX_SYMBOL_SIZE)
            maxCodeLen = limitCodeLengths(alphabet, freqs, sizes, ranks, count);
        if (maxCodeLen > HUF_MAX_SYMBOL_SIZE) {
            for (int i = 0; i < count; i++) {
                codes[alphabet[i]] = (u16)i;
                sizes[alphabet[i]] = 8;
            }
        } else {
            if (generateCanonicalCodes(sizes, codes, ranks, count,
                                       HUF_MAX_SYMBOL_SIZE) < 0)
                throw Error("could not generate Huffman codes");
        }
    }

    ExpGolombEncoder eg(obs, true);
    u8 prevSize = 2;
    for (int i = 0; i < count; i++) {
        int s = alphabet[i];
        u8 curSize = sizes[s];
        codes[s] |= ((u16)curSize << 12);
        eg.encodeByte((u8)(curSize - prevSize));
        prevSize = curSize;
    }
    return count;
}

static void encodeChunk(OBS& obs, const u16* codes, const u8* block, int count,
                        u8* buffer, int szBuf) {
    u32 nbBits[4] = {0, 0, 0, 0};
    int szFrag = count / 4;
    int szFrag4 = szFrag & ~3;

    for (int j = 0; j < 4; j++) {
        const u8* src = block + j * szFrag;
        u8* buf = buffer + j * szBuf;
        int idx = 0;
        u64 state = 0;
        int bits = 0;
        for (int i = 0; i < szFrag4; i += 4) {
            for (int k = 0; k < 4; k++) {
                u16 code = codes[src[i + k]];
                u16 codeLen = code >> 12;
                state = (state << codeLen) | (u64)(code & 0x0FFF);
                bits += codeLen;
            }
            u64 be = __builtin_bswap64(state << (64 - bits));  // bits != 0
            std::memcpy(buf + idx, &be, 8);
            idx += bits >> 3;
            bits &= 7;
        }
        for (int i = szFrag4; i < szFrag; i++) {
            u16 code = codes[src[i]];
            u16 codeLen = code >> 12;
            state = (state << codeLen) | (u64)(code & 0x0FFF);
            bits += codeLen;
        }
        nbBits[j] = (u32)(idx * 8 + bits);
        while (bits >= 8) {
            bits -= 8;
            buf[idx++] = (u8)(state >> bits);
        }
        if (bits > 0) buf[idx++] = (u8)(state << (8 - bits));
    }

    for (int j = 0; j < 4; j++) writeVarInt(obs, nbBits[j]);
    for (int j = 0; j < 4; j++) obs.writeArray(buffer + j * szBuf, nbBits[j]);
    for (int i = 4 * szFrag; i < count; i++) obs.writeBits(block[i], 8);
}

void huffmanEncode(OBS& obs, const u8* block, i64 len) {
    if (len == 0) return;
    int chunkSize = HUF_MAX_CHUNK;
    i64 minBufLen = std::min((i64)(chunkSize + (chunkSize >> 3)), 2 * len);
    minBufLen = std::max(minBufLen, (i64)65536);
    std::vector<u8> buffer(minBufLen);
    u16 codes[256];
    i64 startChunk = 0;
    while (startChunk < len) {
        int sizeChunk = (int)std::min((i64)chunkSize, len - startChunk);
        if (sizeChunk < 32) {
            obs.writeArray(block + startChunk, 8 * (u64)sizeChunk);
        } else {
            i32 freqs[256];
            computeHistogram(block + startChunk, sizeChunk, freqs);
            int count = updateFrequencies(obs, freqs, codes);
            if (count > 1)
                encodeChunk(obs, codes, block + startChunk, sizeChunk,
                            buffer.data(), (int)(minBufLen / 4));
        }
        startChunk += sizeChunk;
    }
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct HufDecoder {
    u16 codes[256];
    int alphabet[256];
    u8 sizes[256];
    std::vector<u16> table;  // code -> (symbol<<8)|size
    std::vector<u8> buffer;

    // +8 bytes slack so the 8-byte refill reads stay in bounds on
    // adversarial lane sizes
    HufDecoder() : table(1 << HUF_MAX_SYMBOL_SIZE), buffer(2 * HUF_MAX_CHUNK + 8) {
        for (int i = 0; i < 256; i++) {
            sizes[i] = 8;
            codes[i] = (u16)i;
        }
    }

    int readLengths(IBS& ibs) {
        int count = decodeAlphabet(ibs, alphabet);
        if (count == 0) return 0;
        ExpGolombDecoder eg(ibs, true);
        int curSize = 2;
        for (int k = 0; k < count; k++) {
            int s = alphabet[k];
            codes[s] = 0;
            curSize += (i8)eg.decodeByte();
            if (curSize <= 0 || curSize > HUF_MAX_SYMBOL_SIZE)
                throw Error("invalid Huffman symbol size");
            sizes[s] = (u8)curSize;
        }
        if (generateCanonicalCodes(sizes, codes, alphabet, count,
                                   HUF_MAX_SYMBOL_SIZE) < 0)
            throw Error("could not generate Huffman codes");
        return count;
    }

    bool buildDecodingTable(int count) {
        std::fill(table.begin(), table.end(), (u16)7);
        int length = 0;
        const int shift = HUF_MAX_SYMBOL_SIZE;
        for (int k = 0; k < count; k++) {
            int s = alphabet[k];
            if (sizes[s] > length) length = sizes[s];
            u32 idx = (u32)codes[s] << (shift - length);
            u32 end = idx + (1u << (shift - length));
            if (end > table.size()) return false;
            u16 val = ((u16)s << 8) | sizes[s];
            for (u32 j = idx; j < end; j++) table[j] = val;
        }
        return true;
    }

    inline u8 readState(u64& state, int& idx, u8 bits) {
        u8 shift = (u8)((56 - bits) & ~7);
        u64 v;
        std::memcpy(&v, buffer.data() + idx, 8);
        v = __builtin_bswap64(v);
        state = (state << shift) | (v >> 1 >> (63 - shift));  // shift<64 safe
        idx += shift >> 3;
        return (u8)(bits + shift - HUF_MAX_SYMBOL_SIZE);
    }

    // Legacy single-stream chunk decode (bsVersion < 6,
    // reference v2/entropy/HuffmanCodec.go:978-1055)
    void decodeChunkV5(IBS& ibs, u8* block, int count) {
        if (ibs.readBits(2) != 0)
            throw Error("invalid Huffman data: only one stream supported in this version");
        u32 szBits = readVarInt(ibs);
        if (szBits == 0) return;
        i64 sz = (i64)((szBits + 7) >> 3);
        i64 minLenBuf = std::max(sz + (sz >> 3), (i64)1024);
        if ((i64)buffer.size() < minLenBuf + 8) buffer.resize(minLenBuf + 8);
        ibs.readArray(buffer.data(), szBits);
        u64 state = 0;
        u8 bits = 0;
        i64 idx = 0;
        int n = 0;
        while (idx < sz - 8 && n + 4 <= count) {
            u8 shift = (u8)((56 - bits) & ~7);
            u64 v;
            std::memcpy(&v, buffer.data() + idx, 8);
            v = __builtin_bswap64(v);
            state = (state << shift) | (v >> 1 >> (63 - shift));
            idx += shift >> 3;
            u8 bs = (u8)(bits + shift - HUF_MAX_SYMBOL_SIZE);
            for (int k = 0; k < 4; k++) {
                u16 val = table[(state >> bs) & HUF_DECODING_MASK];
                bs -= (u8)val;
                block[n + k] = (u8)(val >> 8);
            }
            bits = (u8)(bs + HUF_MAX_SYMBOL_SIZE);
            n += 4;
        }
        while (n < count) {
            while (bits < HUF_MAX_SYMBOL_SIZE && idx < sz) {
                state = (state << 8) | buffer[idx];
                idx++;
                bits += 8;  // may overshoot on the final padded byte
            }
            if (bits > 64) throw Error("invalid bitstream: incorrect symbol size");
            u16 val;
            if (bits >= HUF_MAX_SYMBOL_SIZE)
                val = table[(state >> (bits - HUF_MAX_SYMBOL_SIZE)) & HUF_DECODING_MASK];
            else
                val = table[(state << (HUF_MAX_SYMBOL_SIZE - bits)) & HUF_DECODING_MASK];
            bits -= (u8)val;
            block[n] = (u8)(val >> 8);
            n++;
        }
    }

    void decodeChunk(IBS& ibs, u8* block, int count) {
        u32 szBits[4];
        for (int j = 0; j < 4; j++) szBits[j] = readVarInt(ibs);
        int stride = (2 * HUF_MAX_CHUNK) / 4;
        int idx[4];
        for (int j = 0; j < 4; j++) {
            idx[j] = j * stride;
            if ((i64)((szBits[j] + 7) >> 3) > (i64)stride)
                throw Error("invalid Huffman stream size");
            ibs.readArray(buffer.data() + idx[j], szBits[j]);
            // zero the refill slack past each lane payload
            int sz = idx[j] + (int)((szBits[j] + 7) >> 3);
            if (sz < idx[j] + stride)
                std::memset(buffer.data() + sz, 0,
                            std::min(8, idx[j] + stride - sz));
        }

        u64 state[4] = {0, 0, 0, 0};
        u8 bits[4] = {0, 0, 0, 0};
        u8 bs[4];
        int szFrag = count / 4;
        u8* blk[4];
        for (int j = 0; j < 4; j++) blk[j] = block + j * szFrag;
        int n = 0;
        while (n < szFrag - 4) {
            for (int j = 0; j < 4; j++) bs[j] = readState(state[j], idx[j], bits[j]);
            for (int k = 0; k < 4; k++) {
                for (int j = 0; j < 4; j++) {
                    u16 val = table[(state[j] >> bs[j]) & HUF_DECODING_MASK];
                    bs[j] -= (u8)val;
                    blk[j][n + k] = (u8)(val >> 8);
                }
            }
            for (int j = 0; j < 4; j++) bits[j] = bs[j] + HUF_MAX_SYMBOL_SIZE;
            n += 4;
        }
        for (int j = 0; j < 4; j++) bs[j] = readState(state[j], idx[j], bits[j]);
        while (n < szFrag) {
            for (int j = 0; j < 4; j++) {
                u16 val = table[(state[j] >> bs[j]) & HUF_DECODING_MASK];
                bs[j] -= (u8)val;
                blk[j][n] = (u8)(val >> 8);
            }
            n++;
        }
        for (int i = 4 * szFrag; i < count; i++)
            block[i] = (u8)ibs.readBits(8);
    }
};

void huffmanDecode(IBS& ibs, u8* block, i64 len, int bsVersion) {
    if (len == 0) return;
    HufDecoder dec;
    int chunkSize = HUF_MAX_CHUNK;
    i64 startChunk = 0;
    if (bsVersion > 0 && bsVersion < 6) {
        // legacy decode: no small-chunk raw path, single-stream chunks
        // (reference decodeV5 :718-760)
        while (startChunk < len) {
            int sizeChunk = (int)std::min((i64)chunkSize, len - startChunk);
            int alphabetSize = dec.readLengths(ibs);
            if (alphabetSize == 0) throw Error("invalid Huffman alphabet");
            if (alphabetSize == 1) {
                std::memset(block + startChunk, dec.alphabet[0], sizeChunk);
            } else {
                if (!dec.buildDecodingTable(alphabetSize))
                    throw Error("invalid Huffman symbol size");
                dec.decodeChunkV5(ibs, block + startChunk, sizeChunk);
            }
            startChunk += sizeChunk;
        }
        return;
    }
    while (startChunk < len) {
        int sizeChunk = (int)std::min((i64)chunkSize, len - startChunk);
        if (sizeChunk < 32) {
            ibs.readArray(block + startChunk, 8 * (u64)sizeChunk);
        } else {
            int alphabetSize = dec.readLengths(ibs);
            if (alphabetSize == 0) throw Error("invalid Huffman alphabet");
            if (alphabetSize == 1) {
                std::memset(block + startChunk, dec.alphabet[0], sizeChunk);
            } else {
                if (!dec.buildDecodingTable(alphabetSize))
                    throw Error("invalid Huffman symbol size");
                dec.decodeChunk(ibs, block + startChunk, sizeChunk);
            }
        }
        startChunk += sizeChunk;
    }
}

// ---------------------------------------------------------------------------
// Device-pipeline support: expose per-chunk code tables + encoded table
// headers so the bulk bit-packing can run on the device (kanzi_tpu_torch/ops/huffman.py)
// while this host side provides the exact per-chunk headers.
// ---------------------------------------------------------------------------

// Per chunk of 16 KiB:
//   flags[c]: 0 = normal (header + 4 lanes), 1 = small chunk (< 32 bytes,
//             raw bits, no header), 2 = single-symbol (header only)
//   tables[c*256..]: (len<<12)|code entries (0 where unused)
//   hdr[c*hdrStride..]: header payload (alphabet + Exp-Golomb deltas),
//   hdrBits[c]: exact bit length of that header
// Returns the number of chunks.
int huffmanPrepare(const u8* block, i64 len, u16* tables, u8* hdr,
                   i64 hdrStride, i32* hdrBits, u8* flags) {
    int chunkSize = HUF_MAX_CHUNK;
    int c = 0;
    i64 startChunk = 0;
    while (startChunk < len) {
        int sizeChunk = (int)std::min((i64)chunkSize, len - startChunk);
        u16* codes = tables + (size_t)c * 256;
        std::memset(codes, 0, 256 * sizeof(u16));
        if (sizeChunk < 32) {
            flags[c] = 1;
            hdrBits[c] = 0;
        } else {
            i32 freqs[256];
            computeHistogram(block + startChunk, sizeChunk, freqs);
            OBS obs(hdr + (size_t)c * hdrStride, hdrStride);
            int count = updateFrequencies(obs, freqs, codes);
            hdrBits[c] = (i32)obs.written();
            obs.close();
            flags[c] = (count > 1) ? 0 : 2;
        }
        startChunk += sizeChunk;
        c++;
    }
    return c;
}

// Decode-side device split: parse one Huffman entropy payload's chunk
// structure on the host (alphabet + Exp-Golomb lengths -> 4096-entry decode
// tables, 4 lane byte streams per chunk) so the bulk symbol decode can run
// batched on the device (kanzi_tpu_torch/ops/huffman.py decode_lanes).
//
// Per chunk c (16 KiB grid over outLen):
//   flags[c]: 0 = normal (table + 4 device lanes), 1 = raw small chunk
//             (< 32 bytes, stored in aux), 2 = single symbol (value in aux)
//   dtables[c*4096..]: code -> (symbol<<8)|size entries
//   lanes: 4 zero-padded rows per flag==0 chunk, in chunk order
//   laneBits: exact payload bits per lane row
//   aux[c*auxStride..]: raw chunk bytes / single symbol / trailing tail bytes
// Returns the chunk count or a negative error.
int huffmanDecPrepare(const u8* payload, i64 payloadBits, i64 outLen,
                      u16* dtables, u8* lanes, i64 laneStride, i32* laneBits,
                      u8* flags, u8* aux, i64 auxStride) {
    IBS ibs(payload, (u64)payloadBits, true);
    HufDecoder dec;
    // the host decoder's lane buffer (HufDecoder::decodeChunk): four
    // regions of `stride` bytes, each lane's bits at the start of its
    // region and 8 zero bytes after them, the rest as earlier chunks left
    // it. A lane row is the start of its region, so that a hostile lane
    // that decodes past its own bits reads what the host decoder reads.
    const int stride = (2 * HUF_MAX_CHUNK) / 4;
    std::vector<u8> held(2 * HUF_MAX_CHUNK + 8, 0);
    int c = 0;
    i64 lane = 0;
    i64 startChunk = 0;
    while (startChunk < outLen) {
        int sizeChunk = (int)std::min((i64)HUF_MAX_CHUNK, outLen - startChunk);
        u8* auxRow = aux + (size_t)c * auxStride;
        if (sizeChunk < 32) {
            flags[c] = 1;
            ibs.readArray(auxRow, 8 * (u64)sizeChunk);
        } else {
            int alphabetSize = dec.readLengths(ibs);
            if (alphabetSize == 0) return -3;
            if (alphabetSize == 1) {
                flags[c] = 2;
                auxRow[0] = (u8)dec.alphabet[0];
            } else {
                if (!dec.buildDecodingTable(alphabetSize)) return -4;
                flags[c] = 0;
                std::memcpy(dtables + (size_t)c * 4096, dec.table.data(),
                            4096 * sizeof(u16));
                // layout: all four varint lane sizes, then the four lanes
                u32 szBits[4];
                for (int j = 0; j < 4; j++) {
                    szBits[j] = readVarInt(ibs);
                    laneBits[lane + j] = (i32)szBits[j];
                }
                for (int j = 0; j < 4; j++) {
                    // the host decoder's limit; a lane decodes from its
                    // first laneStride bytes at most
                    if ((i64)((szBits[j] + 7) >> 3) > (i64)stride) return -5;
                    u8* region = held.data() + (size_t)j * stride;
                    ibs.readArray(region, szBits[j]);
                    i64 sz = (i64)((szBits[j] + 7) >> 3);
                    std::memset(region + sz, 0, (size_t)std::min((i64)8, (i64)stride - sz));
                    std::memcpy(lanes + (size_t)(lane + j) * laneStride, region,
                                (size_t)std::min((i64)stride, laneStride));
                }
                lane += 4;
                int szFrag = sizeChunk / 4;
                for (int i = 4 * szFrag; i < sizeChunk; i++)
                    auxRow[i - 4 * szFrag] = (u8)ibs.readBits(8);
            }
        }
        startChunk += sizeChunk;
        c++;
    }
    return c;
}

}  // namespace kz

extern "C" int kz_huffman_dec_prepare(const uint8_t* payload,
                                      int64_t payloadBits, int64_t outLen,
                                      uint16_t* dtables, uint8_t* lanes,
                                      int64_t laneStride, int32_t* laneBits,
                                      uint8_t* flags, uint8_t* aux,
                                      int64_t auxStride) {
    try {
        return kz::huffmanDecPrepare(payload, payloadBits, outLen, dtables,
                                     lanes, laneStride, laneBits, flags, aux,
                                     auxStride);
    } catch (const std::exception&) {
        return -1;
    }
}

extern "C" int kz_huffman_prepare(const uint8_t* block, int64_t len,
                                  uint16_t* tables, uint8_t* hdr,
                                  int64_t hdrStride, int32_t* hdrBits,
                                  uint8_t* flags) {
    try {
        return kz::huffmanPrepare(block, len, tables, hdr, hdrStride, hdrBits, flags);
    } catch (const std::exception&) {
        return -1;
    }
}
