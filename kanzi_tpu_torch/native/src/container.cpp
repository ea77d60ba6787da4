// One-shot block encode/decode + frame splicing: the container hot path.
//
// The Python kio layer owns the file header and the block schedule; this
// module owns everything per-block so a block costs exactly one FFI call
// and zero Python-side byte copies (this host's allocator makes fresh
// multi-MB buffers pathologically expensive — all scratch is pooled,
// thread-local, grow-only).
//
// Semantics mirror the reference encodingTask.encode / decodingTask.decode
// (v2/io/CompressedStream.go:729-977, :1763-2012): small-block copy mode,
// incompressible-skip heuristic, magic-number dataType seeding, the
// <=8-transform sequence with per-transform skip flags
// (v2/transform/Sequence.go:29-222), mode-byte layout, checksum, entropy
// stage, and the 5-bit/lw-bit frame length prefix (:951-976).

#include <vector>

#include "entropy_common.h"

namespace kz {

// from transforms.cpp / api.cpp / magic.cpp
int transformForward(int ttype, const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen);
int transformInverse(int ttype, const u8* src, i32 n, u8* dst, i64 cap, Ctx& ctx, i32* outLen);
void huffmanEncode(OBS& obs, const u8* block, i64 len);
void huffmanDecode(IBS& ibs, u8* block, i64 len, int bsVersion);
void ansEncode(OBS& obs, const u8* block, i64 len, int order);
void ansDecode(IBS& ibs, u8* block, i64 len, int order, int bsVersion);
void rangeEncode(OBS& obs, const u8* block, i64 len);
void rangeDecode(IBS& ibs, u8* block, i64 len, int bsVersion);
void fpaqEncode(OBS& obs, const u8* block, i64 len);
void fpaqDecode(IBS& ibs, u8* block, i64 len, int bsVersion);
void binaryEncode(OBS& obs, const u8* block, i64 len, int predictor, const Ctx& ctx);
void binaryDecode(IBS& ibs, u8* block, i64 len, int predictor, const Ctx& ctx);
u32 xxhash32(const u8* data, i64 len, u32 seed);
u64 xxhash64(const u8* data, i64 len, u64 seed);
int getMagicType(const u8* src, i64 len);
bool isDataCompressedMagic(int magic);
bool isDataMultimediaMagic(int magic);
bool isDataExecutableMagic(int magic);
i32 firstOrderEntropy1024(i64 blockLen, const i32* histo);

namespace {

enum {
    TT_NONE = 0, TT_BWT = 1, TT_BWTS = 2, TT_LZ = 3, TT_RLT = 5, TT_ZRLT = 6,
    TT_MTFT = 7, TT_RANK = 8, TT_EXE = 9, TT_DICT = 10, TT_ROLZ = 11,
    TT_ROLZX = 12, TT_SRT = 13, TT_LZP = 14, TT_MM = 15, TT_LZX = 16,
    TT_UTF = 17, TT_PACK = 18, TT_DNA = 19,
};
enum {
    ET_NONE = 0, ET_HUFFMAN = 1, ET_FPAQ = 2, ET_RANGE = 4,
    ET_ANS0 = 5, ET_CM = 6, ET_TPAQ = 7, ET_ANS1 = 8, ET_TPAQX = 9,
};
enum {
    DT_UNDEFINED = 0, DT_MULTIMEDIA = 2, DT_EXE = 3, DT_BIN = 7,
};

constexpr u32 COPY_BLOCK_MASK = 0x80;
constexpr u32 TRANSFORMS_MASK = 0x10;
constexpr i32 SMALL_BLOCK_SIZE = 15;
constexpr i64 MAX_BLOCK_SIZE = i64(1) << 30;
constexpr u32 STREAM_TYPE = 0x4B414E5A;  // "KANZ" checksum seed
constexpr int INCOMPRESSIBLE = 973;

struct Scratch {
    std::vector<u8> a, b, c, d;
};

Scratch& scratch() {
    static thread_local Scratch s;
    return s;
}

void growTouch(std::vector<u8>& v, size_t n) {
    if (v.size() < n) {
        v.resize(n);
        // touch pages once; reused buffers never fault again
        for (size_t i = 0; i < n; i += 4096) v[i] = 0;
    }
}

int parseChain(u64 chain, int* ids) {
    int nbtr = 0;
    for (int s = 42; s >= 0; s -= 6)
        if (((chain >> s) & 0x3F) != TT_NONE) nbtr++;
    if (nbtr == 0) nbtr = 1;
    for (int i = 0; i < nbtr; i++) ids[i] = (int)((chain >> (42 - 6 * i)) & 0x3F);
    return nbtr;
}

// per-transform MaxEncodedLen (mirrors the Python transform classes, which
// mirror the reference *_MAX_ENCODED_LEN rules)
i64 maxEncodedLen(int ttype, i64 n) {
    switch (ttype) {
        case TT_LZ:
        case TT_LZX:
        case TT_LZP:
            return n <= 1024 ? n + 16 : n + n / 64;
        case TT_PACK:
        case TT_DNA:
            return n + 1024;
        case TT_RLT:
            return n <= 512 ? n + 32 : n;
        case TT_SRT:
            return n + 4 * 256;
        case TT_MTFT:
        case TT_RANK:
        case TT_BWT:
            return n + 33;
        case TT_UTF:
            return n + 8192;
        case TT_MM:
            return n + (n >> 4 > 64 ? n >> 4 : 64);
        case TT_EXE:
            return n <= 256 ? n + 32 : n + n / 8;
        case TT_ROLZ:
            return n <= 512 ? n + 64 : n;
        case TT_ROLZX:
            return n <= 16384 ? n + 1024 : n + n / 32;
        default:  // NONE, BWTS, ZRLT, TEXT
            return n;
    }
}

i64 chainRequired(const int* ids, int nbtr, i64 n) {
    i64 required = n;
    for (int i = 0; i < nbtr; i++) {
        i64 m = maxEncodedLen(ids[i], required);
        if (m > required) required = m;
    }
    return required;
}

// "Construction pass": registry entries parameterize shared implementations
// by mutating ctx, in chain order, before any transform runs (mirrors
// Python new_sequence / reference transform.New, Factory.go:97-185).
void constructChain(const int* ids, int nbtr, int configuredEntropy, Ctx& ctx) {
    for (int i = 0; i < nbtr; i++) {
        switch (ids[i]) {
            case TT_LZ:
            case TT_LZX:
            case TT_LZP:
                ctx.lzVariant = ids[i];
                break;
            case TT_MTFT:
                ctx.sbrtMode = 1;
                break;
            case TT_RANK:
                ctx.sbrtMode = 2;
                break;
            case TT_DICT:
                ctx.textCodecVariant =
                    (configuredEntropy == ET_NONE || configuredEntropy == ET_ANS0 ||
                     configuredEntropy == ET_HUFFMAN || configuredEntropy == ET_RANGE)
                        ? 2 : 1;
                break;
            case TT_DNA:
                ctx.packOnlyDNA = 1;
                break;
            default:
                break;
        }
    }
}

void entropyEncodeAny(OBS& obs, int etype, const u8* src, i64 n, Ctx& ctx) {
    switch (etype) {
        case ET_NONE:    obs.writeArray(src, (u64)n * 8); break;
        case ET_HUFFMAN: huffmanEncode(obs, src, n); break;
        case ET_ANS0:    ansEncode(obs, src, n, 0); break;
        case ET_ANS1:    ansEncode(obs, src, n, 1); break;
        case ET_RANGE:   rangeEncode(obs, src, n); break;
        case ET_FPAQ:    fpaqEncode(obs, src, n); break;
        case ET_CM:      binaryEncode(obs, src, n, 0, ctx); break;
        case ET_TPAQ:    binaryEncode(obs, src, n, 1, ctx); break;
        case ET_TPAQX:   binaryEncode(obs, src, n, 2, ctx); break;
        default: throw Error("unknown entropy type");
    }
}

void entropyDecodeAny(IBS& ibs, int etype, u8* dst, i64 n, Ctx& ctx) {
    switch (etype) {
        case ET_NONE:    ibs.readArray(dst, (u64)n * 8); break;
        case ET_HUFFMAN: huffmanDecode(ibs, dst, n, ctx.bsVersion); break;
        case ET_ANS0:    ansDecode(ibs, dst, n, 0, ctx.bsVersion); break;
        case ET_ANS1:    ansDecode(ibs, dst, n, 1, ctx.bsVersion); break;
        case ET_RANGE:   rangeDecode(ibs, dst, n, ctx.bsVersion); break;
        case ET_FPAQ:    fpaqDecode(ibs, dst, n, ctx.bsVersion); break;
        case ET_CM:      binaryDecode(ibs, dst, n, 0, ctx); break;
        case ET_TPAQ:    binaryDecode(ibs, dst, n, 1, ctx); break;
        case ET_TPAQX:   binaryDecode(ibs, dst, n, 2, ctx); break;
        default: throw Error("unknown entropy type");
    }
}

// Run the forward chain with ping-pong scratch. Returns pointer to the final
// buffer (may be `src` if everything skipped) and the skip-flags byte
// (bit 7-i set = transform i skipped; reference Sequence.go:87-114).
const u8* sequenceForward(const int* ids, int nbtr, const u8* src, i32 n,
                          Ctx& ctx, i32* outLen, u8* skipFlags) {
    u8 flags = 0xFF;
    i64 required = chainRequired(ids, nbtr, n);
    Scratch& s = scratch();
    growTouch(s.a, (size_t)required);
    growTouch(s.b, (size_t)required);
    const u8* cur = src;
    i32 curLen = n;
    u8* ping = s.a.data();
    u8* pong = s.b.data();
    for (int i = 0; i < nbtr; i++) {
        ctx.hasHisto = 0;  // per-call reset (matches the per-call Ctx marshal)
        i32 olen = 0;
        int res;
        try {
            res = transformForward(ids[i], cur, curLen, ping, required, ctx, &olen);
        } catch (const std::exception&) {
            res = 1;  // a forward error means "skip", not failure
        }
        if (res != 0) continue;
        cur = ping;
        curLen = olen;
        u8* t = ping; ping = pong; pong = t;
        flags = (u8)(flags & ~(1u << (7 - i)));
    }
    *outLen = curLen;
    *skipFlags = flags;
    return cur;
}

}  // namespace
}  // namespace kz

using namespace kz;

extern "C" {

// Encode one block into `dst`: mode byte(s) + post-transform length +
// optional checksum + entropy payload. Returns the exact payload bit length
// (>= 0) or a negative error. postLenOut/skipFlagsOut/checksumOut feed the
// event pipeline.
int64_t kz_block_encode(const uint8_t* src, int32_t n, uint64_t chain,
                        int etype, Ctx* ctxIn, int checksumBits,
                        int skipBlocks, uint8_t* dst, int64_t cap,
                        int32_t* postLenOut, int32_t* skipFlagsOut,
                        uint64_t* checksumOut) {
    try {
        Ctx ctx = *ctxIn;
        ctx.size = n;
        ctx.entropyType = etype;

        u64 checksum = 0;
        if (checksumBits == 32)
            checksum = xxhash32(src, n, STREAM_TYPE);
        else if (checksumBits == 64)
            checksum = xxhash64(src, n, STREAM_TYPE);
        if (checksumOut) *checksumOut = checksum;

        u32 mode = 0;
        u64 tType = chain;
        int eType = etype;
        if (n <= SMALL_BLOCK_SIZE) {
            tType = 0;
            eType = ET_NONE;
            mode |= COPY_BLOCK_MASK;
        } else if (skipBlocks) {
            bool skip = false;
            if (n >= 8) skip = isDataCompressedMagic(getMagicType(src, n));
            if (!skip) {
                i32 histo[256];
                computeHistogram(src, n, histo);
                skip = firstOrderEntropy1024(n, histo) >= INCOMPRESSIBLE;
            }
            if (skip) {
                tType = 0;
                eType = ET_NONE;
                mode |= COPY_BLOCK_MASK;
            }
        }

        int ids[8];
        int nbtr = parseChain(tType, ids);
        constructChain(ids, nbtr, etype, ctx);

        if (n >= 4) {
            int magic = getMagicType(src, n);
            if (isDataCompressedMagic(magic)) ctx.dataType = DT_BIN;
            else if (isDataMultimediaMagic(magic)) ctx.dataType = DT_MULTIMEDIA;
            else if (isDataExecutableMagic(magic)) ctx.dataType = DT_EXE;
        }

        i32 postLen = 0;
        u8 skipFlags = 0xFF;
        const u8* post = sequenceForward(ids, nbtr, src, n, ctx, &postLen, &skipFlags);
        if (postLenOut) *postLenOut = postLen;
        if (skipFlagsOut) *skipFlagsOut = skipFlags;
        ctxIn->dataType = ctx.dataType;

        int dataSize = 1;
        if (postLen >= 256) {
            dataSize = (int)(log2_32((u32)postLen) >> 3) + 1;
            if (dataSize > 4) return -5;
        }
        mode |= (u32)((dataSize - 1) & 0x03) << 5;

        OBS obs(dst, cap);
        if ((mode & COPY_BLOCK_MASK) != 0 || nbtr <= 4) {
            mode |= (u32)(skipFlags >> 4);
            obs.writeBits(mode, 8);
        } else {
            mode |= TRANSFORMS_MASK;
            obs.writeBits(mode, 8);
            obs.writeBits(skipFlags, 8);
        }
        obs.writeBits((u64)postLen, (u32)(8 * dataSize));
        if (checksumBits) obs.writeBits(checksum, (u32)checksumBits);

        ctx.size = postLen;
        entropyEncodeAny(obs, eType, post, postLen, ctx);
        u64 bits = obs.written();
        obs.close();
        return (int64_t)bits;
    } catch (const std::exception&) {
        return -1;
    }
}

// The inverse chain's room: every intermediate of a conformant stream fits
// the forward's ping-pong buffers of chainRequired(blockSize) bytes (see
// kz_block_encode), e.g. SRT+SRT+BWT+ROLZ on a 1 KiB block legitimately
// passes a 1556-byte intermediate through the chain (fuzz seed 425151180).
// Crafted streams that exceed it fail cleanly on the per-stage cap check.
static i64 inverseCap(const int* ids, int nbtr, int32_t blockSize, i64 preLen) {
    i64 invCap = (i64)blockSize + ((blockSize >> 4) > 512 ? (blockSize >> 4) : 512) + 16;
    if (invCap < preLen + 1024) invCap = preLen + 1024;
    const i64 req = chainRequired(ids, nbtr, blockSize);
    return invCap < req ? req : invCap;
}

// The non-skipped transforms of a block in reverse order over its entropy
// output (buf, preLen bytes, in the scratch's c buffer), through the
// scratch's ping-pong buffers of invCap bytes, into dst (cap bytes).
// Returns the block's length, -8 where a transform fails, -9 where the
// result passes cap.
static i64 inverseChain(const int* ids, int nbtr, u8 skipFlags, Ctx& ctx, i64 invCap,
                        const u8* buf, i64 preLen, u8* dst, i64 cap) {
    Scratch& s = scratch();
    const u8* cur = buf;
    i32 curLen = (i32)preLen;
    growTouch(s.a, (size_t)invCap);
    growTouch(s.b, (size_t)invCap);
    u8* ping = s.a.data();
    u8* pong = s.b.data();
    if (skipFlags != 0xFF) {
        for (int i = nbtr - 1; i >= 0; i--) {
            if (skipFlags & (1u << (7 - i))) continue;
            ctx.hasHisto = 0;
            i32 olen = 0;
            int res = transformInverse(ids[i], cur, curLen, ping, invCap, ctx, &olen);
            if (res != 0) return -8;
            cur = ping;
            curLen = olen;
            u8* t = ping; ping = pong; pong = t;
        }
    }
    if (curLen > cap) return -9;
    if (cur != dst) std::memcpy(dst, cur, curLen);
    return curLen;
}

// The transform half of kz_block_decode, for a block whose entropy stage
// ran elsewhere (the device engines): the stream's chain and entropy type,
// the block's skip flags, its entropy output src (preLen bytes) -> dst (cap
// bytes), with kz_block_decode's room and rules. Returns the block's length
// or kz_block_decode's error (-8, -9; -1 on an exception).
extern "C" int64_t kz_block_inverse(const uint8_t* src, int64_t preLen, uint64_t chain,
                                    int etype, int skipFlags, Ctx* ctxIn,
                                    int32_t blockSize, uint8_t* dst, int64_t cap) {
    try {
        Ctx ctx = *ctxIn;
        ctx.size = (i32)preLen;
        ctx.entropyType = etype;
        int ids[8];
        const int nbtr = parseChain(chain, ids);
        constructChain(ids, nbtr, etype, ctx);
        const i64 invCap = inverseCap(ids, nbtr, blockSize, preLen);
        Scratch& s = scratch();
        growTouch(s.c, (size_t)invCap);
        std::memcpy(s.c.data(), src, (size_t)preLen);
        return inverseChain(ids, nbtr, (u8)skipFlags, ctx, invCap, s.c.data(), preLen,
                            dst, cap);
    } catch (const std::exception&) {
        return -1;
    }
}

// Decode one block frame payload. `src` points at the byte containing the
// first payload bit; `bitOff` [0..7] is the bit offset within it; srcBytes
// bounds reads (payload may legally over-read into subsequent padding, as
// the reference decoders do on the shared stream). Returns decoded length
// or a negative error (-7 = checksum mismatch).
int64_t kz_block_decode(const uint8_t* src, int64_t srcBytes, int bitOff,
                        uint64_t chain, int etype, Ctx* ctxIn,
                        int checksumBits, int32_t blockSize, uint8_t* dst,
                        int64_t cap) {
    try {
        Ctx ctx = *ctxIn;
        IBS ibs(src, srcBytes);
        if (bitOff) ibs.readBits((u32)bitOff);

        u32 mode = (u32)ibs.readBits(8);
        u8 skipFlags = 0;
        u64 tType = chain;
        int eType = etype;
        if (mode & COPY_BLOCK_MASK) {
            tType = 0;
            eType = ET_NONE;
        } else if (mode & TRANSFORMS_MASK) {
            skipFlags = (u8)ibs.readBits(8);
        } else {
            skipFlags = (u8)(((mode << 4) | 0x0F) & 0xFF);
        }

        int dataSize = 1 + (int)((mode >> 5) & 0x03);
        i64 preLen = (i64)ibs.readBits((u32)(8 * dataSize));
        i64 maxLen = blockSize + blockSize / 2;
        if (maxLen < 2048) maxLen = 2048;
        if (maxLen > MAX_BLOCK_SIZE) maxLen = MAX_BLOCK_SIZE;
        if (preLen == 0 || preLen > maxLen) return -6;

        u64 checksum1 = checksumBits ? ibs.readBits((u32)checksumBits) : 0;

        ctx.size = (i32)preLen;
        ctx.entropyType = etype;

        int ids[8];
        int nbtr = parseChain(tType, ids);
        constructChain(ids, nbtr, etype, ctx);

        // Inverse scratch must fit any intermediate expansion. The forward
        // ran inside ping-pong buffers of chainRequired(blockSize) bytes
        // (see kz_block_encode), so every intermediate of a conformant
        // stream is bounded by it — e.g. SRT+SRT+BWT+ROLZ on a 1 KiB block
        // legitimately passes a 1556-byte intermediate through the chain
        // (fuzz seed 425151180). Crafted streams that exceed it still fail
        // cleanly on the per-stage cap check.
        const i64 invCap = inverseCap(ids, nbtr, blockSize, preLen);
        Scratch& s = scratch();
        growTouch(s.c, (size_t)invCap);
        u8* buf = s.c.data();
        entropyDecodeAny(ibs, eType, buf, preLen, ctx);
        const i64 curLen = inverseChain(ids, nbtr, skipFlags, ctx, invCap, buf, preLen,
                                        dst, cap);
        if (curLen < 0) return curLen;

        if (checksumBits) {
            u64 checksum2 = (checksumBits == 32)
                ? xxhash32(dst, curLen, STREAM_TYPE)
                : xxhash64(dst, curLen, STREAM_TYPE);
            if (checksum2 != checksum1) return -7;
        }
        return curLen;
    } catch (const std::exception&) {
        return -1;
    }
}

// Transform stage only (for heterogeneous pipelines where the entropy stage
// runs on the device): runs the copy-mode/skip heuristics and the transform
// sequence, writes the post-transform bytes into `dst`, and returns metadata
// for the block header. Returns postLen >= 0 or a negative error.
// modeOut receives the mode byte with data-size bits and skip-flag nibble
// (or TRANSFORMS_MASK) already applied; extraSkipOut is 1 when a separate
// skip-flags byte must follow the mode byte.
int64_t kz_block_transform(const uint8_t* src, int32_t n, uint64_t chain,
                           int etype, Ctx* ctxIn, int checksumBits,
                           int skipBlocks, uint8_t* dst, int64_t cap,
                           int32_t* modeOut, int32_t* extraSkipOut,
                           int32_t* skipFlagsOut, uint64_t* checksumOut,
                           int32_t* copyModeOut) {
    try {
        Ctx ctx = *ctxIn;
        ctx.size = n;
        ctx.entropyType = etype;

        u64 checksum = 0;
        if (checksumBits == 32)
            checksum = xxhash32(src, n, STREAM_TYPE);
        else if (checksumBits == 64)
            checksum = xxhash64(src, n, STREAM_TYPE);
        if (checksumOut) *checksumOut = checksum;

        u32 mode = 0;
        u64 tType = chain;
        if (n <= SMALL_BLOCK_SIZE) {
            tType = 0;
            mode |= COPY_BLOCK_MASK;
        } else if (skipBlocks) {
            bool skip = false;
            if (n >= 8) skip = isDataCompressedMagic(getMagicType(src, n));
            if (!skip) {
                i32 histo[256];
                computeHistogram(src, n, histo);
                skip = firstOrderEntropy1024(n, histo) >= INCOMPRESSIBLE;
            }
            if (skip) {
                tType = 0;
                mode |= COPY_BLOCK_MASK;
            }
        }
        if (copyModeOut) *copyModeOut = (mode & COPY_BLOCK_MASK) ? 1 : 0;

        int ids[8];
        int nbtr = parseChain(tType, ids);
        constructChain(ids, nbtr, etype, ctx);

        if (n >= 4) {
            int magic = getMagicType(src, n);
            if (isDataCompressedMagic(magic)) ctx.dataType = DT_BIN;
            else if (isDataMultimediaMagic(magic)) ctx.dataType = DT_MULTIMEDIA;
            else if (isDataExecutableMagic(magic)) ctx.dataType = DT_EXE;
        }

        i32 postLen = 0;
        u8 skipFlags = 0xFF;
        const u8* post = sequenceForward(ids, nbtr, src, n, ctx, &postLen, &skipFlags);
        if (postLen > cap) return -9;
        if (post != dst) std::memcpy(dst, post, postLen);
        if (skipFlagsOut) *skipFlagsOut = skipFlags;
        ctxIn->dataType = ctx.dataType;

        int dataSize = 1;
        if (postLen >= 256) {
            dataSize = (int)(log2_32((u32)postLen) >> 3) + 1;
            if (dataSize > 4) return -5;
        }
        mode |= (u32)((dataSize - 1) & 0x03) << 5;
        int extraSkip = 0;
        if ((mode & COPY_BLOCK_MASK) != 0 || nbtr <= 4) {
            mode |= (u32)(skipFlags >> 4);
        } else {
            mode |= TRANSFORMS_MASK;
            extraSkip = 1;
        }
        if (modeOut) *modeOut = (i32)mode;
        if (extraSkipOut) *extraSkipOut = extraSkip;
        return postLen;
    } catch (const std::exception&) {
        return -1;
    }
}

// Splice the device-packed Huffman lanes into the final entropy payload —
// byte-identical to huffmanEncode's own output (v2/entropy/HuffmanCodec.go
// 4-interleaved-stream chunk layout: per-chunk header, 4 varint lane sizes,
// 4 lane bit-streams, raw tail bytes). Lane rows (4 per flag==0 chunk, in
// chunk order) come from ops.huffman.pack_lanes as big-endian byte rows.
// Returns total payload bits or a negative error.
int64_t kz_huffman_assemble(const uint8_t* block, int64_t len,
                            const uint8_t* hdr, int64_t hdrStride,
                            const int32_t* hdrBits, const uint8_t* flags,
                            const uint8_t* laneBytes, int64_t laneStride,
                            const int32_t* laneBits,
                            uint8_t* dst, int64_t cap) {
    try {
        constexpr i64 CHUNK = 16384;
        OBS obs(dst, cap);
        i64 nchunks = (len + CHUNK - 1) / CHUNK;
        if (nchunks < 1) nchunks = 1;
        i64 lane = 0;
        for (i64 c = 0; c < nchunks; c++) {
            i64 start = c * CHUNK;
            i64 size = std::min(CHUNK, len - start);
            if (flags[c] == 1) {  // small chunk: raw bytes
                obs.writeArray(block + start, 8 * (u64)size);
                continue;
            }
            obs.writeArray(hdr + c * hdrStride, (u64)hdrBits[c]);
            if (flags[c] == 2) continue;  // single symbol: header only
            for (int j = 0; j < 4; j++)
                writeVarInt(obs, (u32)laneBits[lane + j]);
            for (int j = 0; j < 4; j++)
                obs.writeArray(laneBytes + (lane + j) * laneStride,
                               (u64)laneBits[lane + j]);
            i64 szFrag = size / 4;
            for (i64 i = start + 4 * szFrag; i < start + size; i++)
                obs.writeBits(block[i], 8);
            lane += 4;
        }
        u64 bits = obs.written();
        obs.close();
        return (int64_t)bits;
    } catch (const std::exception&) {
        return -1;
    }
}

// Append a block frame (5-bit lw-3, lw-bit payload bit count, payload bits)
// to `stream` at bit position `bitpos`. Returns the new bit position or a
// negative error. The splice is the C++ analogue of the reference's ordered
// frame append (v2/io/CompressedStream.go:951-976).
int64_t kz_frame_append(uint8_t* stream, int64_t streamCapBytes, int64_t bitpos,
                        const uint8_t* payload, int64_t payloadBits) {
    u32 lw = payloadBits < 8 ? 3 : log2_32((u32)(payloadBits >> 3)) + 4;
    i64 endBits = bitpos + 5 + lw + payloadBits;
    if ((endBits + 7) / 8 > streamCapBytes) return -1;

    // header: 5 + lw bits via a tiny local accumulator spliced in
    u64 hdr = ((u64)(lw - 3) << lw) | (u64)payloadBits;
    u32 hdrBits = 5 + lw;
    // write hdr (MSB-first) bit-by-bit into stream at bitpos — tiny (<=40 bits)
    i64 p = bitpos;
    for (int i = (int)hdrBits - 1; i >= 0; i--, p++) {
        u8 bit = (u8)((hdr >> i) & 1);
        u8& b = stream[p >> 3];
        u8 m = (u8)(1u << (7 - (p & 7)));
        b = bit ? (u8)(b | m) : (u8)(b & ~m);
    }

    // splice payload bits
    u32 k = (u32)(p & 7);
    i64 dstByte = p >> 3;
    i64 full = payloadBits >> 3;
    u32 rem = (u32)(payloadBits & 7);
    if (k == 0) {
        std::memcpy(stream + dstByte, payload, (size_t)full);
        if (rem) {
            u8 last = (u8)(payload[full] & (u8)(0xFF << (8 - rem)));
            u8& b = stream[dstByte + full];
            b = (u8)((b & (u8)(0xFF >> rem)) | last);
        }
    } else {
        u8 carry = (u8)(stream[dstByte] & (u8)(0xFF << (8 - k)));
        i64 i = 0;
        if (full > 0) {
            stream[dstByte] = (u8)(carry | (payload[0] >> k));
            // no loop-carried dependency: auto-vectorizes
            for (i = 1; i < full; i++)
                stream[dstByte + i] =
                    (u8)((payload[i - 1] << (8 - k)) | (payload[i] >> k));
            carry = (u8)(payload[full - 1] << (8 - k));
        }
        // tail: the pending k carry bits then rem leftover payload bits
        u32 tailBits = k + rem;
        u32 tv = ((u32)(carry >> (8 - k)) << rem) |
                 (rem ? (u32)(payload[full] >> (8 - rem)) : 0u);
        i64 q = (dstByte + i) * 8;
        for (u32 t = 0; t < tailBits; t++, q++) {
            u8 bit = (u8)((tv >> (tailBits - 1 - t)) & 1);
            u8& b = stream[q >> 3];
            u8 m = (u8)(1u << (7 - (q & 7)));
            b = bit ? (u8)(b | m) : (u8)(b & ~m);
        }
    }
    return endBits;
}

// ---------------------------------------------------------------------------
// Whole-stream one-shot API: a standalone C consumer can produce and consume
// complete KANZ v6 containers with no Python layer at all. Byte-identical to
// the Python Writer for the same parameters (pinned by tests/test_c_api.py);
// serial single-pass, which equals any job count by the statelessness
// contract (v2/Definitions.go:50-52). Decode accepts v6 headers only —
// legacy v1-v5 streams go through the Python Reader, which owns the
// versioned header layouts. Reference: v2/io/CompressedStream.go:429-519
// (header + 24-bit CRC fold), :951-976 (frames), :592-594 (end marker).
// ---------------------------------------------------------------------------

int64_t kz_frame_append(uint8_t* stream, int64_t streamCapBytes, int64_t bitpos,
                        const uint8_t* payload, int64_t payloadBits);
int64_t kz_stream_close(uint8_t* stream, int64_t streamCapBytes, int64_t bitpos);

static int64_t headerCrc24(int ckSize, int etype, uint64_t chain,
                           int64_t blockSize, uint32_t szMask, uint64_t osz) {
    constexpr u32 HH = 0x1E35A7BD;
    u32 seed = 0x01030507u * 6u;  // x version
    u32 ck = HH * seed;
    ck ^= HH * (u32)~(u32)ckSize;
    ck ^= HH * (u32)~(u32)etype;
    u64 nchain = ~chain;
    ck ^= HH * (u32)(nchain >> 32);
    ck ^= HH * (u32)nchain;
    ck ^= HH * (u32)~(u32)blockSize;
    if (szMask) {
        u64 nosz = ~osz;
        ck ^= HH * (u32)(nosz >> 32);
        ck ^= HH * (u32)nosz;
    }
    return (int64_t)(((ck >> 23) ^ (ck >> 3)) & 0xFFFFFF);
}

// Compress `src[0..n)` into a complete KANZ v6 stream in `dst`. origSize < 0
// means "unknown" (header szMask 0 — same as a streaming writer that never
// learned the input size); one-shot callers normally pass n. Returns total
// stream bytes or a negative error. Returns -10 when `cap` is too small:
// streams can EXPAND (small blocks pay per-block entropy headers), and the
// provable worst case is 64 + ceil(n/blockSize) * (2*blockSize + 65536 + 8)
// bytes — each block payload fits the encoder's own bcap scratch below,
// plus <= 8 frame-overhead bytes (docs/C_API.md "Sizing dst").
int64_t kz_compress(const uint8_t* src, int64_t n, int32_t blockSize,
                    uint64_t chain, int etype, int checksumBits,
                    int headerless, int skipBlocks, int64_t origSize,
                    Ctx* ctxIn, uint8_t* dst, int64_t cap) {
    try {
        if (blockSize < 1024 || blockSize > MAX_BLOCK_SIZE || (blockSize & 15))
            return -3;
        int ckSize = checksumBits == 0 ? 0
                   : checksumBits == 32 ? 1 : checksumBits == 64 ? 2 : -1;
        if (ckSize < 0) return -4;
        i64 bitpos = 0;
        if (!headerless) {
            OBS obs(dst, cap);
            obs.writeBits(STREAM_TYPE, 32);
            obs.writeBits(6, 4);
            obs.writeBits((u32)ckSize, 2);
            obs.writeBits((u32)etype, 5);
            obs.writeBits(chain, 48);
            obs.writeBits((u64)((u32)blockSize >> 4), 28);
            u32 szMask = 0;
            u64 osz = origSize < 0 ? 0 : (u64)origSize;
            if (osz != 0 && osz < (u64(1) << 48))
                szMask = osz >= (u64(1) << 32) ? 3
                       : osz >= (u64(1) << 16) ? 2 : 1;
            obs.writeBits(szMask, 2);
            if (szMask) obs.writeBits(osz, 16 * szMask);
            obs.writeBits(0, 15);
            obs.writeBits((u64)headerCrc24(ckSize, etype, chain, blockSize,
                                           szMask, osz), 24);
            bitpos = (i64)obs.written();  // whole bytes by construction
            obs.close();
        }
        Scratch& s = scratch();
        i64 bcap = 2 * (i64)blockSize + 65536;
        growTouch(s.d, (size_t)bcap);
        i64 off = 0;
        while (off < n) {
            i32 m = (i32)std::min<i64>(blockSize, n - off);
            Ctx bctx = *ctxIn;  // fresh per block, as the Python Writer does
            bctx.blockSize = blockSize;
            i64 bits = kz_block_encode(src + off, m, chain, etype, &bctx,
                                       checksumBits, skipBlocks, s.d.data(),
                                       bcap, nullptr, nullptr, nullptr);
            if (bits < 0) return bits;
            bitpos = kz_frame_append(dst, cap, bitpos, s.d.data(), bits);
            if (bitpos < 0) return -10;
            off += m;
        }
        return kz_stream_close(dst, cap, bitpos);
    } catch (const std::exception&) {
        return -1;
    }
}

// Parse a v6 stream header. Returns the header length in bits (>= 0) or a
// negative error (-20 bad magic, -21 unsupported version — use the Python
// Reader for legacy streams, -23 bad block size, -24 CRC mismatch).
// origSize receives -1 when the header does not carry the input size.
int64_t kz_stream_info(const uint8_t* src, int64_t nbytes,
                       int32_t* checksumBits, int32_t* etype, uint64_t* chain,
                       int32_t* blockSize, int64_t* origSize) {
    try {
        IBS h(src, nbytes);
        if (h.readBits(32) != STREAM_TYPE) return -20;
        u32 version = (u32)h.readBits(4);
        if (version != 6) return -21;
        u32 ckSize = (u32)h.readBits(2);
        if (ckSize > 2) return -22;
        int et = (int)h.readBits(5);
        u64 ch = h.readBits(48);
        i64 bs = (i64)h.readBits(28) << 4;
        if (bs < 1024 || bs > MAX_BLOCK_SIZE || (bs & 15)) return -23;
        u32 szMask = (u32)h.readBits(2);
        u64 osz = 0;
        if (szMask) osz = h.readBits(16 * szMask);
        h.readBits(15);
        u32 crc = (u32)h.readBits(24);
        if ((i64)crc != headerCrc24((int)ckSize, et, ch, bs, szMask, osz))
            return -24;
        if (checksumBits) *checksumBits = ckSize == 0 ? 0 : ckSize == 1 ? 32 : 64;
        if (etype) *etype = et;
        if (chain) *chain = ch;
        if (blockSize) *blockSize = (int32_t)bs;
        if (origSize) *origSize = szMask ? (int64_t)osz : -1;
        return (int64_t)h.read();
    } catch (const std::exception&) {
        return -1;
    }
}

// Decompress a complete KANZ v6 stream (or a headerless stream with the
// parameters supplied). Returns the decoded byte count or a negative error.
int64_t kz_decompress(const uint8_t* src, int64_t nbytes, uint8_t* dst,
                      int64_t cap, Ctx* ctxIn, int headerless,
                      uint64_t chainIn, int etypeIn, int checksumBitsIn,
                      int32_t blockSizeIn) {
    try {
        u64 chain;
        int etype, checksumBits;
        i64 blockSize, pos;
        if (headerless) {
            chain = chainIn;
            etype = etypeIn;
            checksumBits = checksumBitsIn;
            blockSize = blockSizeIn;
            if (blockSize < 1024 || blockSize > MAX_BLOCK_SIZE || (blockSize & 15))
                return -23;
            pos = 0;
        } else {
            int32_t ckb = 0, et32 = 0, bs32 = 0;
            uint64_t ch = 0;
            int64_t osz = 0;
            i64 hbits = kz_stream_info(src, nbytes, &ckb, &et32, &ch, &bs32, &osz);
            if (hbits < 0) return hbits;
            chain = ch;
            etype = et32;
            checksumBits = ckb;
            blockSize = bs32;
            pos = hbits;
        }
        i64 out = 0;
        for (;;) {
            if ((pos >> 3) >= nbytes) return -25;
            IBS f(src + (pos >> 3), nbytes - (pos >> 3));
            if (pos & 7) f.readBits((u32)(pos & 7));
            u32 lw = (u32)f.readBits(5) + 3;
            u64 pbits = f.readBits(lw);
            if (pbits == 0) break;  // end-of-stream marker
            pos += 5 + lw;
            if (pos + (i64)pbits > nbytes * 8) return -26;
            Ctx bctx = *ctxIn;
            bctx.blockSize = (i32)blockSize;
            i64 r = kz_block_decode(src + (pos >> 3), nbytes - (pos >> 3),
                                    (int)(pos & 7), chain, etype, &bctx,
                                    checksumBits, (i32)blockSize,
                                    dst + out, cap - out);
            if (r < 0) return r;
            out += r;
            pos += (i64)pbits;
        }
        return out;
    } catch (const std::exception&) {
        return -1;
    }
}

// Write the zero-length end-of-stream marker and zero-pad the final byte.
// Returns the total stream length in bytes.
int64_t kz_stream_close(uint8_t* stream, int64_t streamCapBytes, int64_t bitpos) {
    i64 end = bitpos + 8;  // 5-bit marker (0) + 3 bits of length = 8 zero bits
    if ((end + 7) / 8 > streamCapBytes) return -1;
    for (i64 p = bitpos; p < end; p++) {
        u8& b = stream[p >> 3];
        b = (u8)(b & ~(1u << (7 - (p & 7))));
    }
    // zero-pad the final partial byte's low bits
    u32 rem = (u32)(end & 7);
    if (rem) stream[end >> 3] &= (u8)(0xFF << (8 - rem));
    return (end + 7) / 8;
}

}  // extern "C"
