// FPAQ: order-0 adaptive bitwise arithmetic coder (fpaq0r lineage).
//
// Format spec: reference v2/entropy/FPAQCodec.go. 4 MiB chunks; per chunk a
// varint byte count + payload; a 56-bit resync word precedes each chunk on
// the decode side (written between chunks and at dispose on the encode
// side). The arithmetic state (low/high) carries across chunks. 4
// probability tables selected by the top 2 bits of the previous byte, 256
// tree contexts each, adaptation rate 6.

#include "entropy_common.h"

namespace kz {

static constexpr int FPAQ_PSCALE = 1 << 16;
static constexpr i64 FPAQ_CHUNK = 4 * 1024 * 1024;
static constexpr u64 FPAQ_TOP = 0x00FFFFFFFFFFFFFFull;
static constexpr u64 MASK_0_56 = 0x00FFFFFFFFFFFFFFull;
static constexpr u64 MASK_0_24 = 0x0000000000FFFFFFull;
static constexpr u64 MASK_0_32 = 0x00000000FFFFFFFFull;

void fpaqEncode(OBS& obs, const u8* block, i64 count) {
    if (count > (i64)1 << 30) throw Error("FPAQ: block too large");
    u64 low = 0, high = FPAQ_TOP;
    std::vector<u8> buffer;
    i64 index = 0;
    int probs[4][256];
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 256; j++) probs[i][j] = FPAQ_PSCALE >> 1;

    auto flush = [&]() {
        u32 v = (u32)(high >> 24);
        buffer[index] = (u8)(v >> 24);
        buffer[index + 1] = (u8)(v >> 16);
        buffer[index + 2] = (u8)(v >> 8);
        buffer[index + 3] = (u8)v;
        index += 4;
        low <<= 32;
        high = (high << 32) | MASK_0_32;
    };

    auto encodeBit = [&](int bit, int* p) {
        u64 split = (((high - low) >> 8) * (u64)(u32)*p) >> 8;
        if (bit == 0) {
            low += split + 1;
            *p -= (*p >> 6);
        } else {
            high = low + split;
            *p -= ((*p - FPAQ_PSCALE + 64) >> 6);
        }
        if ((low ^ high) < ((u64)1 << 24)) flush();
    };

    i64 startChunk = 0;
    while (startChunk < count) {
        i64 chunkSize = std::min(FPAQ_CHUNK, count - startChunk);
        if ((i64)buffer.size() < chunkSize + (chunkSize >> 3) + 8)
            buffer.resize(chunkSize + (chunkSize >> 3) + 8);
        index = 0;
        const u8* buf = block + startChunk;
        int* p = probs[0];
        for (i64 i = 0; i < chunkSize; i++) {
            int val = buf[i];
            int bits = val + 256;
            encodeBit(val & 0x80, &p[1]);
            encodeBit(val & 0x40, &p[bits >> 7]);
            encodeBit(val & 0x20, &p[bits >> 6]);
            encodeBit(val & 0x10, &p[bits >> 5]);
            encodeBit(val & 0x08, &p[bits >> 4]);
            encodeBit(val & 0x04, &p[bits >> 3]);
            encodeBit(val & 0x02, &p[bits >> 2]);
            encodeBit(val & 0x01, &p[bits >> 1]);
            p = probs[val >> 6];
        }
        writeVarInt(obs, (u32)index);
        obs.writeArray(buffer.data(), 8 * (u64)index);
        startChunk += chunkSize;
        if (startChunk < count) obs.writeBits(low | MASK_0_24, 56);
    }
    // dispose: final flush
    obs.writeBits(low | MASK_0_24, 56);
}

void fpaqDecode(IBS& ibs, u8* block, i64 count, int bsVersion) {
    // bsVersion < 4 streams use the older bit-split semantics
    // (FPAQCodec.go:282-306 decodeBitV1): 8-bit predictions (pred >> 4),
    // a >>4 interval scale, and a LOOPED 32-bit refill.
    bool isV3 = bsVersion > 0 && bsVersion < 4;
    if (count > (i64)1 << 30) throw Error("FPAQ: block too large");
    u64 low = 0, high = FPAQ_TOP, current = 0;
    std::vector<u8> buffer;
    i64 index = 0;
    int probs[4][256];
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 256; j++) probs[i][j] = FPAQ_PSCALE >> 1;
    int ctx = 1;

    auto readWord = [&]() {
        low = (low << 32) & MASK_0_56;
        high = ((high << 32) | MASK_0_32) & MASK_0_56;
        // structural bound: a corrupted chunk whose declared byte count is
        // far below what its window dynamics consume must read zeros, not
        // run off the buffer (valid streams never reach the guard)
        u32 val = 0;
        if (index + 4 <= (i64)buffer.size()) {
            val = ((u32)buffer[index] << 24) | ((u32)buffer[index + 1] << 16) |
                  ((u32)buffer[index + 2] << 8) | buffer[index + 3];
            index += 4;
        }
        current = ((current << 32) | val) & MASK_0_56;
    };

    auto decodeBit = [&](int* p) {
        u64 split = ((((high - low) >> 8) * (u64)(u32)p[ctx]) >> 8) + low;
        if (split >= current) {
            high = split;
            p[ctx] -= ((p[ctx] - FPAQ_PSCALE + 64) >> 6);
            ctx += ctx + 1;
        } else {
            low = split + 1;
            p[ctx] -= (p[ctx] >> 6);
            ctx += ctx;
        }
        if ((low ^ high) < ((u64)1 << 24)) readWord();
    };

    auto decodeBitV1 = [&](int* p) {
        u64 split = ((((high - low) >> 4) * (u64)(u32)(p[ctx] >> 4)) >> 8) + low;
        if (split >= current) {
            high = split;
            p[ctx] -= ((p[ctx] - FPAQ_PSCALE + 64) >> 6);
            ctx += ctx + 1;
        } else {
            low = split + 1;
            p[ctx] -= (p[ctx] >> 6);
            ctx += ctx;
        }
        while (((low ^ high) >> 24) == 0) readWord();
    };

    i64 startChunk = 0;
    while (startChunk < count) {
        i64 szBytes = (i64)readVarInt(ibs);
        if (szBytes < 0 || szBytes >= 2 * count + 1024)
            throw Error("FPAQ: invalid chunk size");
        i64 bufSize = std::max(szBytes + (szBytes >> 2), (i64)1024);
        if ((i64)buffer.size() < bufSize + 8) buffer.resize(bufSize + 8);
        current = ibs.readBits(56);
        std::memset(buffer.data() + szBytes, 0,
                    std::min((i64)8, (i64)buffer.size() - szBytes));
        ibs.readArray(buffer.data(), 8 * (u64)szBytes);
        index = 0;
        i64 chunkSize = std::min(FPAQ_CHUNK, count - startChunk);
        u8* buf = block + startChunk;
        int* p = probs[0];
        if (isV3) {
            for (i64 i = 0; i < chunkSize; i++) {
                ctx = 1;
                for (int b = 0; b < 8; b++) decodeBitV1(p);
                buf[i] = (u8)ctx;
                p = probs[(ctx & 0xFF) >> 6];
            }
        } else {
            for (i64 i = 0; i < chunkSize; i++) {
                ctx = 1;
                for (int b = 0; b < 8; b++) decodeBit(p);
                buf[i] = (u8)ctx;
                p = probs[(ctx & 0xFF) >> 6];
            }
        }
        startChunk += chunkSize;
    }
}

}  // namespace kz
