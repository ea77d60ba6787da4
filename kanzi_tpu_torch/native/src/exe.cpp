// EXE codec: rewrites relative branch targets into absolute addresses to
// improve entropy coding of machine code.
//
// Format spec: reference v2/transform/EXECodec.go.
// X86: E8/E9 CALL/JMP and 0x0F8x Jcc rel32 -> big-endian absolute address
// XOR 0xF0F0F0F0, with 0x9B escape for false positives.
// ARM64: B/BL 26-bit immediates -> absolute (0-address doubles as escape).
// Header: mode byte + 4-byte codeStart + 4-byte dstIdx (little-endian).
// Executable detection: ELF/PE/Mach-O header parsing or an opcode-density
// heuristic.

#include "kz.h"

namespace kz {

int detectSimpleType(i64 count, const i32* freqs0);
int getMagicType(const u8* src, i64 len);

enum { DT_UNDEFINED = 0, DT_EXE = 3, DT_BIN = 7 };

static constexpr u8 X86_MASK_JUMP = 0xFE;
static constexpr u8 X86_INSTRUCTION_JUMP = 0xE8;
static constexpr u8 X86_INSTRUCTION_JCC = 0x80;
static constexpr u8 X86_TWO_BYTE_PREFIX = 0x0F;
static constexpr u8 X86_MASK_JCC = 0xF0;
static constexpr u8 X86_ESCAPE = 0x9B;
static constexpr u8 EXE_NOT_EXE = 0x80;
static constexpr u8 EXE_X86 = 0x40;
static constexpr u8 EXE_ARM64 = 0x20;
static constexpr u8 EXE_MASK_DT = 0x0F;
static constexpr int X86_ADDR_MASK = (1 << 24) - 1;
static constexpr u32 MASK_ADDRESS = 0xF0F0F0F0;
static constexpr int ARM_B_ADDR_MASK = (1 << 26) - 1;
static constexpr int ARM_B_OPCODE_MASK = (int)(0xFFFFFFFF ^ ARM_B_ADDR_MASK);
static constexpr int ARM_B_ADDR_SGN_MASK = 1 << 25;
static constexpr int ARM_OPCODE_B = 0x14000000;
static constexpr int ARM_OPCODE_BL = (int)0x94000000;
static constexpr int ARM_CB_REG_BITS = 5;
static constexpr int ARM_CB_ADDR_MASK = 0x00FFFFE0;
static constexpr int ARM_CB_OPCODE_MASK = 0x7F000000;
static constexpr int ARM_OPCODE_CBZ = 0x34000000;
static constexpr int ARM_OPCODE_CBNZ = 0x3500000;
static constexpr int EXE_MIN_BLOCK_SIZE = 4096;
static constexpr int EXE_MAX_BLOCK_SIZE = (1 << 28) - 1;

static inline u32 exeLe32(const u8* p) {
    u32 v;
    std::memcpy(&v, p, 4);
    return v;
}
static inline u16 exeLe16(const u8* p) {
    u16 v;
    std::memcpy(&v, p, 2);
    return v;
}
static inline u64 exeLe64(const u8* p) {
    u64 v;
    std::memcpy(&v, p, 8);
    return v;
}
static inline u32 exeBe32(const u8* p) {
    return ((u32)p[0] << 24) | ((u32)p[1] << 16) | ((u32)p[2] << 8) | p[3];
}
static inline u16 exeBe16(const u8* p) { return (u16)((p[0] << 8) | p[1]); }
static inline u64 exeBe64(const u8* p) {
    return ((u64)exeBe32(p) << 32) | exeBe32(p + 4);
}
static inline void putLe32(u8* p, u32 v) { std::memcpy(p, &v, 4); }
static inline void putBe32(u8* p, u32 v) {
    p[0] = (u8)(v >> 24);
    p[1] = (u8)(v >> 16);
    p[2] = (u8)(v >> 8);
    p[3] = (u8)v;
}

// Returns true if a known executable header was found (reference
// parseExeHeader :812-1021).
static bool parseExeHeader(const u8* src, i64 count, int magic, int* arch,
                           i64* codeStart, i64* codeEnd) {
    if ((u32)magic == 0x4D5Au) {  // WIN / PE
        if (count >= 64) {
            i64 posPE = exeLe32(src + 60);
            if (posPE > 0 && posPE <= count - 48 && exeLe32(src + posPE) == 0x00004550u) {
                *codeStart = std::min((i64)exeLe32(src + posPE + 44), count);
                *codeEnd = std::min(*codeStart + (i64)exeLe32(src + posPE + 28), count);
                *arch = exeLe16(src + posPE + 4);
            }
            return true;
        }
    } else if ((u32)magic == 0x7F454C46u) {  // ELF
        bool le = src[5] == 1;
        if (count >= 64) {
            *codeStart = 0;
            auto rd16 = [&](i64 o) { return le ? exeLe16(src + o) : exeBe16(src + o); };
            auto rd32 = [&](i64 o) { return le ? exeLe32(src + o) : exeBe32(src + o); };
            auto rd64 = [&](i64 o) { return le ? exeLe64(src + o) : exeBe64(src + o); };
            if (src[4] == 2) {  // 64-bit
                int nbEntries = rd16(0x3C);
                int szEntry = rd16(0x3A);
                i64 posSection = (i64)rd64(0x28);
                for (int i = 0; i < nbEntries; i++) {
                    i64 startEntry = posSection + (i64)i * szEntry;
                    if (startEntry < 0 || startEntry + 0x28 >= count) return false;
                    u32 typeSection = rd32(startEntry + 4);
                    i64 offSection = (i64)rd64(startEntry + 0x18);
                    i64 lenSection = (i64)rd64(startEntry + 0x20);
                    if (typeSection == 1 && lenSection >= 64) {
                        if (*codeStart == 0) *codeStart = offSection;
                        *codeEnd = offSection + lenSection;
                    }
                }
            } else {  // 32-bit
                int nbEntries = rd16(0x30);
                int szEntry = rd16(0x2E);
                i64 posSection = rd32(0x20);
                for (int i = 0; i < nbEntries; i++) {
                    i64 startEntry = posSection + (i64)i * szEntry;
                    if (startEntry < 0 || startEntry + 0x18 >= count) return false;
                    u32 typeSection = rd32(startEntry + 4);
                    i64 offSection = rd32(startEntry + 0x10);
                    i64 lenSection = rd32(startEntry + 0x14);
                    if (typeSection == 1 && lenSection >= 64) {
                        if (*codeStart == 0) *codeStart = offSection;
                        *codeEnd = offSection + lenSection;
                    }
                }
            }
            *arch = rd16(18);
            *codeStart = std::min(*codeStart, count);
            *codeEnd = std::min(*codeEnd, count);
            return true;
        }
    } else if ((u32)magic == 0xFEEDFACEu || (u32)magic == 0xCEFAEDFEu ||
               (u32)magic == 0xFEEDFACFu || (u32)magic == 0xCFFAEDFEu) {  // Mach-O
        bool is64 = (u32)magic == 0xFEEDFACFu || (u32)magic == 0xCFFAEDFEu;
        *codeStart = 0;
        if (count >= 64) {
            u32 mode = exeLe32(src + 12);
            if (mode != 0x02) return false;  // MH_EXECUTE
            *arch = (int)exeLe32(src + 4);
            int nbCmds = (int)exeLe32(src + 0x10);
            int cmd = 0;
            i64 pos = is64 ? 0x20 : 0x1C;
            while (cmd < nbCmds) {
                if (pos + 8 > count) return false;
                u32 ldCmd = exeLe32(src + pos);
                u32 szCmd = exeLe32(src + pos + 4);
                i64 szSegHdr = is64 ? 0x48 : 0x38;
                if (ldCmd == 0x01 || ldCmd == 0x19) {  // LC_SEGMENT(64)
                    if (pos + 14 >= count) return false;
                    u64 nameSegment = exeBe64(src + pos + 8) >> 16;
                    if (nameSegment == 0x5F5F54455854ull) {
                        i64 posSection = pos + szSegHdr;
                        if (posSection + 0x34 >= count) return false;
                        u64 nameSection = exeBe64(src + posSection) >> 16;
                        if (nameSection == 0x5F5F74657874ull) {
                            if (is64) {
                                *codeStart = (i32)exeLe64(src + posSection + 0x30);
                                *codeEnd = *codeStart + (i32)exeLe32(src + posSection + 0x28);
                            } else {
                                *codeStart = (i32)exeLe32(src + posSection + 0x2C);
                                *codeEnd = *codeStart + (i32)exeLe32(src + posSection + 0x28);
                            }
                            break;
                        }
                    }
                }
                cmd++;
                pos += szCmd;
                if (szCmd == 0) return false;
            }
            *codeStart = std::min(*codeStart, count);
            *codeEnd = std::min(*codeEnd, count);
            return true;
        }
    }
    return false;
}

// reference detectExeType :710-809; src has length codeEnd+4
static u8 detectExeType(const u8* src, i64 srcLen, i64* codeStart, i64* codeEnd) {
    int magic = getMagicType(src, srcLen);
    int arch = 0;

    if (parseExeHeader(src, srcLen, magic, &arch, codeStart, codeEnd)) {
        switch (arch) {
            case 0x03: case 0x3E:                 // ELF x86/amd64
            case 0x014C: case 0x8664:             // PE x86/amd64
            case 0x01000007:                      // Mach-O amd64
                return EXE_X86;
            case 0xB7: case 0xAA64:               // ELF/PE arm64
            case 0x0100000C:                      // Mach-O arm64
                return EXE_ARM64;
        }
    }

    i64 jumpsX86 = 0, jumpsARM64 = 0;
    i64 count = *codeEnd - *codeStart;
    i32 histo[256] = {0};

    for (i64 i = *codeStart; i < *codeEnd; i++) {
        histo[src[i]]++;
        if ((src[i] & X86_MASK_JUMP) == X86_INSTRUCTION_JUMP) {
            if (src[i + 4] == 0 || src[i + 4] == 0xFF) {
                jumpsX86++;
                continue;
            }
        } else if (src[i] == X86_TWO_BYTE_PREFIX) {
            i++;
            if (src[i] == 0x38 || src[i] == 0x3A) i++;
            if ((src[i] & X86_MASK_JCC) == X86_INSTRUCTION_JCC) {
                jumpsX86++;
                continue;
            }
        }
        if ((i & 3) != 0) continue;
        int instr = (int)exeLe32(src + i);
        int opcode1 = instr & ARM_B_OPCODE_MASK;
        int opcode2 = instr & ARM_CB_OPCODE_MASK;
        if (opcode1 == ARM_OPCODE_B || opcode1 == ARM_OPCODE_BL ||
            opcode2 == ARM_OPCODE_CBZ || opcode2 == ARM_OPCODE_CBNZ)
            jumpsARM64++;
    }

    int dt = detectSimpleType(count, histo);
    if (dt != DT_BIN) return EXE_NOT_EXE | (u8)dt;

    i64 smallVals = 0;
    for (int i = 0; i < 16; i++) smallVals += histo[i];
    if (histo[0] < count / 10 || smallVals > count / 2 || histo[255] < count / 100)
        return EXE_NOT_EXE | (u8)dt;

    if (jumpsX86 >= count / 200) return EXE_X86;
    if (jumpsARM64 >= count / 200) return EXE_ARM64;
    return EXE_NOT_EXE | (u8)dt;
}

static int forwardX86(const u8* src, i64 count, u8* dst, i64 cap,
                      i64 codeStart, i64 codeEnd, i32* outLen) {
    i64 srcIdx = codeStart;
    i64 dstIdx = 9;
    int matches = 0;
    i64 dstEnd = cap - 5;
    dst[0] = EXE_X86;
    bool boundaryReached = false;

    if (codeStart < 0 || codeEnd < codeStart || codeEnd > count) return 1;
    if (codeStart > 0) {
        std::memcpy(dst + dstIdx, src, codeStart);
        dstIdx += codeStart;
    }

    while (srcIdx < codeEnd && dstIdx < dstEnd) {
        if (src[srcIdx] == X86_TWO_BYTE_PREFIX) {
            if (srcIdx + 1 >= codeEnd) {
                boundaryReached = true;
                break;
            }
            if ((src[srcIdx + 1] & X86_MASK_JCC) == X86_INSTRUCTION_JCC) {
                if (srcIdx + 5 >= codeEnd) {
                    boundaryReached = true;
                    break;
                }
            }
            dst[dstIdx++] = src[srcIdx++];
            if ((src[srcIdx] & X86_MASK_JCC) != X86_INSTRUCTION_JCC) {
                if (src[srcIdx] == X86_ESCAPE) dst[dstIdx++] = X86_ESCAPE;
                dst[dstIdx++] = src[srcIdx++];
                continue;
            }
            if (srcIdx + 4 >= codeEnd) {
                boundaryReached = true;
                break;
            }
        } else if ((src[srcIdx] & X86_MASK_JUMP) != X86_INSTRUCTION_JUMP) {
            if (src[srcIdx] == X86_ESCAPE) dst[dstIdx++] = X86_ESCAPE;
            dst[dstIdx++] = src[srcIdx++];
            continue;
        } else if (srcIdx + 4 >= codeEnd) {
            boundaryReached = true;
            break;
        }

        u8 sgn = src[srcIdx + 4];
        int offset = (int)exeLe32(src + srcIdx + 1);
        if ((sgn != 0 && sgn != 0xFF) || (u32)offset == 0xFF000000u) {
            dst[dstIdx] = X86_ESCAPE;
            dst[dstIdx + 1] = src[srcIdx];
            srcIdx++;
            dstIdx += 2;
            continue;
        }

        i64 addr = srcIdx;
        if (sgn == 0)
            addr += offset;
        else
            addr -= (-offset & X86_ADDR_MASK);

        dst[dstIdx] = src[srcIdx];
        putBe32(dst + dstIdx + 1, (u32)addr ^ MASK_ADDRESS);
        srcIdx += 5;
        dstIdx += 5;
        matches++;
    }

    if (matches < 16) return 1;
    if (srcIdx < codeEnd && !boundaryReached) return 1;
    if (dstIdx + (count - srcIdx) > dstEnd) return 1;

    putLe32(dst + 1, (u32)codeStart);
    putLe32(dst + 5, (u32)dstIdx);
    std::memcpy(dst + dstIdx, src + srcIdx, count - srcIdx);
    dstIdx += count - srcIdx;
    if (dstIdx > count + count / 50) return 1;
    *outLen = (i32)dstIdx;
    return 0;
}

static int forwardARM(const u8* src, i64 count, u8* dst, i64 cap,
                      i64 codeStart, i64 codeEnd, i32* outLen) {
    i64 srcIdx = codeStart;
    i64 dstIdx = 9;
    int matches = 0;
    i64 dstEnd = cap - 8;
    dst[0] = EXE_ARM64;

    if (codeStart < 0 || codeEnd < codeStart || codeEnd > count) return 1;
    if (codeStart > 0) {
        std::memcpy(dst + dstIdx, src, codeStart);
        dstIdx += codeStart;
    }

    while (srcIdx + 4 <= codeEnd && dstIdx < dstEnd) {
        int instr = (int)exeLe32(src + srcIdx);
        int opcode1 = instr & ARM_B_OPCODE_MASK;
        bool isBL = opcode1 == ARM_OPCODE_B || opcode1 == ARM_OPCODE_BL;

        if (!isBL) {
            std::memcpy(dst + dstIdx, src + srcIdx, 4);
            srcIdx += 4;
            dstIdx += 4;
            continue;
        }

        i64 addr;
        int offset = instr & ARM_B_ADDR_MASK;
        if ((instr & ARM_B_ADDR_SGN_MASK) == 0)
            addr = srcIdx + 4 * (i64)offset;
        else
            addr = srcIdx - 4 * (i64)(-offset & ARM_B_ADDR_MASK);
        if (addr < 0) addr = 0;
        int val = opcode1 | (int)(addr >> 2);

        if (addr == 0) {
            putLe32(dst + dstIdx, (u32)val);  // 0 address as escape
            std::memcpy(dst + dstIdx + 4, src + srcIdx, 4);
            srcIdx += 4;
            dstIdx += 8;
            continue;
        }

        putLe32(dst + dstIdx, (u32)val);
        srcIdx += 4;
        dstIdx += 4;
        matches++;
    }

    if (matches < 16) return 1;
    if ((srcIdx + 4 <= codeEnd && dstIdx >= dstEnd) || dstIdx + (count - srcIdx) > dstEnd)
        return 1;

    putLe32(dst + 1, (u32)codeStart);
    putLe32(dst + 5, (u32)dstIdx);
    std::memcpy(dst + dstIdx, src + srcIdx, count - srcIdx);
    dstIdx += count - srcIdx;
    if (dstIdx > count + count / 50) return 1;
    *outLen = (i32)dstIdx;
    return 0;
}

int exeForward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (count < EXE_MIN_BLOCK_SIZE) return 1;
    if (count > EXE_MAX_BLOCK_SIZE) return 1;
    i64 required = count <= 256 ? count + 32 : count + count / 8;
    if (cap < required) return 1;

    int dt = ctx.dataType;
    if (dt != DT_UNDEFINED && dt != DT_EXE && dt != DT_BIN) return 1;

    i64 codeStart = 0;
    i64 codeEnd = count - 8;
    u8 mode = detectExeType(src, codeEnd + 4, &codeStart, &codeEnd);

    if (mode & EXE_NOT_EXE) {
        ctx.dataType = mode & EXE_MASK_DT;
        return 1;
    }
    mode &= ~EXE_MASK_DT;

    int res;
    if (mode == EXE_X86)
        res = forwardX86(src, count, dst, cap, codeStart, codeEnd, outLen);
    else if (mode == EXE_ARM64)
        res = forwardARM(src, count, dst, cap, codeStart, codeEnd, outLen);
    else
        return 1;

    if (res == 0) ctx.dataType = DT_EXE;
    return res;
}

static int inverseX86(const u8* src, i64 count, u8* dst, i64 cap, i32* outLen) {
    i64 srcIdx = 9;
    i64 dstIdx = 0;
    i64 codeStart = exeLe32(src + 1);
    i64 codeEnd = exeLe32(src + 5);

    if (codeStart < 0 || codeEnd < srcIdx || codeEnd > count ||
        codeStart > codeEnd - srcIdx || codeStart > cap - dstIdx)
        throw Error("EXE inverse: invalid data");

    if (codeStart > 0) {
        std::memcpy(dst + dstIdx, src + srcIdx, codeStart);
        dstIdx += codeStart;
        srcIdx += codeStart;
    }

    while (srcIdx < codeEnd) {
        if (src[srcIdx] == X86_TWO_BYTE_PREFIX) {
            if (srcIdx + 1 >= codeEnd) {
                if (dstIdx >= cap) throw Error("EXE inverse: invalid data");
                dst[dstIdx++] = src[srcIdx++];
                break;
            }
            if (dstIdx >= cap) throw Error("EXE inverse: invalid data");
            dst[dstIdx++] = src[srcIdx++];
            if ((src[srcIdx] & X86_MASK_JCC) != X86_INSTRUCTION_JCC) {
                if (src[srcIdx] == X86_ESCAPE) {
                    srcIdx++;
                    if (srcIdx >= codeEnd) throw Error("EXE inverse: invalid data");
                }
                if (dstIdx >= cap) throw Error("EXE inverse: invalid data");
                dst[dstIdx++] = src[srcIdx++];
                continue;
            }
        } else if ((src[srcIdx] & X86_MASK_JUMP) != X86_INSTRUCTION_JUMP) {
            if (src[srcIdx] == X86_ESCAPE) {
                srcIdx++;
                if (srcIdx >= codeEnd) throw Error("EXE inverse: invalid data");
            }
            if (dstIdx >= cap) throw Error("EXE inverse: invalid data");
            dst[dstIdx++] = src[srcIdx++];
            continue;
        }

        if (srcIdx + 4 >= codeEnd) throw Error("EXE inverse: invalid data");
        if (dstIdx + 5 > cap) throw Error("EXE inverse: invalid data");

        i64 addr = (i64)(exeBe32(src + srcIdx + 1) ^ MASK_ADDRESS);
        i64 offset = addr - dstIdx;
        dst[dstIdx++] = src[srcIdx++];
        if (offset >= 0)
            putLe32(dst + dstIdx, (u32)offset);
        else
            putLe32(dst + dstIdx, (u32)(-(-offset & X86_ADDR_MASK)));
        srcIdx += 4;
        dstIdx += 4;
    }

    if (dstIdx + (count - srcIdx) > cap) throw Error("EXE inverse: invalid data");
    if (srcIdx < count) {
        std::memcpy(dst + dstIdx, src + srcIdx, count - srcIdx);
        dstIdx += count - srcIdx;
    }
    *outLen = (i32)dstIdx;
    return 0;
}

static int inverseARM(const u8* src, i64 count, u8* dst, i64 cap, i32* outLen) {
    i64 srcIdx = 9;
    i64 dstIdx = 0;
    i64 codeStart = exeLe32(src + 1);
    i64 codeEnd = exeLe32(src + 5);

    if (codeStart < 0 || codeEnd < srcIdx || codeEnd > count ||
        codeStart > codeEnd - srcIdx || codeStart > cap - dstIdx)
        throw Error("EXE inverse: invalid data");

    if (codeStart > 0) {
        std::memcpy(dst + dstIdx, src + srcIdx, codeStart);
        dstIdx += codeStart;
        srcIdx += codeStart;
    }

    while (srcIdx < codeEnd) {
        if (srcIdx + 4 > codeEnd) throw Error("EXE inverse: invalid data");
        if (dstIdx + 4 > cap) throw Error("EXE inverse: invalid data");

        int instr = (int)exeLe32(src + srcIdx);
        int opcode1 = instr & ARM_B_OPCODE_MASK;
        bool isBL = opcode1 == ARM_OPCODE_B || opcode1 == ARM_OPCODE_BL;

        if (!isBL) {
            std::memcpy(dst + dstIdx, src + srcIdx, 4);
            srcIdx += 4;
            dstIdx += 4;
            continue;
        }

        i64 addr = (i64)(instr & ARM_B_ADDR_MASK) << 2;
        i64 offset = (addr - dstIdx) >> 2;
        int val = opcode1 | ((int)offset & ARM_B_ADDR_MASK);

        if (addr == 0) {
            if (srcIdx + 8 > codeEnd) throw Error("EXE inverse: invalid data");
            std::memcpy(dst + dstIdx, src + srcIdx + 4, 4);
            srcIdx += 8;
            dstIdx += 4;
            continue;
        }
        putLe32(dst + dstIdx, (u32)val);
        srcIdx += 4;
        dstIdx += 4;
    }

    if (dstIdx + (count - srcIdx) > cap) throw Error("EXE inverse: invalid data");
    if (srcIdx < count) {
        std::memcpy(dst + dstIdx, src + srcIdx, count - srcIdx);
        dstIdx += count - srcIdx;
    }
    *outLen = (i32)dstIdx;
    return 0;
}

// bsVersion < 3 format (EXECodec.go:451-505): no mode byte, X86-only jump
// rewriting with 0xD5-xored address bytes and an 0xF5 escape
static int inverseV2Exe(const u8* src, i64 count, u8* dst, i64 cap, i32* outLen) {
    if (count > cap) throw Error("EXE inverse: invalid data");
    i64 srcIdx = 0, dstIdx = 0;
    i64 end = count - 8;
    while (srcIdx < end) {
        dst[dstIdx++] = src[srcIdx++];
        if ((src[srcIdx - 1] & X86_MASK_JUMP) != X86_INSTRUCTION_JUMP)
            continue;
        if (src[srcIdx] == 0xF5) {  // escaped: not an encoded address
            srcIdx++;
            continue;
        }
        u8 sgn = (u8)(src[srcIdx] - 1);
        if (sgn != 0 && sgn != 0xFF) continue;  // false positive
        i32 addr = (i32)((0xD5 ^ (u32)src[srcIdx + 3]) |
                         ((0xD5 ^ (u32)src[srcIdx + 2]) << 8) |
                         ((0xD5 ^ (u32)src[srcIdx + 1]) << 16) |
                         ((0xFFu & (u32)sgn) << 24));
        addr -= (i32)dstIdx;
        dst[dstIdx] = (u8)addr;
        dst[dstIdx + 1] = (u8)(addr >> 8);
        dst[dstIdx + 2] = (u8)(addr >> 16);
        dst[dstIdx + 3] = sgn;
        srcIdx += 4;
        dstIdx += 4;
    }
    while (srcIdx < count) dst[dstIdx++] = src[srcIdx++];
    *outLen = (i32)dstIdx;
    return 0;
}

int exeInverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (ctx.bsVersion > 0 && ctx.bsVersion < 3)  // EXECodec.go:101,312
        return inverseV2Exe(src, count, dst, cap, outLen);
    if (count < 9) throw Error("EXE inverse: invalid data");
    u8 mode = src[0];
    if (mode == EXE_X86) return inverseX86(src, count, dst, cap, outLen);
    if (mode == EXE_ARM64) return inverseARM(src, count, dst, cap, outLen);
    throw Error("EXE inverse: unknown binary type");
}

}  // namespace kz
