// File-magic detection (reference: v2/internal/Magic.go).
#include "kz.h"

namespace kz {

int getMagicType(const u8* src, i64 len) {
    if (len < 4) return 0;
    u32 key = ((u32)src[0] << 24) | ((u32)src[1] << 16) | ((u32)src[2] << 8) | src[3];
    if ((key & ~0x0Fu) == 0xFFD8FFE0u) return (int)key;  // JPG
    u32 k24 = key >> 8;
    if (k24 == 0x425A68u || k24 == 0x494433u) return (int)k24;  // BZIP2, MP3
    static const u32 KEYS32[] = {
        0x47494638u, 0x25504446u, 0x504B0304u, 0x377ABCAFu, 0x89504E47u,
        0x7F454C46u, 0xFEEDFACEu, 0xCEFAEDFEu, 0xFEEDFACFu, 0xCFFAEDFEu,
        0x28B52FFDu, 0x81CFB2CEu, 0x4D534346u, 0x52494646u, 0x664C6143u,
        0xFD377A58u, 0x4B414E5Au, 0x52617221u,
    };
    for (u32 k : KEYS32)
        if (key == k) return (int)key;
    u32 key16 = key >> 16;
    static const u32 KEYS16[] = {0x1F8Bu, 0x424Du, 0x4D5Au};
    for (u32 k : KEYS16)
        if (key16 == k) return (int)key16;
    if (key16 == 0x5034u || key16 == 0x5035u || key16 == 0x5036u) {
        u32 subkey = (key >> 8) & 0xFF;
        if (subkey == 0x07 || subkey == 0x0A || subkey == 0x0D || subkey == 0x20)
            return (int)key16;
    }
    return 0;
}

bool isDataCompressedMagic(int magic) {
    switch ((u32)magic) {
        case 0xFFD8FFE0u: case 0x47494638u: case 0x89504E47u: case 0x377ABCAFu:
        case 0x28B52FFDu: case 0x81CFB2CEu: case 0x4D534346u: case 0x504B0304u:
        case 0x1F8Bu: case 0x425A68u: case 0x664C6143u: case 0x494433u:
        case 0xFD377A58u: case 0x4B414E5Au: case 0x52617221u:
            return true;
    }
    return false;
}

bool isDataMultimediaMagic(int magic) {
    switch ((u32)magic) {
        case 0xFFD8FFE0u: case 0x47494638u: case 0x89504E47u: case 0x52494646u:
        case 0x664C6143u: case 0x494433u: case 0x424Du: case 0x5034u:
        case 0x5035u: case 0x5036u:
            return true;
    }
    return false;
}

bool isDataExecutableMagic(int magic) {
    switch ((u32)magic) {
        case 0x7F454C46u: case 0x4D5Au: case 0xFEEDFACEu: case 0xCEFAEDFEu:
        case 0xFEEDFACFu: case 0xCFFAEDFEu:
            return true;
    }
    return false;
}

}  // namespace kz
