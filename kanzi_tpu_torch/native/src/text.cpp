// TextCodec: one-pass dictionary word replacement for text blocks.
//
// Format spec: reference v2/transform/TextCodec.go. Two variants:
// - codec1 (for bit-oriented entropy coders): escape tokens 0x0F (word) /
//   0x0E (case-flipped word) + 1-3 byte varint index
// - codec2 (for fast entropy coders): indexes with high-bit markers
//   (10xxxxxx / 110xxxxx / 1111xxxx), 0x80 reserved for case flip
// Both build a dynamic dictionary deterministically; the decoder replays the
// same construction over the encoded stream. CRLF folding optional (mode
// bit). Output starts with the mode byte.

#include <cstring>
#include <memory>
#include <string>

#include "kz.h"
#include "text_dict.h"

namespace kz {

void computeHistogram(const u8* block, i64 len, i32* freqs);
int detectSimpleType(i64 count, const i32* freqs0);
int getMagicType(const u8* src, i64 len);

enum { DT_UNDEFINED = 0, DT_TEXT = 1, DT_BIN = 7, DT_UTF8 = 8 };

static constexpr u8 TC_LF = 0x0A, TC_CR = 0x0D;
static constexpr int TC_THRESHOLD1 = 128;
static constexpr int TC_THRESHOLD2 = TC_THRESHOLD1 * TC_THRESHOLD1;
static constexpr int TC_THRESHOLD3 = 64;
static constexpr int TC_THRESHOLD4 = TC_THRESHOLD3 * 128;
static constexpr int TC_MAX_DICT_SIZE = 1 << 19;
static constexpr int TC_MAX_WORD_LENGTH = 31;
static constexpr int TC_LOG_HASHES_SIZE = 24;
static constexpr int TC_MIN_BLOCK_SIZE = 1024;
static constexpr u8 TC_ESCAPE_TOKEN1 = 0x0F;
static constexpr u8 TC_ESCAPE_TOKEN2 = 0x0E;
static constexpr u8 TC_MASK_FLIP_CASE = 0x80;
static constexpr u8 TC_MASK_NOT_TEXT = 0x80;
static constexpr u8 TC_MASK_CRLF = 0x40;
static constexpr u8 TC_MASK_XML_HTML = 0x20;
static constexpr u8 TC_MASK_DT = 0x0F;
static constexpr i32 TC_MASK_LENGTH = 0x0007FFFF;
static constexpr i32 TC_HASH1 = (i32)2146121005;
static constexpr i32 TC_HASH2 = (i32)-2073254261;

static inline i32 mulI32(i32 a, i32 b) { return (i32)((u32)a * (u32)b); }

static inline bool isLowerCase(u8 v) { return v >= 'a' && v <= 'z'; }
static inline bool isUpperCase(u8 v) { return v >= 'A' && v <= 'Z'; }
static inline bool isText(u8 v) { return isLowerCase(v | 0x20); }

static bool delimChars[256];
static bool delimInit = [] {
    for (int i = 0; i < 256; i++) {
        bool d = (i >= ' ' && i <= '/') || (i >= ':' && i <= '?');
        switch (i) {
            case '\n': case '\r': case '\t': case '_': case '|':
            case '{': case '}': case '[': case ']':
                d = true;
        }
        delimChars[i] = d;
    }
    return true;
}();

static inline bool isDelimiter(u8 v) { return delimChars[v]; }

struct DictEntry {
    const u8* ptr;
    i32 hash;
    i32 data;  // (length << 24) | index
};

// static dictionary, built once
struct StaticDict {
    std::string words;  // lowercased letters
    DictEntry entries[1024];
    int nbWords;

    StaticDict() {
        words = TC_DICT_EN_1024;  // already letters-only
        int anchor = 0;
        i32 h = TC_HASH1;
        nbWords = 0;
        int n = (int)words.size();
        for (int i = 0; i < n && nbWords < 1024; i++) {
            if (isUpperCase((u8)words[i])) {
                if (i > anchor) {
                    entries[nbWords] = {(const u8*)words.data() + anchor, h,
                                        (i32)(((i - anchor) << 24) | nbWords)};
                    nbWords++;
                    anchor = i;
                    h = TC_HASH1;
                }
                words[i] ^= 0x20;
            }
            h = mulI32(h, TC_HASH1) ^ mulI32((i32)(u8)words[i], TC_HASH2);
        }
        if (nbWords < 1024) {
            entries[nbWords] = {(const u8*)words.data() + anchor, h,
                                (i32)(((n - anchor) << 24) | nbWords)};
            nbWords++;
        }
    }
};

static const StaticDict& staticDict() {
    static StaticDict d;
    return d;
}

static const u8 TOKEN2_BYTES[1] = {TC_ESCAPE_TOKEN2};
static const u8 TOKEN1_BYTES[1] = {TC_ESCAPE_TOKEN1};

// ---------------------------------------------------------------------------
// Text stats (reference computeTextStats :187-306)
// ---------------------------------------------------------------------------
static u8 detectTextType(const i32* freqs0, const i32 (*freqs)[256], i64 count) {
    int dt = detectSimpleType(count, freqs0);
    if (dt != DT_UNDEFINED) return TC_MASK_NOT_TEXT | (u8)dt;

    i64 sum = freqs0[0xC0] + freqs0[0xC1];
    for (int i = 0xF5; i < 256; i++) sum += freqs0[i];
    if (sum != 0) return TC_MASK_NOT_TEXT;

    i64 sum2 = 0;
    for (int i = 0; i < 256; i++) {
        if (i < 0xA0 || i > 0xBF) sum += freqs[0xE0][i];
        if (i < 0x80 || i > 0x9F) sum += freqs[0xED][i];
        if (i < 0x90 || i > 0xBF) sum += freqs[0xF0][i];
        if (i < 0x80 || i > 0x8F) sum += freqs[0xF4][i];
        if (i < 0x80 || i > 0xBF) {
            for (int j = 0xC2; j <= 0xDF; j++) sum += freqs[j][i];
            for (int j = 0xE1; j <= 0xEC; j++) sum += freqs[j][i];
            sum += freqs[0xF1][i];
            sum += freqs[0xF2][i];
            sum += freqs[0xF3][i];
            sum += freqs[0xEE][i];
            sum += freqs[0xEF][i];
        } else {
            sum2 += freqs0[i];
        }
        if (sum != 0) return TC_MASK_NOT_TEXT;
    }

    if (sum2 >= count / 8) return TC_MASK_NOT_TEXT | (u8)DT_UTF8;
    return TC_MASK_NOT_TEXT;
}

u8 computeTextStats(const u8* block, i64 count, i32* freqs0,
                    i32 (*freqs1)[256], bool strict) {
    if (!strict && getMagicType(block, count) != 0) return TC_MASK_NOT_TEXT;

    // First pass: order-0 histogram only (4 sub-tables to break the
    // store-forward dependency).  The 256 KiB bigram table is built lazily
    // below — every decision that can be made from freqs0 alone (the
    // not-text gates and detectSimpleType's classification) short-circuits
    // before paying for it, which skips the bigram pass entirely on
    // binary/DNA/multimedia blocks.  Decision order is unchanged, so the
    // results are identical to the reference's single-pass layout.
    std::memset(freqs0, 0, 256 * sizeof(i32));
    {
        i32 f[4][256];
        std::memset(f, 0, sizeof(f));
        i64 end4 = count & ~(i64)3;
        for (i64 i = 0; i < end4; i += 4) {
            f[0][block[i]]++;
            f[1][block[i + 1]]++;
            f[2][block[i + 2]]++;
            f[3][block[i + 3]]++;
        }
        for (i64 i = end4; i < count; i++) f[0][block[i]]++;
        for (int j = 0; j < 256; j++)
            freqs0[j] = f[0][j] + f[1][j] + f[2][j] + f[3][j];
    }
    bool haveFreqs1 = false;
    auto buildFreqs1 = [&]() {
        if (haveFreqs1) return;
        haveFreqs1 = true;
        std::memset(freqs1, 0, 256 * 256 * sizeof(i32));
        u8 prv = 0;
        for (i64 i = 0; i < count; i++) {
            u8 cur = block[i];
            freqs1[prv][cur]++;
            prv = cur;
        }
    };

    i64 nbTextChars = freqs0[TC_CR] + freqs0[TC_LF];
    i64 nbASCII = 0;
    for (int i = 0; i < 128; i++) {
        if (isText((u8)i)) nbTextChars += freqs0[i];
        nbASCII += freqs0[i];
    }

    i64 nbBinChars = count - nbASCII;
    bool notText;
    if (nbBinChars > (count >> 2)) {
        notText = true;
    } else {
        notText = nbTextChars < (count / 4);
        if (strict)
            notText = notText || (freqs0[0] >= count / 100) || ((nbASCII / 95) < (count / 100));
        else
            notText = notText || (freqs0[32] < count / 50);
    }

    u8 res = 0;
    if (notText) {
        // detectTextType's first gate needs only freqs0; the bigram table
        // is required only for its UTF-8 lead/continuation analysis
        int dt = detectSimpleType(count, freqs0);
        if (dt != DT_UNDEFINED) return res | TC_MASK_NOT_TEXT | (u8)dt;
        buildFreqs1();
        return res | detectTextType(freqs0, freqs1, count);
    }

    buildFreqs1();  // the XML and CRLF probes below read bigram rows
    if (nbBinChars <= count - count / 10) {
        i64 f1 = freqs0['<'], f2 = freqs0['>'];
        i64 f3 = freqs1['&']['a'] + freqs1['&']['g'] + freqs1['&']['l'] + freqs1['&']['q'];
        i64 minFreq = (count - nbBinChars) >> 9;
        if (minFreq < 2) minFreq = 2;
        if (f1 >= minFreq && f2 >= minFreq && f3 > 0) {
            if (f1 < f2) {
                if (f1 >= f2 - f2 / 100) res |= TC_MASK_XML_HTML;
            } else if (f2 < f1) {
                if (f2 >= f1 - f1 / 100) res |= TC_MASK_XML_HTML;
            } else {
                res |= TC_MASK_XML_HTML;
            }
        }
    }

    if (freqs0[TC_CR] != 0 && freqs0[TC_CR] == freqs0[TC_LF]) {
        bool isCRLF = true;
        for (int i = 0; i < 256; i++) {
            if (i != TC_LF && freqs1[TC_CR][i] != 0) { isCRLF = false; break; }
            if (i != TC_CR && freqs1[i][TC_LF] != 0) { isCRLF = false; break; }
        }
        if (isCRLF) res |= TC_MASK_CRLF;
    }
    return res;
}

// ---------------------------------------------------------------------------
// Shared codec machinery
// ---------------------------------------------------------------------------
struct TextCodecState {
    std::vector<DictEntry*> dictMap;
    // Go's append() relocates the backing array on expansion while the hash
    // map keeps pointers into the old one; that aliasing is observable in
    // the output, so old generations are kept alive here too.
    std::vector<std::unique_ptr<std::vector<DictEntry>>> gens;
    std::vector<DictEntry>* dictListPtr = nullptr;
    int staticDictSize;
    int dictSize;
    u32 logHashSize;
    i32 hashMask;
    bool isCRLF;
    bool variant2;

    TextCodecState(const Ctx& ctx, bool v2) : variant2(v2) {
        u32 log = 13;
        u32 blockSize = ctx.blockSize > 0 ? (u32)ctx.blockSize : 0;
        if (!v2) {
            if (blockSize >= 8) {
                log = log2_32(blockSize / 8);
                log = std::min(log, 26u);
                log = std::max(log, 13u);
            }
        } else {
            if (blockSize >= 32) {
                log = log2_32(blockSize / 32);
                log = std::min(log, 24u);
                log = std::max(log, 13u);
            }
        }
        if (ctx.entropyType == 9 /* TPAQX */) log++;
        logHashSize = log;
        dictSize = 1 << 13;
        hashMask = (i32)((1u << logHashSize) - 1);
        staticDictSize = staticDict().nbWords;
    }

    std::vector<DictEntry>& dictList() { return *dictListPtr; }

    void reset(i64 count) {
        if (count >= 1024) {
            u32 log = log2_32((u32)(count / 128));
            log = std::min(log, 18u);
            log = std::max(log, 13u);
            dictSize = 1 << log;
        }
        dictMap.assign((size_t)1 << logHashSize, nullptr);
        gens.clear();
        gens.push_back(std::make_unique<std::vector<DictEntry>>(
            dictSize, DictEntry{nullptr, 0, 0}));
        dictListPtr = gens.back().get();
        auto& dl = dictList();
        const StaticDict& sd = staticDict();
        int size = std::min(1024, dictSize);
        for (int i = 0; i < std::min(size, sd.nbWords); i++) dl[i] = sd.entries[i];
        if (!variant2) {
            dl[sd.nbWords] = {TOKEN2_BYTES, 0, (i32)((1 << 24) | sd.nbWords)};
            dl[sd.nbWords + 1] = {TOKEN1_BYTES, 0, (i32)((1 << 24) | (sd.nbWords + 1))};
            staticDictSize = sd.nbWords + 2;
        }
        for (int i = 0; i < staticDictSize; i++)
            dictMap[dl[i].hash & hashMask] = &dl[i];
        for (int i = staticDictSize; i < dictSize; i++)
            dl[i] = {nullptr, 0, (i32)i};
    }

    bool expandDictionary() {
        if (dictSize >= TC_MAX_DICT_SIZE) return false;
        auto next = std::make_unique<std::vector<DictEntry>>(dictList());
        next->resize(dictSize * 2);
        for (int i = dictSize; i < dictSize * 2; i++)
            (*next)[i] = {nullptr, 0, (i32)i};
        gens.push_back(std::move(next));  // old generation stays alive
        dictListPtr = gens.back().get();
        dictSize <<= 1;
        return true;
    }
};

static inline bool sameWords(const u8* a, const u8* b, int n) {
    return std::memcmp(a, b, n) == 0;
}

static int emitWordIndex1(u8* dst, int val) {
    if (val < TC_THRESHOLD1) {
        dst[0] = (u8)val;
        return 1;
    }
    if (val < TC_THRESHOLD2) {
        dst[0] = (u8)(0x80 | (val >> 7));
        dst[1] = (u8)(0x7F & val);
        return 2;
    }
    dst[0] = (u8)(0xE0 | (val >> 14));
    dst[1] = (u8)(0x80 | (val >> 7));
    dst[2] = (u8)(0x7F & val);
    return 3;
}

static int emitWordIndex2(u8* dst, int wIdx) {
    wIdx++;  // 0x80 reserved for case flip
    if (wIdx >= TC_THRESHOLD3) {
        if (wIdx >= TC_THRESHOLD4) {
            dst[0] = (u8)(0xF0 | (wIdx >> 16));
            dst[1] = (u8)(wIdx >> 8);
            dst[2] = (u8)wIdx;
            return 3;
        }
        dst[0] = (u8)(0xC0 | (wIdx >> 8));
        dst[1] = (u8)wIdx;
        return 2;
    }
    dst[0] = (u8)(0x80 | wIdx);
    return 1;
}

static i64 emitSymbols1(TextCodecState& st, const u8* src, i64 n, u8* dst, i64 dstEnd) {
    i64 dstIdx = 0;
    for (i64 k = 0; k < n; k++) {
        u8 cur = src[k];
        if (dstIdx >= dstEnd) return dstEnd + 1;
        if (cur == TC_ESCAPE_TOKEN1 || cur == TC_ESCAPE_TOKEN2) {
            dst[dstIdx++] = TC_ESCAPE_TOKEN1;
            int idx = (cur == TC_ESCAPE_TOKEN1) ? st.staticDictSize - 1
                                                : st.staticDictSize - 2;
            int lenIdx = 2;
            if (idx >= TC_THRESHOLD2) lenIdx = 3;
            else if (idx < TC_THRESHOLD1) lenIdx = 1;
            if (dstIdx + lenIdx >= dstEnd) return dstEnd + 1;
            dstIdx += emitWordIndex1(dst + dstIdx, idx);
        } else if (cur == TC_CR) {
            if (!st.isCRLF) dst[dstIdx++] = cur;
        } else {
            dst[dstIdx++] = cur;
        }
    }
    return dstIdx;
}

static i64 emitSymbols2(TextCodecState& st, const u8* src, i64 n, u8* dst, i64 dstEnd) {
    i64 dstIdx = 0;
    for (i64 k = 0; k < n; k++) {
        u8 cur = src[k];
        if (cur == TC_ESCAPE_TOKEN1) {
            if (dstIdx + 1 >= dstEnd) return dstEnd + 1;
            dst[dstIdx++] = TC_ESCAPE_TOKEN1;
            dst[dstIdx++] = TC_ESCAPE_TOKEN1;
        } else if (cur == TC_CR) {
            if (!st.isCRLF) {
                if (dstIdx >= dstEnd) return dstEnd + 1;
                dst[dstIdx++] = cur;
            }
        } else {
            if (cur >= 0x80) {
                if (dstIdx >= dstEnd) return dstEnd + 1;
                dst[dstIdx++] = TC_ESCAPE_TOKEN1;
            }
            if (dstIdx >= dstEnd) return dstEnd + 1;
            dst[dstIdx++] = cur;
        }
    }
    return dstIdx;
}

// ---------------------------------------------------------------------------
// Forward (both variants share the scan; emission differs)
// ---------------------------------------------------------------------------
int textForward(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (count < TC_MIN_BLOCK_SIZE) return 1;
    if (cap < count) return 1;
    bool v2 = ctx.textCodecVariant == 2;

    int dt = ctx.dataType;
    if (dt != DT_UNDEFINED && dt != DT_TEXT && dt != DT_BIN) return 1;

    std::vector<i32> freqs0(256);
    std::unique_ptr<i32[][256]> freqs1(new i32[256][256]);
    u8 mode = computeTextStats(src, count, freqs0.data(), freqs1.get(), !v2);
    if (mode & TC_MASK_NOT_TEXT) {
        if ((mode & TC_MASK_DT) != DT_UNDEFINED) ctx.dataType = mode & TC_MASK_DT;
        return 1;
    }
    ctx.dataType = DT_TEXT;

    TextCodecState st(ctx, v2);
    st.reset(count);
    const i64 srcEnd = count;
    const i64 dstEnd = count;  // MaxEncodedLen == srcLen
    const i64 dstEndGuard = v2 ? dstEnd - 3 : dstEnd - 4;
    i64 emitAnchor = 0;
    int words = st.staticDictSize;

    st.isCRLF = (mode & TC_MASK_CRLF) != 0;
    dst[0] = mode;
    i64 srcIdx = 0, dstIdx = 1;

    while (srcIdx < srcEnd && src[srcIdx] == ' ') {
        dst[dstIdx++] = ' ';
        srcIdx++;
        emitAnchor++;
    }

    bool failed = false;
    i64 delimAnchor = isText(src[srcIdx]) ? srcIdx - 1 : srcIdx;

    while (srcIdx < srcEnd) {
        if (isText(src[srcIdx])) {
            srcIdx++;
            continue;
        }
        if (srcIdx > delimAnchor + 2 && isDelimiter(src[srcIdx])) {
            i32 length = (i32)(srcIdx - delimAnchor - 1);
            if (length <= TC_MAX_WORD_LENGTH) {
                u8 val = src[delimAnchor + 1];
                i32 h1 = TC_HASH1, h2 = TC_HASH1;
                h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)val, TC_HASH2);
                h2 = mulI32(h2, TC_HASH1) ^ mulI32((i32)val ^ 0x20, TC_HASH2);
                for (i64 i = delimAnchor + 2; i < srcIdx; i++) {
                    i32 h = mulI32((i32)src[i], TC_HASH2);
                    h1 = mulI32(h1, TC_HASH1) ^ h;
                    h2 = mulI32(h2, TC_HASH1) ^ h;
                }

                DictEntry* pe = nullptr;
                DictEntry* pe1 = st.dictMap[h1 & st.hashMask];
                if (pe1 != nullptr && pe1->hash == h1 && (pe1->data >> 24) == length) {
                    pe = pe1;
                } else {
                    DictEntry* pe2 = st.dictMap[h2 & st.hashMask];
                    if (pe2 != nullptr && pe2->hash == h2 && (pe2->data >> 24) == length)
                        pe = pe2;
                }
                if (pe != nullptr &&
                    !sameWords(pe->ptr + 1, src + delimAnchor + 2, length - 1))
                    pe = nullptr;

                if (pe == nullptr) {
                    if ((length > 3 || (length == 3 && words < TC_THRESHOLD2)) &&
                        pe1 == nullptr) {
                        pe = &st.dictList()[words];
                        if ((int)(pe->data & TC_MASK_LENGTH) >= st.staticDictSize) {
                            st.dictMap[pe->hash & st.hashMask] = nullptr;
                            pe->ptr = src + delimAnchor + 1;
                            pe->hash = h1;
                            pe->data = (length << 24) | (i32)words;
                        }
                        st.dictMap[h1 & st.hashMask] = pe;
                        words++;
                        if (words >= st.dictSize) {
                            if (!st.expandDictionary()) words = st.staticDictSize;
                        }
                    }
                } else {
                    if (emitAnchor != delimAnchor || src[delimAnchor] != ' ') {
                        i64 e = v2 ? emitSymbols2(st, src + emitAnchor,
                                                  delimAnchor + 1 - emitAnchor,
                                                  dst + dstIdx, dstEnd - dstIdx)
                                   : emitSymbols1(st, src + emitAnchor,
                                                  delimAnchor + 1 - emitAnchor,
                                                  dst + dstIdx, dstEnd - dstIdx);
                        dstIdx += e;
                    }
                    if (dstIdx >= dstEndGuard) {
                        failed = true;
                        break;
                    }
                    if (!v2) {
                        dst[dstIdx++] = (pe == pe1) ? TC_ESCAPE_TOKEN1 : TC_ESCAPE_TOKEN2;
                        dstIdx += emitWordIndex1(dst + dstIdx,
                                                 (int)(pe->data & TC_MASK_LENGTH));
                    } else {
                        if (pe != pe1) dst[dstIdx++] = TC_MASK_FLIP_CASE;
                        dstIdx += emitWordIndex2(dst + dstIdx,
                                                 (int)(pe->data & TC_MASK_LENGTH));
                    }
                    emitAnchor = delimAnchor + 1 + (i64)(pe->data >> 24);
                }
            }
        }
        delimAnchor = srcIdx;
        srcIdx++;
    }

    if (!failed) {
        i64 e = v2 ? emitSymbols2(st, src + emitAnchor, srcEnd - emitAnchor,
                                  dst + dstIdx, dstEnd - dstIdx)
                   : emitSymbols1(st, src + emitAnchor, srcEnd - emitAnchor,
                                  dst + dstIdx, dstEnd - dstIdx);
        dstIdx += e;
        if (dstIdx > dstEnd) failed = true;
    }
    if (failed || srcIdx != srcEnd) return 1;
    *outLen = (i32)dstIdx;
    return 0;
}

// ---------------------------------------------------------------------------
// Inverse
// ---------------------------------------------------------------------------
static int textInverse1(TextCodecState& st, const u8* src, i32 count, u8* dst,
                        i64 dstEnd, i32* outLen) {
    int words = st.staticDictSize;
    bool wordRun = false;
    st.isCRLF = (src[0] & TC_MASK_CRLF) != 0;
    i64 srcIdx = 1, dstIdx = 0;
    i64 srcEnd = count;
    i64 delimAnchor = isText(src[srcIdx]) ? srcIdx - 1 : srcIdx;

    while (srcIdx < srcEnd && dstIdx < dstEnd) {
        u8 cur = src[srcIdx];
        if (isText(cur)) {
            dst[dstIdx++] = cur;
            srcIdx++;
            continue;
        }

        if (srcIdx > delimAnchor + 3 && isDelimiter(cur)) {
            i32 length = (i32)(srcIdx - delimAnchor - 1);
            if (length <= TC_MAX_WORD_LENGTH) {
                i32 h1 = TC_HASH1;
                h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)src[delimAnchor + 1], TC_HASH2);
                h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)src[delimAnchor + 2], TC_HASH2);
                for (i64 i = delimAnchor + 3; i < srcIdx; i++)
                    h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)src[i], TC_HASH2);

                DictEntry* pe = nullptr;
                DictEntry* pe1 = st.dictMap[h1 & st.hashMask];
                if (pe1 != nullptr && pe1->hash == h1 && (pe1->data >> 24) == length &&
                    sameWords(pe1->ptr + 1, src + delimAnchor + 2, length - 1))
                    pe = pe1;
                if (pe == nullptr) {
                    if ((length > 3 || words < TC_THRESHOLD2) && pe1 == nullptr) {
                        pe = &st.dictList()[words];
                        if ((int)(pe->data & TC_MASK_LENGTH) >= st.staticDictSize) {
                            st.dictMap[pe->hash & st.hashMask] = nullptr;
                            pe->ptr = src + delimAnchor + 1;
                            pe->hash = h1;
                            pe->data = (length << 24) | (i32)words;
                        }
                        st.dictMap[h1 & st.hashMask] = pe;
                        words++;
                        if (words >= st.dictSize) {
                            if (!st.expandDictionary()) words = st.staticDictSize;
                        }
                    }
                }
            }
        }

        srcIdx++;
        if (cur == TC_ESCAPE_TOKEN1 || cur == TC_ESCAPE_TOKEN2) {
            int idx = src[srcIdx++];
            if (idx >= 128) {
                idx &= 0x7F;
                int idx2 = src[srcIdx++];
                if (idx2 >= 0x80) {
                    idx = ((idx & 0x1F) << 7) | (idx2 & 0x7F);
                    idx2 = src[srcIdx++];
                }
                idx = (idx << 7) | idx2;
                if (idx >= st.dictSize) throw Error("text inverse: invalid index");
            }
            DictEntry* pe = &st.dictList()[idx];
            int length = (int)(pe->data >> 24) & 0xFF;

            if (length > 1) {
                if (wordRun) dst[dstIdx++] = ' ';
                wordRun = true;
                delimAnchor = srcIdx;
            } else {
                wordRun = false;
                delimAnchor = srcIdx - 1;
            }
            if (pe->ptr == nullptr || dstIdx + length >= dstEnd)
                throw Error("text inverse: invalid input");
            std::memcpy(dst + dstIdx, pe->ptr, length);
            if (cur == TC_ESCAPE_TOKEN2) dst[dstIdx] ^= 0x20;
            dstIdx += length;
        } else {
            wordRun = false;
            delimAnchor = srcIdx - 1;
            if (st.isCRLF && cur == TC_LF) {
                dst[dstIdx++] = TC_CR;
                if (dstIdx >= dstEnd) throw Error("text inverse: invalid input");
            }
            dst[dstIdx++] = cur;
        }
    }
    if (srcIdx != srcEnd) throw Error("text inverse failed");
    *outLen = (i32)dstIdx;
    return 0;
}

static int textInverse2(TextCodecState& st, const u8* src, i32 count, u8* dst,
                        i64 dstEnd, i32* outLen, bool oldEncoding = false) {
    int words = st.staticDictSize;
    bool wordRun = false;
    st.isCRLF = (src[0] & TC_MASK_CRLF) != 0;
    i64 srcIdx = 1, dstIdx = 0;
    i64 srcEnd = count;
    i64 delimAnchor = isText(src[srcIdx]) ? srcIdx - 1 : srcIdx;

    while (srcIdx < srcEnd && dstIdx < dstEnd) {
        u8 cur = src[srcIdx];
        if (isText(cur)) {
            dst[dstIdx++] = cur;
            srcIdx++;
            continue;
        }

        if (srcIdx > delimAnchor + 3 && isDelimiter(cur)) {
            i32 length = (i32)(srcIdx - delimAnchor - 1);
            if (length <= TC_MAX_WORD_LENGTH) {
                i32 h1 = TC_HASH1;
                h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)src[delimAnchor + 1], TC_HASH2);
                h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)src[delimAnchor + 2], TC_HASH2);
                for (i64 i = delimAnchor + 3; i < srcIdx; i++)
                    h1 = mulI32(h1, TC_HASH1) ^ mulI32((i32)src[i], TC_HASH2);

                DictEntry* pe = nullptr;
                DictEntry* pe1 = st.dictMap[h1 & st.hashMask];
                if (pe1 != nullptr && pe1->hash == h1 && (pe1->data >> 24) == length &&
                    sameWords(pe1->ptr + 1, src + delimAnchor + 2, length - 1))
                    pe = pe1;
                if (pe == nullptr) {
                    if ((length > 3 || words < TC_THRESHOLD2) && pe1 == nullptr) {
                        pe = &st.dictList()[words];
                        if ((int)(pe->data & TC_MASK_LENGTH) >= st.staticDictSize) {
                            st.dictMap[pe->hash & st.hashMask] = nullptr;
                            pe->ptr = src + delimAnchor + 1;
                            pe->hash = h1;
                            pe->data = (length << 24) | (i32)words;
                        }
                        st.dictMap[h1 & st.hashMask] = pe;
                        words++;
                        if (words >= st.dictSize) {
                            if (!st.expandDictionary()) words = st.staticDictSize;
                        }
                    }
                }
            }
        }

        srcIdx++;
        u8 flipMask = 0;
        if (cur >= 128) {
            int idx;
            if (oldEncoding) {
                // legacy v<6 word index: 5 bits in the marker byte + flip
                // bit 0x20 + continuation bit 0x40 with 1-2 extra 7-bit
                // groups (reference TextCodec.go:1596-1617); no -1 adjust
                idx = cur & 0x1F;
                flipMask = cur & 0x20;
                if (cur & 0x40) {
                    int idx2 = src[srcIdx++];
                    if (idx2 >= 128) {
                        idx = (idx << 7) | (idx2 & 0x7F);
                        idx2 = src[srcIdx++];
                    }
                    idx = (idx << 7) | idx2;
                    if (idx >= st.dictSize)
                        throw Error("text inverse: invalid index");
                }
            } else {
            if (cur == TC_MASK_FLIP_CASE) {
                flipMask = 0x20;
                cur = src[srcIdx++];
            }
            idx = cur & 0x7F;
            if (idx >= 64) {
                if (idx >= 112) {
                    idx = ((idx & 0x0F) << 16) | ((int)src[srcIdx] << 8) | src[srcIdx + 1];
                    srcIdx += 2;
                } else {
                    idx = ((idx & 0x1F) << 8) | src[srcIdx];
                    srcIdx++;
                }
                if (idx > st.dictSize) throw Error("text inverse: invalid index");
            } else {
                if (idx == 0) throw Error("text inverse: invalid index");
            }
            idx--;
            }

            DictEntry* pe = &st.dictList()[idx];
            int length = (int)(pe->data >> 24) & 0xFF;
            if (length > 1) {
                if (wordRun) dst[dstIdx++] = ' ';
                wordRun = true;
                delimAnchor = srcIdx;
            } else {
                wordRun = false;
                delimAnchor = srcIdx - 1;
            }
            if (pe->ptr == nullptr || dstIdx + length >= dstEnd)
                throw Error("text inverse: invalid input");
            std::memcpy(dst + dstIdx, pe->ptr, length);
            dst[dstIdx] ^= flipMask;
            dstIdx += length;
        } else {
            if (cur == TC_ESCAPE_TOKEN1) {
                dst[dstIdx++] = src[srcIdx++];
            } else {
                if (st.isCRLF && cur == TC_LF) {
                    dst[dstIdx++] = TC_CR;
                    if (dstIdx >= dstEnd) throw Error("text inverse: invalid input");
                }
                dst[dstIdx++] = cur;
            }
            wordRun = false;
            delimAnchor = srcIdx - 1;
        }
    }
    if (srcIdx != srcEnd) throw Error("text inverse failed");
    *outLen = (i32)dstIdx;
    return 0;
}

int textInverse(const u8* src, i32 count, u8* dst, i64 cap, Ctx& ctx, i32* outLen) {
    if (count < 2) throw Error("text inverse: block too small");
    bool v2 = ctx.textCodecVariant == 2;
    TextCodecState st(ctx, v2);
    // the reference sizes the dynamic dictionary from the *output* buffer
    // length on inverse (v2/transform/TextCodec.go:956,1514)
    st.reset(cap);
    if (v2)
        return textInverse2(st, src, count, dst, cap, outLen,
                            ctx.bsVersion > 0 && ctx.bsVersion < 6);
    return textInverse1(st, src, count, dst, cap, outLen);
}

}  // namespace kz
