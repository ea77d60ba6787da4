// Transparent-hugepage advice for the big grow-only scratch pools.
//
// The hot inverse walks (BWT mergeTPSI/biPSIv2 LF chains), the SA-IS
// induced-sort passes, and the TPAQ hash tables all gather randomly over
// multi-MB arrays. On 4K pages every gather risks a TLB walk; measured on
// this host class, MADV_HUGEPAGE before first touch makes an 8-cursor
// dependent 20 MB walk 21-24% faster, and MADV_COLLAPSE after the fact
// still yields ~15%. Pools are grow-only, so one advise per growth is
// enough. Best effort by design: on any failure (old kernel, THP disabled)
// the pool simply stays on 4K pages.

#include <cstddef>
#include <cstdlib>

#ifdef __linux__
#include <sys/mman.h>
#endif

#include "kz.h"

#ifndef KZ_THP_DEFAULT
#define KZ_THP_DEFAULT 1
#endif

namespace kz {

#ifdef __linux__

#ifndef MADV_COLLAPSE
#define MADV_COLLAPSE 25  // Linux 6.1+: synchronous collapse to hugepages
#endif

int thpMode() {
    // KANZI_TORCH_THP: 0 = off, 1 = advise before first touch (hugepage faults),
    // 2 = advise + MADV_COLLAPSE after first touch. Default decided by the
    // interleaved A/B/C measurement in docs/ARCHITECTURE.md.
    static const int mode = [] {
        const char* e = getenv("KANZI_TORCH_THP");
        if (e == nullptr || e[0] == '\0') return KZ_THP_DEFAULT;
        return (int)(e[0] - '0');
    }();
    return mode;
}

void adviseHugePages(void* p, size_t bytes) {
    constexpr size_t HUGE_2M = size_t(2) << 20;
    if (thpMode() == 0 || p == nullptr || bytes < 2 * HUGE_2M) return;
    uintptr_t lo = (reinterpret_cast<uintptr_t>(p) + HUGE_2M - 1) & ~(HUGE_2M - 1);
    uintptr_t hi = (reinterpret_cast<uintptr_t>(p) + bytes) & ~(HUGE_2M - 1);
    if (hi <= lo) return;
    (void)madvise(reinterpret_cast<void*>(lo), hi - lo, MADV_HUGEPAGE);
    // Collapse pages the pool already faulted in as 4K (the madvise above
    // only shapes FUTURE faults). EINVAL on pre-6.1 kernels is fine:
    // khugepaged picks the madvised range up in the background instead.
    (void)madvise(reinterpret_cast<void*>(lo), hi - lo, MADV_COLLAPSE);
}

#else

int thpMode() { return 0; }
void adviseHugePages(void*, size_t) {}

#endif

}  // namespace kz
