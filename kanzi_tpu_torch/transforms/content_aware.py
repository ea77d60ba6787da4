"""Content-aware transforms backed by the native runtime: TEXT (dictionary
word replacement), UTF (codepoint aliasing), MM/FSD (fixed-step delta for
multimedia), EXE (branch-target rewriting), ROLZ/ROLZX (reduced-offset LZ).

These are the branchy, data-dependent codecs (reference: v2/transform/
TextCodec.go, UTFCodec.go, FSDCodec.go, EXECodec.go, ROLZCodec.go). A
transform that vetoes (wrong data type, no gain) raises TransformSkip; the
skip bit lands in the block's skip-flags byte and decode passes through.
"""

from __future__ import annotations

import numpy as np

from .base import Transform, TransformSkip
from .. import native


class _NativeOrSkip(Transform):
    """Tries the native implementation; vetoes (skip) if not available."""

    ttype = -1

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 1024

    def _inverse_cap(self, src_len: int) -> int:
        block = int(self.ctx.get("blockSize", 4 * 1024 * 1024))
        return max(block + max(512, block >> 4) + 16, src_len + 1024)

    def forward(self, src: np.ndarray) -> np.ndarray:
        cap = max(self.max_encoded_len(len(src)),
                  getattr(self, "seq_required", 0))
        try:
            out, self.ctx = native.transform_forward(self.ttype, src, self.ctx, cap)
        except (native.NativeSkip, RuntimeError):
            raise TransformSkip()
        return np.frombuffer(out, dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        out = native.transform_inverse(self.ttype, src, self.ctx,
                                       self._inverse_cap(len(src)))
        return np.frombuffer(out, dtype=np.uint8)


class TextCodec(_NativeOrSkip):
    """Dictionary word replacement (reference: v2/transform/TextCodec.go)."""
    name = "TEXT"
    ttype = 10

    def max_encoded_len(self, src_len: int) -> int:
        return src_len  # reference: v2/transform/TextCodec.go:1118-1122


class UTFCodec(_NativeOrSkip):
    """UTF-8 codepoint aliasing (reference: v2/transform/UTFCodec.go)."""
    name = "UTF"
    ttype = 17

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 8192


class FSDCodec(_NativeOrSkip):
    """Fixed-step delta for multimedia (reference: v2/transform/FSDCodec.go)."""
    name = "MM"
    ttype = 15

    def max_encoded_len(self, src_len: int) -> int:
        # reference: v2/transform/FSDCodec.go:122-125
        return src_len + max(src_len >> 4, 64)


class EXECodec(_NativeOrSkip):
    """x86/ARM64 branch-target rewriting (reference: v2/transform/EXECodec.go)."""
    name = "EXE"
    ttype = 9

    def max_encoded_len(self, src_len: int) -> int:
        # reference: v2/transform/EXECodec.go:701-708
        return src_len + 32 if src_len <= 256 else src_len + src_len // 8


class ROLZCodec(_NativeOrSkip):
    """Reduced-offset LZ (reference: v2/transform/ROLZCodec.go)."""
    name = "ROLZ"
    ttype = 11

    def __init__(self, ctx: dict, extra: bool = False):
        super().__init__(ctx)
        self.extra = extra
        self.ttype = 12 if extra else 11

    def max_encoded_len(self, src_len: int) -> int:
        if self.extra:  # ROLZX (reference: v2/transform/ROLZCodec.go:1350-1358)
            return src_len + 1024 if src_len <= 16384 else src_len + src_len // 32
        # ROLZ (reference :916-922)
        return src_len + 64 if src_len <= 512 else src_len
