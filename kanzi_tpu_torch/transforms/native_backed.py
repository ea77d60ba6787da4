"""Generic wrapper for transforms implemented in the C++ host runtime.

Each subclass sets the registry id and its MaxEncodedLen rule (these bound
the ping-pong buffers in the sequence; values follow the reference spec).
"""

from __future__ import annotations

import numpy as np

from .base import Transform, TransformSkip
from .. import native


class NativeTransform(Transform):
    ttype = -1

    def max_encoded_len(self, src_len: int) -> int:
        return src_len

    def _inverse_cap(self, src_len: int) -> int:
        block = int(self.ctx.get("blockSize", 4 * 1024 * 1024))
        return max(block + max(512, block >> 4) + 16, src_len + 1024)

    def forward(self, src: np.ndarray) -> np.ndarray:
        cap = max(self.max_encoded_len(len(src)),
                  getattr(self, "seq_required", 0))
        try:
            out, self.ctx = native.transform_forward(self.ttype, src, self.ctx, cap)
        except native.NativeSkip:
            raise TransformSkip()
        return np.frombuffer(out, dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        out = native.transform_inverse(self.ttype, src, self.ctx,
                                       self._inverse_cap(len(src)))
        return np.frombuffer(out, dtype=np.uint8)


class ZRLT(NativeTransform):
    """Zero run-length transform (reference: v2/transform/ZRLT.go)."""
    name = "ZRLT"
    ttype = 6


class RLT(NativeTransform):
    """Escaped run-length transform (reference: v2/transform/RLT.go)."""
    name = "RLT"
    ttype = 5

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 32 if src_len <= 512 else src_len


class SRT(NativeTransform):
    """Sorted-rank transform (reference: v2/transform/SRT.go)."""
    name = "SRT"
    ttype = 13

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 4 * 256


class SBRT(NativeTransform):
    """Sort-by-rank family: MTFT / RANK (reference: v2/transform/SBRT.go)."""
    ttype = 7

    def __init__(self, ctx: dict):
        super().__init__(ctx)
        self.mode = int(ctx.get("sbrt", 1))
        self.ttype = 7 if self.mode == 1 else 8
        self.name = "MTFT" if self.mode == 1 else "RANK"

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 33  # shares the BWT header slack (reference quirk)


class BWTBlockCodec(NativeTransform):
    """BWT with primary-index header (reference: v2/transform/BWT.go,
    BWTBlockCodec.go; forward SA via SA-IS in native/src/sais.cpp)."""
    name = "BWT"
    ttype = 1

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 33


class BWTS(NativeTransform):
    """Bijective BWT (Scott) (reference: v2/transform/BWTS.go)."""
    name = "BWTS"
    ttype = 2

    def max_encoded_len(self, src_len: int) -> int:
        return src_len
