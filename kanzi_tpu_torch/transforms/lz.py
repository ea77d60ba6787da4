"""LZ codec family: LZ/LZX (LZ77, 4-section output) and LZP (hash-predict).

Format spec: reference v2/transform/LZCodec.go. Host engine: C++
(kanzi_tpu_torch/native/src/lz.cpp). The match loop is inherently serial per
block; cross-block parallelism is the throughput axis.
"""

from __future__ import annotations

import numpy as np

from .base import Transform, TransformSkip
from .. import native

LZ_TYPE = 3
LZP_TYPE = 14
LZX_TYPE = 16


class LZCodec(Transform):
    name = "LZ"

    def __init__(self, ctx: dict):
        super().__init__(ctx)
        self.variant = int(ctx.get("lz", LZ_TYPE))

    def max_encoded_len(self, src_len: int) -> int:
        if src_len <= 1024:
            return src_len + 16
        return src_len + src_len // 64

    def forward(self, src: np.ndarray) -> np.ndarray:
        cap = max(self.max_encoded_len(len(src)),
                  getattr(self, "seq_required", 0))
        try:
            out, self.ctx = native.transform_forward(self.variant, src, self.ctx, cap)
        except native.NativeSkip:
            raise TransformSkip()
        return np.frombuffer(out, dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        # output bound: the container knows the block size; LZX inverse needs
        # dst cap >= decoded size + 16 slack for the 16-byte match copies
        cap = int(self.ctx.get("blockSize", 4 * 1024 * 1024)) + \
            max(512, int(self.ctx.get("blockSize", 0)) >> 4) + 16
        out = native.transform_inverse(self.variant, src, self.ctx, cap)
        return np.frombuffer(out, dtype=np.uint8)
