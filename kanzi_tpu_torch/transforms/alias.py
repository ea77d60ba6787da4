"""Alias codec (PACK/DNA): digram aliasing / small-alphabet bit packing.

Format spec: reference v2/transform/AliasCodec.go. Host engine: C++
(kanzi_tpu_torch/native/src/alias.cpp). In DNA mode (packOnlyDNA) the transform
vetoes unless the data is detected as DNA; the detection result is published
to ctx["dataType"] for downstream transforms (e.g. LZ min-match).
"""

from __future__ import annotations

import numpy as np

from .base import Transform, TransformSkip
from .. import native

PACK_TYPE = 18


class AliasCodec(Transform):
    name = "PACK"

    def max_encoded_len(self, src_len: int) -> int:
        return src_len + 1024

    def forward(self, src: np.ndarray) -> np.ndarray:
        cap = max(self.max_encoded_len(len(src)),
                  getattr(self, "seq_required", 0))
        try:
            out, self.ctx = native.transform_forward(PACK_TYPE, src, self.ctx, cap)
        except native.NativeSkip:
            raise TransformSkip()
        return np.frombuffer(out, dtype=np.uint8)

    def inverse(self, src: np.ndarray) -> np.ndarray:
        cap = int(self.ctx.get("blockSize", 4 * 1024 * 1024)) + \
            max(512, int(self.ctx.get("blockSize", 0)) >> 4)
        out = native.transform_inverse(PACK_TYPE, src, self.ctx, cap)
        return np.frombuffer(out, dtype=np.uint8)
