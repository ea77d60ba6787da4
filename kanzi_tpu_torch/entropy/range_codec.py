"""Range codec (stage-2 entropy).

Format spec: reference v2/entropy/RangeCodec.go — Subbotin-style 64-bit
range coder, 32 KiB chunks, shared frequency-header scheme.
Host engine: C++ (kanzi_tpu_torch/native/src/range.cpp).
"""

from __future__ import annotations

import numpy as np

from .. import native


def range_encode(buf: np.ndarray, ctx: dict) -> tuple[bytes, int]:
    return native.entropy_encode(4, buf, ctx)


def range_decode(payload: bytes, out_len: int, ctx: dict) -> bytes:
    return native.entropy_decode(4, payload, out_len, ctx)
