"""FPAQ order-0 adaptive bitwise arithmetic coder (stage-2 entropy).

Format spec: reference v2/entropy/FPAQCodec.go — 4 MiB chunks, per-context
probability tables indexed by the top 2 bits of the previous byte.
Host engine: C++ (kanzi_tpu_torch/native/src/fpaq.cpp).
"""

from __future__ import annotations

import numpy as np

from .. import native


def fpaq_encode(buf: np.ndarray, ctx: dict) -> tuple[bytes, int]:
    return native.entropy_encode(2, buf, ctx)


def fpaq_decode(payload: bytes, out_len: int, ctx: dict) -> bytes:
    return native.entropy_decode(2, payload, out_len, ctx)
