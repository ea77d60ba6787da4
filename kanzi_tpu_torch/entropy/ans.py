"""rANS order-0/order-1 codec (stage-2 entropy).

Format spec: reference v2/entropy/ANSRangeCodec.go — 4 interleaved rANS
states, reverse-order encoding, 16 KiB chunks (x256 for order 1), per-chunk
normalized frequency headers.

Host engine: C++ (kanzi_tpu_torch/native/src/ans.cpp). The port has no
device engine for ANS yet.
"""

from __future__ import annotations

import numpy as np

from .. import native


def ans_encode(buf: np.ndarray, ctx: dict, order: int) -> tuple[bytes, int]:
    return native.entropy_encode(5 if order == 0 else 8, buf, ctx)


def ans_decode(payload: bytes, out_len: int, ctx: dict, order: int) -> bytes:
    return native.entropy_decode(5 if order == 0 else 8, payload, out_len, ctx)
