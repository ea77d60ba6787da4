"""Binary arithmetic coder shell for the context-mixing predictors CM, TPAQ
and TPAQX (stage-2 entropy).

Format spec: reference v2/entropy/BinaryEntropyCodec.go (56-bit coder,
chunked with varint byte counts) driven by v2/entropy/CMPredictor.go /
TPAQPredictor.go. Host engine: C++ (kanzi_tpu_torch/native/src/binary.cpp,
cm.cpp, tpaq.cpp) — inherently bit-serial; throughput comes from coding
many blocks concurrently across threads/chips.
"""

from __future__ import annotations

import numpy as np

from .. import native

_PRED_ID = {"CM": 0, "TPAQ": 1, "TPAQX": 2}
_ETYPE = {"CM": 6, "TPAQ": 7, "TPAQX": 9}


def binary_encode(buf: np.ndarray, ctx: dict, predictor: str) -> tuple[bytes, int]:
    if predictor == "TPAQX":
        ctx = dict(ctx)
        ctx["extra"] = True
    return native.entropy_encode(_ETYPE[predictor], buf, ctx)


def binary_decode(payload: bytes, out_len: int, ctx: dict, predictor: str) -> bytes:
    if predictor == "TPAQX":
        ctx = dict(ctx)
        ctx["extra"] = True
    return native.entropy_decode(_ETYPE[predictor], payload, out_len, ctx)
