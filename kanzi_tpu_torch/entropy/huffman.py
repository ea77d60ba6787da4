"""Canonical Huffman codec (stage-2 entropy).

Format spec: reference v2/entropy/HuffmanCodec.go — 16 KiB chunks, canonical
codes limited to 12 bits, per-chunk alphabet + Exp-Golomb length deltas, and
4 interleaved independent sub-streams per chunk.

Execution engines:
- host: C++ (kanzi_tpu_torch/native/src/huffman.cpp) — bit-exactness oracle
- device: kanzi_tpu_torch.ops.huffman — CUDA lane pack and lane decode,
  one row per (chunk, lane) pair (entropy/huffman_device.py)
"""

from __future__ import annotations

import numpy as np

from .. import native


def huffman_encode(buf: np.ndarray, ctx: dict) -> tuple[bytes, int]:
    return native.entropy_encode(1, buf, ctx)


def huffman_decode(payload: bytes, out_len: int, ctx: dict) -> bytes:
    return native.entropy_decode(1, payload, out_len, ctx)
