"""Transform stage interfaces.

A transform maps a byte block to a byte block (stage 1 of the codec). The
contract mirrors the reference spec (v2/Definitions.go:53-91): transforms are
stateless across blocks — the property that makes block data-parallelism over
a device batch exact — and a forward failure means "skip" (pass-through), never a
stream error.
"""

from __future__ import annotations

import numpy as np


class TransformSkip(Exception):
    """Raised by a forward transform that vetoes itself on this data.

    The sequence records it in the skip-flags byte (bitstream-visible) and
    passes the input through unchanged (reference: v2/transform/Sequence.go:100-105).
    """


class Transform:
    """Base class for byte transforms."""

    name = "?"

    def __init__(self, ctx: dict):
        self.ctx = ctx

    def forward(self, src: np.ndarray) -> np.ndarray:
        """Transform src; raise TransformSkip to veto."""
        raise NotImplementedError

    def inverse(self, src: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def max_encoded_len(self, src_len: int) -> int:
        return src_len


def as_u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return buf.view(np.uint8)
    return np.frombuffer(buf, dtype=np.uint8)
