"""Entropy NONE: the block's bytes as they are (also a copy block's)."""

from __future__ import annotations

from ..format import Bits

IDS = (0,)


def decode(bits: Bits, length: int) -> bytes:
    return bits.read_bytes(length)
