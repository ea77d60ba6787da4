"""Hostile RANGE payloads for the device chunk walk, shared by the CPU
tests (tests/test_torch_range.py) and the card's (tests/test_torch_gpu.py).
Imports no jax."""

import numpy as np

from kanzi_tpu_torch import native
from kanzi_tpu_torch.entropy.range_device import _BUF_CAP

CHUNK = native.RANGE_CHUNK
_TEXT = b"The range coder reads a chunk header, then its coder stream. " * 40


def _put_bits(payload: bytes, at: int, width: int, value: int) -> bytes:
    bits = np.unpackbits(np.frombuffer(payload, np.uint8)).copy()
    bits[at:at + width] = [(value >> (width - 1 - i)) & 1 for i in range(width)]
    return np.packbits(bits).tobytes()


def _second_header(payload) -> tuple:
    """(bit position, end, logRange) of a payload's second chunk header,
    after a header-only first chunk."""
    src = np.frombuffer(payload, np.uint8)
    first = native.range_dec_chunk(src, 0, _BUF_CAP)
    assert first[4] == 2
    second = native.range_dec_chunk(src, first[0], _BUF_CAP)
    return first[0], second[0], second[3]


def hostile_range_block(case: str) -> tuple:
    """(payload, out length) of one hostile block: "header_rejected",
    "held_slot" or "cut_row", kept cheap for the plain decode (its decoded
    chunks hold at most 100 bytes)."""
    if case == "header_rejected":
        # an empty alphabet (bits 0, 1) opens the second chunk's header
        data = b"C" * CHUNK + _TEXT[:90]
        payload, _ = native.entropy_encode(4, np.frombuffer(data, np.uint8), {"bsVersion": 6})
        at, _end, _lr = _second_header(payload)
        return _put_bits(payload, at, 2, 0b01), len(data)
    if case == "held_slot":
        # after a header-only chunk (4096 slots of "A"), a 60-byte chunk
        # of 256 slots whose first quotient is 256: the host reads the slot
        # that the first chunk left, and decodes on
        data = b"A" * CHUNK + b"A" * 58 + b"xx"
        payload, _ = native.entropy_encode(4, np.frombuffer(data, np.uint8), {"bsVersion": 6})
        _at, end, lr = _second_header(payload)
        assert lr == 8
        return _put_bits(payload, end, 60, 256 * (((1 << 60) - 1) >> 8)) + bytes(64), len(data)
    # cut_row: a 100-byte chunk whose state is all ones (a first quotient
    # at its table's size, which the host rejects), 80,000 bytes after it:
    # its row is cut at _BUF_CAP, fails, and is parsed again at _BUF_FULL
    data = _TEXT[:100]
    payload, _ = native.entropy_encode(4, np.frombuffer(data, np.uint8), {"bsVersion": 6})
    end = native.range_dec_chunk(np.frombuffer(payload, np.uint8), 0, _BUF_CAP)[0]
    filler = np.random.default_rng(80).integers(0, 256, 80000, dtype=np.uint8).tobytes()
    return _put_bits(payload + filler, end, 60, (1 << 60) - 1), len(data)
