"""Entropy stage: registry + factory.

Codec IDs occupy the 5-bit entropy field of the stream header
(reference: v2/entropy/EntropyCodecFactory.go:26-42).

Encoders map a byte block to a bit payload; the payload always starts
byte-aligned within the block frame (the block header fields preceding it are
whole bytes), so encoders produce (bytes, exact_bit_length) and decoders
consume a byte buffer.
"""

from __future__ import annotations

import numpy as np

NONE_TYPE = 0
HUFFMAN_TYPE = 1
FPAQ_TYPE = 2
PAQ_TYPE = 3  # obsolete, not supported for encoding
RANGE_TYPE = 4
ANS0_TYPE = 5
CM_TYPE = 6
TPAQ_TYPE = 7
ANS1_TYPE = 8
TPAQX_TYPE = 9

INCOMPRESSIBLE_THRESHOLD = 973  # order-0 entropy x1024 (reference: v2/entropy/EntropyUtils.go:26)

_NAME_BY_ID = {
    NONE_TYPE: "NONE", HUFFMAN_TYPE: "HUFFMAN", FPAQ_TYPE: "FPAQ",
    PAQ_TYPE: "PAQ", RANGE_TYPE: "RANGE", ANS0_TYPE: "ANS0", CM_TYPE: "CM",
    TPAQ_TYPE: "TPAQ", ANS1_TYPE: "ANS1", TPAQX_TYPE: "TPAQX",
}
_ID_BY_NAME = {v: k for k, v in _NAME_BY_ID.items()}


def get_type(name: str) -> int:
    n = name.upper()
    if n not in _ID_BY_NAME:
        raise ValueError(f"Unsupported entropy codec type: '{name}'")
    return _ID_BY_NAME[n]


def get_name(etype: int) -> str:
    if etype not in _NAME_BY_ID:
        raise ValueError(f"Unsupported entropy codec type: '{etype}'")
    return _NAME_BY_ID[etype]


# entropy types with a device engine in kanzi_tpu that the port has not
# brought over yet -> the ROADMAP.md slice that brings it
_PENDING_DEVICE_ENGINES = {
    ANS0_TYPE: "ROADMAP.md, Modules to port, item 6 (ANS slice)",
    ANS1_TYPE: "ROADMAP.md, Modules to port, item 6 (ANS slice)",
    RANGE_TYPE: "ROADMAP.md, Modules to port, item 7 (Range slice)",
}


def check_device_engine(etype: int) -> None:
    """Raise NotImplementedError for an entropy type whose device engine
    the port does not have yet. HUFFMAN runs on the device; NONE, FPAQ, CM,
    TPAQ and TPAQX run on the host C++ engine even on the device path, as
    they do in kanzi_tpu."""
    slice_ = _PENDING_DEVICE_ENGINES.get(etype)
    if slice_ is not None:
        raise NotImplementedError(
            f"no device engine for {get_name(etype)} yet ({slice_}); "
            "use device=None for the host C++ engine")


def encode(etype: int, data, ctx: dict) -> tuple[bytes, int]:
    """Entropy-encode a block. Returns (payload_bytes, exact_bit_length)."""
    buf = np.asarray(data, dtype=np.uint8) if not isinstance(data, (bytes, bytearray)) \
        else np.frombuffer(data, dtype=np.uint8)
    if etype == NONE_TYPE:
        raw = buf.tobytes()
        return raw, len(raw) * 8
    if etype == HUFFMAN_TYPE:
        from .huffman import huffman_encode
        return huffman_encode(buf, ctx)
    if etype in (ANS0_TYPE, ANS1_TYPE):
        from .ans import ans_encode
        return ans_encode(buf, ctx, order=0 if etype == ANS0_TYPE else 1)
    if etype == RANGE_TYPE:
        from .range_codec import range_encode
        return range_encode(buf, ctx)
    if etype == FPAQ_TYPE:
        from .fpaq import fpaq_encode
        return fpaq_encode(buf, ctx)
    if etype == CM_TYPE:
        from .binary import binary_encode
        return binary_encode(buf, ctx, predictor="CM")
    if etype == TPAQ_TYPE:
        from .binary import binary_encode
        return binary_encode(buf, ctx, predictor="TPAQ")
    if etype == TPAQX_TYPE:
        from .binary import binary_encode
        return binary_encode(buf, ctx, predictor="TPAQX")
    raise ValueError(f"Unsupported entropy codec type: '{etype}'")


def decode(etype: int, payload: bytes, out_len: int, ctx: dict) -> bytes:
    """Entropy-decode `out_len` bytes from a byte-aligned payload."""
    if etype == NONE_TYPE:
        if len(payload) < out_len:
            raise ValueError("Not enough data in entropy payload")
        return payload[:out_len]
    device = ctx.get("device")
    if device is not None and int(ctx.get("bsVersion", 6)) >= 6:
        # device entropy decode (byte-identical to the host path); a payload
        # the device path rejects raises, it is never retried on the host
        check_device_engine(etype)
        if etype == HUFFMAN_TYPE:
            from .huffman_device import huffman_decode_device
            return huffman_decode_device(payload, out_len, device)
    if etype == HUFFMAN_TYPE:
        from .huffman import huffman_decode
        return huffman_decode(payload, out_len, ctx)
    if etype in (ANS0_TYPE, ANS1_TYPE):
        from .ans import ans_decode
        return ans_decode(payload, out_len, ctx, order=0 if etype == ANS0_TYPE else 1)
    if etype == RANGE_TYPE:
        from .range_codec import range_decode
        return range_decode(payload, out_len, ctx)
    if etype == FPAQ_TYPE:
        from .fpaq import fpaq_decode
        return fpaq_decode(payload, out_len, ctx)
    if etype == CM_TYPE:
        from .binary import binary_decode
        return binary_decode(payload, out_len, ctx, predictor="CM")
    if etype == TPAQ_TYPE:
        from .binary import binary_decode
        return binary_decode(payload, out_len, ctx, predictor="TPAQ")
    if etype == TPAQX_TYPE:
        from .binary import binary_decode
        return binary_decode(payload, out_len, ctx, predictor="TPAQX")
    raise ValueError(f"Unsupported entropy codec type: '{etype}'")
