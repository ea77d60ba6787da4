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


def decodes_on_device(etype: int, ctx: dict) -> bool:
    """Whether `decode` runs on ctx["device"]: a device is set, `etype` has
    a device engine, and the stream's bitstream version is 6 or above."""
    return (ctx.get("device") is not None
            and etype in (HUFFMAN_TYPE, ANS0_TYPE, ANS1_TYPE, RANGE_TYPE)
            and int(ctx.get("bsVersion", 6)) >= 6)


def device_engine(etype: int, device):
    """The device entropy engine of `etype` on `device` (HUFFMAN, ANS0,
    ANS1, RANGE), or None for the types that run on the host C++ engine on
    the device path too (NONE, FPAQ, CM, TPAQ, TPAQX), as in kanzi_tpu."""
    if etype == HUFFMAN_TYPE:
        from .huffman_device import DeviceHuffmanEngine
        return DeviceHuffmanEngine(device)
    if etype in (ANS0_TYPE, ANS1_TYPE):
        from .ans_device import DeviceANSEngine
        return DeviceANSEngine(0 if etype == ANS0_TYPE else 1, device)
    if etype == RANGE_TYPE:
        from .range_device import DeviceRangeEngine
        return DeviceRangeEngine(device)
    return None


def decode_many(etype: int, payloads, out_lens, ctx: dict, map_fn=map,
                nbits=None) -> list:
    """Device entropy decode of a batch of blocks' payloads, for a type and
    ctx that `decodes_on_device` accepts: one kernel launch for the batch
    (HUFFMAN, ANS0, ANS1), or one per chunk index with a row per block
    (RANGE). Host prepares and per-block assembly run through `map_fn`
    (the Reader's pool.map). ctx["deviceDecodeHooks"], where set, holds
    the HUFFMAN and ANS launches to take instead ({"huffman": fn, "ans":
    fn}: a mesh's, parallel.mesh_decode_hooks); RANGE has none and decodes
    on ctx["device"]. `nbits` (a bit count or None a payload) marks
    payloads that end inside their last byte. Returns per block its uint8
    array or the exception that rejected its payload; nothing is retried
    on the host."""
    if not decodes_on_device(etype, ctx):
        raise ValueError(f"entropy type {etype} does not decode on the device here")
    device = ctx["device"]
    hooks = ctx.get("deviceDecodeHooks") or {}
    if etype == HUFFMAN_TYPE:
        from .huffman_device import huffman_decode_many
        return huffman_decode_many(payloads, out_lens, device, map_fn,
                                   hook=hooks.get("huffman"), nbits=nbits)
    if etype in (ANS0_TYPE, ANS1_TYPE):
        from .ans_device import ans_decode_many
        return ans_decode_many(payloads, out_lens, 0 if etype == ANS0_TYPE else 1,
                               device, map_fn, hook=hooks.get("ans"), nbits=nbits)
    from .range_device import range_decode_many
    return range_decode_many(payloads, out_lens, device, nbits)


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
    """Entropy-decode `out_len` bytes from a byte-aligned payload (its
    first ctx["payloadBits"] bits where that is set)."""
    nbits = ctx.get("payloadBits")
    if etype == NONE_TYPE:
        if (8 * len(payload) if nbits is None else nbits) < 8 * out_len:
            raise ValueError("Not enough data in entropy payload")
        return payload[:out_len]
    if decodes_on_device(etype, ctx):
        device = ctx["device"]
        hooks = ctx.get("deviceDecodeHooks") or {}
        # device entropy decode (byte-identical to the host path), through
        # the hooks as in decode_many; a payload the device path rejects
        # raises, it is never retried on the host
        if etype == HUFFMAN_TYPE:
            from .huffman_device import huffman_decode_device
            return huffman_decode_device(payload, out_len, device,
                                         hook=hooks.get("huffman"), nbits=nbits)
        if etype in (ANS0_TYPE, ANS1_TYPE):
            from .ans_device import ans_decode_device
            return ans_decode_device(payload, out_len,
                                     0 if etype == ANS0_TYPE else 1, device,
                                     hook=hooks.get("ans"), nbits=nbits)
        if etype == RANGE_TYPE:
            from .range_device import range_decode_device
            return range_decode_device(payload, out_len, device, nbits)
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
