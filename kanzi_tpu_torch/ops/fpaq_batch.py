"""Batched FPAQ encode: B binary arithmetic coders, one per block.

FPAQ is bit-serial within a block: every bit's interval split depends on
the probability state the previous bit left. The only parallelism is
across blocks, so B independent streams run side by side, eight bit steps
a byte, each with its four 256-entry probability tables. Flush words (32
bits when the top 32 bits of low and high agree) come out in emission
order. Signatures and results follow kanzi_tpu/ops/fpaq_batch.py; u32
values travel as int32 bits.

``encode_blocks`` is a wrapper: a CUDA tensor goes through K11
(``csrc/fpaq_batch.cu``, native u64 state) or the wrapper raises; a CPU
tensor goes through the plain version beside it, which keeps kanzi_tpu's
exact u64 arithmetic on four 16-bit limbs (int64 products and shifts near
2^63 would give the wrong bits). A bit's probability depends on the data
only, so both split the model from the interval chain: the plain version
as two passes (``_fpaq_model_plain``, then ``_fpaq_coder_plain`` over its
probabilities), K11 as a producer warp and a consumer lane.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels as K
from ..bitstream import BitWriter

PSCALE = 1 << 16
_M16 = 0xFFFF


def _add64(a, b):
    """a + b mod 2^64 on 4 x 16-bit limbs."""
    out, carry = [], 0
    for k in range(4):
        s = a[k] + b[k] + carry
        out.append(s & _M16)
        carry = s >> 16
    return out


def _sub64(a, b):
    """a - b mod 2^64 on 4 x 16-bit limbs."""
    out, borrow = [], 0
    for k in range(4):
        d = a[k] - b[k] - borrow
        out.append(d & _M16)
        borrow = (d >> 16) & 1
    return out


def _shr8(a):
    return [(a[k] >> 8) | ((a[k + 1] & 0xFF) << 8) for k in range(3)] + [a[3] >> 8]


def _mul64_16(a, p):
    """(a * p) mod 2^64, p < 2^16."""
    out, carry = [], 0
    for k in range(4):
        s = a[k] * p + carry
        out.append(s & _M16)
        carry = s >> 16
    return out


def _fpaq_model_plain(data, nbytes):
    """K11's producer: the probability each bit is coded with, (B, T, 8)
    int64, bits most significant first. It depends on the data only: a
    byte's eight contexts tbl * 256 + (bits >> (8 - k)) are distinct, and
    only valid bytes update the tables or move tbl."""
    B, T = data.shape
    dev = data.device
    probs = torch.full((B, 1024), PSCALE >> 1, dtype=torch.int64, device=dev)
    tbl = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    shifts = torch.arange(8, 0, -1, device=dev)             # 8 - k
    out = torch.zeros(B, T, 8, dtype=torch.int64, device=dev)
    vals = data.long()
    nb = nbytes.long()
    for t in range(T):
        val = vals[:, t:t + 1]
        valid = (t < nb)[:, None]
        flat = tbl * 256 + ((val + 256) >> shifts)
        p = torch.gather(probs, 1, flat)
        out[:, t] = p
        bit1 = ((val >> (shifts - 1)) & 1) == 1
        # bit 1: p - (int32(p - 65536 + 64) >> 6), a floor division
        p_new = torch.where(bit1, p - torch.div(p - PSCALE + 64, 64, rounding_mode="floor"),
                            p - (p >> 6))
        probs.scatter_(1, flat, torch.where(valid, p_new, p))
        tbl = torch.where(valid, val >> 6, tbl)
    return out


def _fpaq_coder_plain(data, nbytes, bit_probs):
    """K11's consumer: the interval chain over the bits of `data`, each
    coded with its probability from `bit_probs` (B, T, 8), on kanzi_tpu's
    16-bit limbs. Returns encode_blocks' (words, nwords, low)."""
    B, T = data.shape
    dev = data.device
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    one = [zero + 1, zero, zero, zero]
    low = [zero] * 4
    high = [zero + _M16, zero + _M16, zero + _M16, zero + 0xFF]   # 2^56 - 1
    nb = nbytes.long()
    flags = torch.zeros(B, T * 8, dtype=torch.bool, device=dev)
    words = torch.zeros(B, T * 8, dtype=torch.int64, device=dev)
    vals = data.long()
    for t in range(T):
        val = vals[:, t]
        valid = t < nb
        for k in range(8):
            p = bit_probs[:, t, k]
            bit0 = ((val >> (7 - k)) & 1) == 0
            split = _shr8(_mul64_16(_shr8(_sub64(high, low)), p))
            low_if0 = _add64(low, _add64(split, one))
            high_if1 = _add64(low, split)
            low = [torch.where(bit0 & valid, a, b) for a, b in zip(low_if0, low)]
            high = [torch.where(~bit0 & valid, a, b) for a, b in zip(high_if1, high)]
            # flush when (low ^ high) < 2^24: emit uint32(high >> 24)
            flush = (((low[1] ^ high[1]) >> 8 == 0) & (low[2] == high[2])
                     & (low[3] == high[3]) & valid)
            flags[:, 8 * t + k] = flush
            words[:, 8 * t + k] = ((high[1] >> 8) | (high[2] << 8)
                                   | ((high[3] & 0xFF) << 24))
            low = [torch.where(flush, a, b) for a, b in zip((zero, zero, low[0], low[1]), low)]
            high = [torch.where(flush, a, b)
                    for a, b in zip((zero + _M16, zero + _M16, high[0], high[1]), high)]
    # compact the flush words per row, in emission order; past T dropped
    incl = torch.cumsum(flags.long(), dim=1)
    total = incl[:, -1] if T else zero
    dest = torch.where(flags, incl - 1, T * 8)
    out = torch.zeros(B, T * 8 + 1, dtype=torch.int64, device=dev)
    out.scatter_(1, dest, words)
    out = out[:, :T]
    out = torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
    return out, total.to(torch.int32), torch.stack(low, dim=1).to(torch.int32)


def _encode_blocks_plain(data, nbytes):
    """The model, then the coder over its probabilities, as K11 splits
    them."""
    K.plain_calls["fpaq_encode"] += 1
    return _fpaq_coder_plain(data, nbytes, _fpaq_model_plain(data, nbytes))


def encode_blocks(data: torch.Tensor, nbytes: torch.Tensor):
    """Encodes B independent FPAQ streams.

    data:   (B, T) uint8  block bytes (padded with 0)
    nbytes: (B,)   int32  valid bytes per block (clamped to [0, T])

    Returns (words (B, T) int32 holding the u32 flush words in emission
    order, zero past them (a word at an index >= T is dropped but counted);
    nwords (B,) int32, every flush counted; low (B, 4) int32 holding the
    final low as 16-bit limbs, least significant first, for the host's
    closing 56-bit flush).
    Replaces kanzi_tpu/ops/fpaq_batch.py: encode_blocks.
    """
    route = K.route(data)
    dev = data.device
    K.check(data, "data", (torch.uint8,), 2, dev)
    K.check(nbytes, "nbytes", (torch.int32,), 1, dev)
    B, T = data.shape
    if nbytes.shape[0] != B:
        raise ValueError(f"encode_blocks: nbytes {tuple(nbytes.shape)}, expected ({B},)")
    if route == "plain":
        return _encode_blocks_plain(data, nbytes)
    if T >= 1 << 31:
        raise ValueError(f"encode_blocks: T {T} >= 2^31 (the flush count is an int32)")
    words = torch.empty(B, T, dtype=torch.int32, device=dev)
    nwords = torch.empty(B, dtype=torch.int32, device=dev)
    low = torch.empty(B, 4, dtype=torch.int32, device=dev)
    K.launch("fpaq_encode", "kz_fpaq_encode", dev, data.data_ptr(), nbytes.data_ptr(),
             B, T, words.data_ptr(), nwords.data_ptr(), low.data_ptr())
    return words, nwords, low


def fpaq_encode_device_batch(blocks: list, device="cuda") -> list[tuple[bytes, int]]:
    """Encode a batch of blocks (each <= 4 MiB, one FPAQ chunk) on
    `device`, returning per block (payload, bits), byte-identical to the
    host encoder."""
    dev = K.resolve_scan_device(device)
    B = len(blocks)
    T = max(len(b) for b in blocks)
    data = np.zeros((B, T), dtype=np.uint8)
    nb = np.zeros(B, dtype=np.int32)
    for i, b in enumerate(blocks):
        data[i, :len(b)] = np.frombuffer(bytes(b), np.uint8)
        nb[i] = len(b)
    words, nwords, low = encode_blocks(torch.from_numpy(data).to(dev),
                                       torch.from_numpy(nb).to(dev))
    words, nwords, low = (x.cpu().numpy() for x in (words, nwords, low))
    outs = []
    for i in range(B):
        n = int(nwords[i])
        body = np.ascontiguousarray(words[i, :n].view(np.uint32).astype(">u4")).tobytes()
        lo = sum(int(low[i, k]) << (16 * k) for k in range(4))
        bw = BitWriter()
        v = len(body)
        while v >= 128:
            bw.write_bits(0x80 | (v & 0x7F), 8)
            v >>= 7
        bw.write_bits(v, 8)
        bw.write_array(body, 8 * len(body))
        bw.write_bits((lo | 0xFFFFFF) & ((1 << 56) - 1), 56)
        outs.append((bw.getvalue(), bw.written))
    return outs
