"""4-state rANS chunk encode and decode (the ANS0/ANS1 entropy codec).

The reference encoder walks each chunk backwards with 4 interleaved rANS
states writing their renorm byte pairs into one back-to-front buffer; the
decoder runs the states forward, 3, 2, 1, 0 per group, sharing one byte
cursor (v2/entropy/ANSRangeCodec.go:307-405, :904-948). Signatures, shapes
and layout follow kanzi_tpu/ops/ans.py:54-192, with the dtype changes
PyTorch needs (u16 pairs and order-1 symbol indices travel as int16 bits,
u32 states as int32 bits) and two additions to decode: each chunk carries
its own logRange, and each row its byte count, past which a read sets the
row's error flag.

Each function is a wrapper: a CUDA tensor goes through its kernel
(``csrc/ans.cu``) or the wrapper raises; a CPU tensor goes through the
plain PyTorch version beside it. There is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels as K

ANS_TOP = 1 << 15

_M32 = 0xFFFFFFFF


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int16 bits -> int64 values in [0, 2^16); other dtypes widen."""
    x = x.long()
    return x & 0xFFFF


def _to_int_bits(x: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    """int64 values in [0, 2^bits) -> `dtype` holding the same bits."""
    half = 1 << (bits - 1)
    return torch.where(x >= half, x - (1 << bits), x).to(dtype)


def _encode_chunks_plain(syms, ngroups, tables):
    K.count_plain("ans_encode")
    B, G, _ = syms.shape
    dev = syms.device
    W = 4 * G
    idx = _u16(syms).reshape(B, 1, W)
    # every table entry the chunk reads, gathered up front: (B, 5, G, 4)
    ent = torch.gather(tables.long() & _M32, 2, idx.expand(B, 5, W)).reshape(B, 5, G, 4)
    xmax, bias, cmpl = ent[:, 0], ent[:, 1], ent[:, 2]
    shr = (ent[:, 3] - 32) & 31
    fi_hi, fi_lo = ent[:, 4] >> 16, ent[:, 4] & 0xFFFF
    valid = (torch.arange(G, device=dev)[None, :]
             < ngroups.long()[:, None])[:, :, None]             # (B, G, 1)
    st = torch.full((B, 4), ANS_TOP, dtype=torch.int64, device=dev)
    flags = torch.zeros(B, G, 4, dtype=torch.bool, device=dev)
    pairs = torch.zeros(B, G, 4, dtype=torch.int64, device=dev)
    for g in range(G):
        v = valid[:, g]
        flag = v & (st >= xmax[:, g])
        flags[:, g] = flag
        pairs[:, g] = st & 0xFFFF
        x = torch.where(flag, st >> 16, st)
        # (x * invFreq) >> 32 in two 16-bit halves of invFreq
        q = ((x * fi_hi[:, g] + ((x * fi_lo[:, g]) >> 16)) >> 16) >> shr[:, g]
        st = torch.where(v, (x + bias[:, g] + q * cmpl[:, g]) & _M32, st)
    # the p-th of P emissions in (g, j) order lands at stream slot P-1-p
    flags = flags.reshape(B, W)
    incl = torch.cumsum(flags.long(), dim=1)
    total = incl[:, -1] if W else torch.zeros(B, dtype=torch.int64, device=dev)
    dest = torch.where(flags, total[:, None] - incl, torch.full_like(incl, W))
    out = torch.zeros(B, W + 1, dtype=torch.int64, device=dev)
    out.scatter_(1, dest, pairs.reshape(B, W))
    return (_to_int_bits(out[:, :W], 16, torch.int16), total.to(torch.int32),
            _to_int_bits(st, 32, torch.int32))


def encode_chunks(syms: torch.Tensor, ngroups: torch.Tensor,
                  tables: torch.Tensor):
    """Runs the 4-state rANS encode for a batch of chunks.

    syms:    (B, G, 4) uint8 (order 0) or int16 holding u16 bits (order 1)
             symbol-table indices in emission order (group g, state j);
             groups at or past ngroups are ignored
    ngroups: (B,)      int32  valid groups per chunk
    tables:  (B, 5, S) int32  planes xMax, bias, cmplFreq, invShift,
             invFreq (u32 bits); S >= 256 for uint8 symbols, 65536 for int16

    Returns (pairs (B, 4G) int16 holding the u16 renorm pairs in stream
    order, zero past npairs (big-endian serialization gives the byte
    stream), npairs (B,) int32, states (B, 4) int32 holding the final u32
    states in j order).
    Replaces kanzi_tpu/ops/ans.py: encode_chunks.
    """
    route = K.route(syms)
    dev = syms.device
    K.check(syms, "syms", (torch.uint8, torch.int16), 3, dev)
    K.check(ngroups, "ngroups", (torch.int32,), 1, dev)
    K.check(tables, "tables", (torch.int32,), 3, dev)
    B, G, four = syms.shape
    S = tables.shape[2]
    need = 256 if syms.dtype == torch.uint8 else 65536
    if four != 4 or ngroups.shape[0] != B or tables.shape[:2] != (B, 5) or S < need:
        raise ValueError("encode_chunks: expected syms (B, G, 4), ngroups (B,), "
                         f"tables (B, 5, S >= {need}) for B={B}, got "
                         f"{tuple(syms.shape)}, {tuple(tables.shape)}")
    if route == "plain":
        return _encode_chunks_plain(syms, ngroups, tables)
    pairs = torch.empty(B, 4 * G, dtype=torch.int16, device=dev)
    npairs = torch.empty(B, dtype=torch.int32, device=dev)
    states = torch.empty(B, 4, dtype=torch.int32, device=dev)
    cfunc = "kz_ans_encode_u8" if syms.dtype == torch.uint8 else "kz_ans_encode_u16"
    K.launch("ans_encode", cfunc, dev, syms.data_ptr(), ngroups.data_ptr(),
             tables.data_ptr(), B, G, S, pairs.data_ptr(), npairs.data_ptr(),
             states.data_ptr())
    return pairs, npairs, states


def _decode_chunks_plain(bufs, nbytes, states0, f2s, dtabs, ngroups, lr,
                         order, glen):
    K.count_plain("ans_decode")
    B, S = bufs.shape
    F = f2s.shape[1]
    T = dtabs.shape[2]
    dev = bufs.device
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
    m32, top, s16, s32 = t(_M32), t(ANS_TOP), t(16), t(32)
    lr = lr.long()
    bad = (lr < 8) | (lr > 16) | (((256 if order else 1) << lr.clamp(0, 16)) > F)
    lr = torch.where(bad, 8, lr)[:, None]                   # (B, 1)
    mask = torch.where(bad[:, None], 0, (1 << lr) - 1)      # bad rows: slot 0
    ng = torch.where(bad, 0, ngroups.long().clamp(0, glen))
    nb = nbytes.long().clamp(0, S)[:, None]
    # freq-slot -> freq | cumFreq << 32, both read as u32 as kanzi_tpu
    # reads them (cumFreq's top bit lands in the sign bit), and the symbol
    slots = torch.arange(F, device=dev)[None, :]
    sym_all = f2s.long()
    ti = ((slots >> lr) << 8) + sym_all if order else sym_all
    ti = ti.clamp(max=T - 1)
    freq = torch.gather(dtabs[:, 0].long() & _M32, 1, ti)
    cum = torch.gather(dtabs[:, 1].long() & _M32, 1, ti)
    fc = freq | (cum << 32)
    # the byte pair at every cursor position a chunk can reach, zero past
    # the row's bytes
    width = max(S, 8 * glen) + 2
    b = torch.zeros(B, width + 1, dtype=torch.int64, device=dev)
    b[:, :S] = bufs.long()
    b = torch.where(torch.arange(width + 1, device=dev)[None, :] < nb, b, 0)
    pair = (b[:, :width] << 8) | b[:, 1:]
    st = [s[:, None] for s in (states0.long() & _M32).unbind(1)]
    prv = [torch.zeros(B, 1, dtype=torch.int64, device=dev) for _ in range(4)]
    n = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    out = torch.zeros(B, glen, 4, dtype=torch.int64, device=dev)
    # rows past their ngroups run on; only their cursor is held
    for g in range(glen):
        v = (g < ng)[:, None]
        for j in (3, 2, 1, 0):
            x = st[j]
            slot = x & mask
            idx = ((prv[j] << lr) + slot).clamp(max=F - 1) if order else slot
            c = torch.gather(fc, 1, idx)
            y = ((c & m32) * (x >> lr) + slot - ((c >> s32) & m32)) & m32
            flag = y < top
            st[j] = torch.where(flag, ((y << s16) | torch.gather(pair, 1, n)) & m32, y)
            n = n + 2 * (flag & v)
            prv[j] = torch.gather(sym_all, 1, idx)
            out[:, g, j:j + 1] = prv[j]
    out = torch.where((torch.arange(glen, device=dev)[None, :] < ng[:, None])[:, :, None],
                      out, 0)
    # a read at n needs n + 1 < nbytes; the cursor then passes nbytes
    err = bad[:, None] | (n > nb)
    return out.to(torch.uint8), torch.where(err, -1, n)[:, 0].to(torch.int32)


def decode_chunks(bufs: torch.Tensor, nbytes: torch.Tensor,
                  states0: torch.Tensor, f2s: torch.Tensor,
                  dtabs: torch.Tensor, ngroups: torch.Tensor, lr: torch.Tensor,
                  order: int, glen: int):
    """4-state forward rANS decode for a batch of chunks.

    bufs:    (B, S)     uint8  renorm byte streams
    nbytes:  (B,)       int32  bytes of each row's stream: a read at or past
                               it returns 0 and sets the row's error flag
    states0: (B, 4)     int32  initial states (u32 bits), j = 0..3
    f2s:     (B, F)     uint8  freq slot -> symbol, per context; F >=
                               dim * 2^lr (dim = 256 for order 1, else 1)
    dtabs:   (B, 2, T)  int32  planes freq, cumFreq; T = dim * 256
    ngroups: (B,)       int32  symbol groups per chunk
    lr:      (B,)       int32  logRange per chunk, 8..16
    order:   0 or 1;  glen: groups in the output

    Returns (syms (B, glen, 4) uint8 with column j = state j's symbol in
    group g, zero past ngroups; nread (B,) int32 bytes consumed, where the
    chunk's raw tail starts, or -1 where the row's error flag is set: a
    read past nbytes, or a logRange its f2s row cannot hold). Decode order
    within a group is state 3, 2, 1, 0.
    Replaces kanzi_tpu/ops/ans.py: decode_chunks.
    """
    route = K.route(bufs)
    dev = bufs.device
    K.check(bufs, "bufs", (torch.uint8,), 2, dev)
    for name, t in (("nbytes", nbytes), ("ngroups", ngroups), ("lr", lr)):
        K.check(t, name, (torch.int32,), 1, dev)
    K.check(states0, "states0", (torch.int32,), 2, dev)
    K.check(f2s, "f2s", (torch.uint8,), 2, dev)
    K.check(dtabs, "dtabs", (torch.int32,), 3, dev)
    if order not in (0, 1):
        raise ValueError(f"decode_chunks: order must be 0 or 1, got {order}")
    B, S = bufs.shape
    T = 65536 if order else 256
    if (nbytes.shape[0] != B or ngroups.shape[0] != B or lr.shape[0] != B
            or states0.shape != (B, 4) or f2s.shape[0] != B
            or dtabs.shape != (B, 2, T)):
        raise ValueError("decode_chunks: expected nbytes, ngroups, lr (B,), "
                         f"states0 (B, 4), f2s (B, F), dtabs (B, 2, {T}) for B={B}")
    if S < 1 or f2s.shape[1] < 1 or glen < 0:
        raise ValueError("decode_chunks: empty rows or negative glen")
    if route == "plain":
        return _decode_chunks_plain(bufs, nbytes, states0, f2s, dtabs, ngroups,
                                    lr, order, glen)
    out = torch.empty(B, glen, 4, dtype=torch.uint8, device=dev)
    nread = torch.empty(B, dtype=torch.int32, device=dev)
    # rows whose table does not fit shared memory read one that the call
    # builds in scratch; the kernel library says how much
    F = f2s.shape[1]
    scratch = torch.empty(max(K.query("kz_ans_decode_scratch", S, F, order, B), 8),
                          dtype=torch.uint8, device=dev)
    K.launch("ans_decode", "kz_ans_decode", dev, bufs.data_ptr(), S,
             nbytes.data_ptr(), states0.data_ptr(), f2s.data_ptr(), F,
             dtabs.data_ptr(), T, ngroups.data_ptr(), lr.data_ptr(), order, B,
             glen, out.data_ptr(), nread.data_ptr(), scratch.data_ptr(),
             scratch.numel())
    return out, nread


def build_syms_order0(chunk: np.ndarray) -> np.ndarray:
    """(G, 4) uint8 symbol matrix of an order-0 chunk: S[g, j] =
    chunk[end4-1-4g-j]."""
    end4 = len(chunk) & ~3
    return np.ascontiguousarray(np.flip(chunk[:end4]).reshape(-1, 4))


def build_syms_order1(chunk: np.ndarray) -> np.ndarray:
    """(G+1, 4) uint16 symbol matrix of an order-1 chunk: quarter lanes of
    (cur<<8)|prv pairs walked backwards, then the final context-0 group."""
    n = len(chunk)
    q = (n & ~3) >> 2
    if n <= 1 or q == 0:
        return np.zeros((0, 4), dtype=np.uint16)
    lanes = chunk[:4 * q].reshape(4, q).astype(np.uint16)
    cur = lanes[:, q - 2::-1] if q >= 2 else lanes[:, :0]   # (4, q-1)
    prv = lanes[:, q - 1:0:-1] if q >= 2 else lanes[:, :0]
    syms = ((cur << 8) | prv).T                             # (q-1, 4)
    final = lanes[:, 0][None, :]                            # context 0
    return np.concatenate([syms, final], axis=0)
