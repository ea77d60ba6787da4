"""Subbotin range coder chunk encode and decode (the RANGE entropy codec:
order 0, 60-bit state, 28-bit renormalization).

Reference behavior: v2/entropy/RangeCodec.go (encodeByte :281-305,
decodeByte :500-530). The state (low, range, code) is 60 bits wide; here
it is one int64 masked to 60 bits, which is what kanzi_tpu/ops/range.py
computes with two uint32 limbs. The renormalization loop runs at most
twice per byte (after one emission range >= 2^28, after two >= 2^56).

Signatures follow kanzi_tpu/ops/range.py:109-291, with the dtype changes
PyTorch needs (u32 values as int32 bits) and one addition to decode: each
row carries its byte count, past which a read sets the row's error flag.
The format has no per-chunk length, so the chunks of one payload decode
one after another (entropy/range_device.py walks them).

Each function is a wrapper: a CUDA tensor goes through its kernel
(``csrc/range.cu``) or the wrapper raises; a CPU tensor goes through the
plain PyTorch version beside it. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import _kernels as K

_M60 = (1 << 60) - 1
_TOP = _M60                      # TOP_RANGE
_BOTTOM = 0xFFFF                 # BOTTOM_RANGE
_RANGE_MASK = 0x0FFFFFFF00000000
_M32 = 0xFFFFFFFF


class _Consts:
    """The coder's constants as tensors on one device: an op between two
    tensors costs less host time than one with a Python scalar, and the
    plain loops below are bound by that time."""

    def __init__(self, dev):
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
        self.m60, self.rmask, self.bottom = t(_M60), t(_RANGE_MASK), t(_BOTTOM)
        self.s28, self.s32 = t(28), t(32)


def _emits(k, low, rng):
    """Whether the renormalization loop emits a word at this state: the top
    28 of the 60 bits of low and low + range agree, or the range is small."""
    return (((low ^ (low + rng)) & k.rmask) == 0) | (rng <= k.bottom)


def _renorm(k, low, rng, active, m=None):
    """One pass of the renormalization loop for every row: returns (emit,
    low, rng). Where the loop goes on with a small range, the range is
    clamped first, as the reference does; an emission shifts both by 28,
    and low is masked by `m` (60 bits by default)."""
    m = k.m60 if m is None else m
    diff = ((low ^ (low + rng)) & k.rmask) != 0
    small = rng <= k.bottom
    rng = torch.where(active & diff & small, (-low) & k.bottom, rng)
    emit = active & (small | ~diff)
    low = torch.where(emit, (low << k.s28) & m, low)
    rng = torch.where(emit, (rng << k.s28) & k.m60, rng)
    return emit, low, rng


def _encode_chunks_plain(syms, nvalid, tables, shifts):
    K.count_plain("range_encode")
    B, N = syms.shape
    dev = syms.device
    k = _Consts(dev)
    idx = syms.long()
    # the table planes are read as u32, as kanzi_tpu reads them
    cum = torch.gather(tables[:, 0].long() & _M32, 1, idx).T.contiguous()   # (N, B)
    freq = torch.gather(tables[:, 1].long() & _M32, 1, idx).T.contiguous()
    sh = shifts.long().clamp(0, 63)
    nv = nvalid.long().clamp(0, N)
    low = torch.zeros(B, dtype=torch.int64, device=dev)
    rng = torch.full((B,), _TOP, dtype=torch.int64, device=dev)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    # per byte and pass: emitted?, the word, the low after the byte
    flags = torch.zeros(N, 2, B, dtype=torch.bool, device=dev)
    vals = torch.zeros(N, 2, B, dtype=torch.int64, device=dev)
    lows = torch.zeros(N + 1, B, dtype=torch.int64, device=dev)
    # rows past their nvalid run on; the results are read at nvalid
    for i in range(N):
        r2 = rng >> sh
        low = (low + cum[i] * r2) & k.m60
        rng = (freq[i] * r2) & k.m60
        vals[i, 0] = low >> k.s32
        emit, low, rng = _renorm(k, low, rng, every)
        flags[i, 0] = emit
        if emit.any():
            vals[i, 1] = low >> k.s32
            flags[i, 1], low, rng = _renorm(k, low, rng, emit)
        lows[i + 1] = low
    # emissions in (byte, pass) order, compacted to the front of the row
    valid = torch.arange(N, device=dev)[:, None] < nv[None, :]
    flags = (flags & valid[:, None, :]).permute(2, 0, 1).reshape(B, 2 * N)
    incl = torch.cumsum(flags.long(), dim=1)
    total = incl[:, -1] if N else torch.zeros(B, dtype=torch.int64, device=dev)
    dest = torch.where(flags, incl - 1, torch.full_like(incl, 2 * N))
    words = torch.zeros(B, 2 * N + 1, dtype=torch.int64, device=dev)
    words.scatter_(1, dest, vals.permute(2, 0, 1).reshape(B, 2 * N))
    low = lows[nv, torch.arange(B, device=dev)]
    lo = low & 0xFFFFFFFF
    lows = torch.stack([torch.where(lo >= 1 << 31, lo - (1 << 32), lo), low >> 32], 1)
    return (words[:, :2 * N].to(torch.int32), total.to(torch.int32),
            lows.to(torch.int32))


def encode_chunks(syms: torch.Tensor, nvalid: torch.Tensor,
                  tables: torch.Tensor, shifts: torch.Tensor):
    """Range-encode a batch of chunks.

    syms:   (B, N)      uint8  chunk bytes (past nvalid ignored)
    nvalid: (B,)        int32  valid bytes per chunk
    tables: (B, 2, 256) int32  planes cumFreq, freq (normalized to 2^shift)
    shifts: (B,)        int32  per-chunk logRange

    Returns (words (B, 2N) int32 emitted 28-bit values in stream order,
    zero past nwords; nwords (B,) int32; lows (B, 2) int32 holding the u32
    limbs (lo, hi) of the final 60-bit low). The host writes each word as
    28 bits, then the low as 60.
    Replaces kanzi_tpu/ops/range.py: encode_chunks.
    """
    route = K.route(syms)
    dev = syms.device
    K.check(syms, "syms", (torch.uint8,), 2, dev)
    K.check(nvalid, "nvalid", (torch.int32,), 1, dev)
    K.check(tables, "tables", (torch.int32,), 3, dev)
    K.check(shifts, "shifts", (torch.int32,), 1, dev)
    B, N = syms.shape
    if nvalid.shape[0] != B or shifts.shape[0] != B or tables.shape != (B, 2, 256):
        raise ValueError("encode_chunks: expected nvalid, shifts (B,) and "
                         f"tables (B, 2, 256) for B={B}")
    if route == "plain":
        return _encode_chunks_plain(syms, nvalid, tables, shifts)
    words = torch.empty(B, 2 * N, dtype=torch.int32, device=dev)
    nwords = torch.empty(B, dtype=torch.int32, device=dev)
    lows = torch.empty(B, 2, dtype=torch.int32, device=dev)
    K.launch("range_encode", "kz_range_encode", dev, syms.data_ptr(), N,
             nvalid.data_ptr(), tables.data_ptr(), shifts.data_ptr(), B,
             words.data_ptr(), nwords.data_ptr(), lows.data_ptr())
    return words, nwords, lows


def _udiv_cap(d, r2, cap):
    """min(d // r2, cap) for d read as u64 (an int64 of any sign) and
    0 < r2 < 2^62: one signed division of d's top 63 bits."""
    half = (d >> 1) & ((1 << 63) - 1)
    qh = half // r2
    small = qh < cap
    qh = torch.where(small, qh, 0)
    rest = d - 2 * qh * r2                     # in [0, 2 * r2): no sign
    q = 2 * qh + (rest >= r2).long()
    return torch.where(small, torch.minimum(q, cap), cap)


def _decode_chunks_plain(bufs, nbytes, tables, f2s, shifts, nvalid, glen,
                         nbits=None, bound=None):
    K.count_plain("range_decode")
    B, S = bufs.shape
    F = f2s.shape[1]
    dev = bufs.device
    k = _Consts(dev)
    strict = bound is not None
    nb = nbytes.long().clamp(0, S)[:, None]
    nbit = 8 * nb if nbits is None else torch.minimum(nbits.long().clamp(min=0)[:, None], 8 * nb)
    b = torch.cat([bufs.long(), torch.zeros(B, 8, dtype=torch.int64, device=dev)], 1)
    b = torch.where(torch.arange(S + 8, device=dev)[None, :] < nb, b, 0)
    # the 28-bit read at every position k (bit 60 + 28k) that can lie in
    # the row, zero bytes past nbytes; reads from kbad on reach past the
    # row's bits
    kmax = max(0, (8 * S - 60) // 28 + 1)
    off = 60 + 28 * torch.arange(kmax + 1, device=dev)[None, :]
    byte = (off >> 3).clamp(max=S + 3)
    win = torch.zeros(B, kmax + 1, dtype=torch.int64, device=dev)
    for j in range(5):
        win = (win << 8) | torch.gather(b, 1, (byte + j).expand(B, -1))
    reads = (win >> (12 - (off & 7))) & 0xFFFFFFF
    kbad = (off + 28 <= nbit).sum(1, keepdim=True)
    head = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    for j in range(8):
        head = (head << 8) | b[:, j:j + 1]
    code = (head >> 4) & _M60                  # the first 60 bits
    nv = nvalid.long().clamp(0, glen)[:, None]
    # freq slot -> (cumFreq | freq << 32), both read as u32 as kanzi_tpu
    # reads them: one gather a step; the symbols are gathered at the end
    sym_all = f2s.long()
    comb = (torch.gather(tables[:, 0].long() & _M32, 1, sym_all)
            | (torch.gather(tables[:, 1].long() & _M32, 1, sym_all) << 32))
    sh = shifts.long().clamp(0, 63)[:, None]
    # the host decoder's state is u64: low and code keep the bits a shift
    # moves past bit 59 (strict); kanzi_tpu's is 60 bits wide
    m = torch.tensor(-1 if strict else _M60, device=dev)
    cap = torch.tensor(F if strict else F - 1, device=dev)
    lim = bound.long().clamp(min=0)[:, None] if strict else None
    low = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    rng = torch.full((B, 1), _TOP, dtype=torch.int64, device=dev)
    nr = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    bad = torch.zeros(B, 1, dtype=torch.bool, device=dev)
    every = torch.ones(B, 1, dtype=torch.bool, device=dev)
    slots = torch.zeros(B, glen, dtype=torch.int64, device=dev)
    # rows past their nvalid run on; only their read count is held
    for i in range(glen):
        live = i < nv
        r2 = rng >> sh
        d = (code - low) & m
        if strict:
            q = _udiv_cap(d, r2.clamp(min=1), cap)
            # the host's quotient past its slot table throws
            bad |= live & (q >= lim)
            q = q.clamp(max=F - 1)
        else:
            q = torch.where(r2 == 0, cap, torch.minimum(d // r2.clamp(min=1), cap))
        c = torch.gather(comb, 1, q)
        slots[:, i:i + 1] = q
        low = (low + (c & _M32) * r2) & m
        rng = (((c >> k.s32) & _M32) * r2) & k.m60
        active = every
        for _ in range(2):
            emit, low, rng = _renorm(k, low, rng, active, m)
            if not emit.any():
                break
            r28 = torch.gather(reads, 1, nr.clamp(max=kmax))
            code = torch.where(emit, ((code << k.s28) & m) | r28, code)
            nr = nr + (emit & live)
            active = emit
        if strict and active.any():
            # a third emission: the host's loop goes on to the stream's end
            # (a range of 0 always comes here)
            bad |= live & active & _emits(k, low, rng)
    out = torch.gather(sym_all, 1, slots)
    out = torch.where(torch.arange(glen, device=dev)[None, :] < nv, out, 0)
    err = bad | (nr > kbad) | ((nv > 0) & (nbit < 60))
    return out.to(torch.uint8), torch.where(err, -1, nr)[:, 0].to(torch.int32)


def decode_chunks(bufs: torch.Tensor, nbytes: torch.Tensor,
                  tables: torch.Tensor, f2s: torch.Tensor,
                  shifts: torch.Tensor, nvalid: torch.Tensor, glen: int,
                  nbits: torch.Tensor | None = None,
                  bound: torch.Tensor | None = None):
    """Range-decode a batch of chunk coder streams.

    bufs:   (B, S)      uint8  byte-aligned coder streams
    nbytes: (B,)        int32  bytes of each row's stream: a read whose bits
                               reach past it returns 0 there and sets the
                               row's error flag
    tables: (B, 2, 256) int32  planes cumFreq, freq
    f2s:    (B, F)      uint8  freq slot -> symbol, F 4096 or 32768 (the
                               format's logRange 15)
    shifts: (B,)        int32  per-chunk logRange
    nvalid: (B,)        int32  bytes to decode per row
    glen:   bytes in the output (rows decode min(nvalid, glen))
    nbits:  (B,)        int32  optional: the row's stream ends inside its
                               last byte, after nbits bits
    bound:  (B,)        int32  optional: the host decoder's rules for a
                               hostile row (the engine's call). Its state is
                               u64, and the row's error flag is set where the
                               host decoder throws or reads on to the end of
                               the stream: a quotient at or past `bound`
                               (the size of its slot table), a range of 0,
                               a byte that would emit a third word. Without
                               it, kanzi_tpu's rules: a 60-bit state, the
                               quotient capped at F - 1.

    Returns (syms (B, glen) uint8, zero past nvalid; nreads (B,) int32, the
    number of 28-bit renorm reads, so that the row's stream takes 60 +
    28*nreads bits, or -1 where the row's error flag is set).
    Replaces kanzi_tpu/ops/range.py: decode_chunks.
    """
    route = K.route(bufs)
    dev = bufs.device
    K.check(bufs, "bufs", (torch.uint8,), 2, dev)
    K.check(nbytes, "nbytes", (torch.int32,), 1, dev)
    K.check(tables, "tables", (torch.int32,), 3, dev)
    K.check(f2s, "f2s", (torch.uint8,), 2, dev)
    K.check(shifts, "shifts", (torch.int32,), 1, dev)
    K.check(nvalid, "nvalid", (torch.int32,), 1, dev)
    for name, t in (("nbits", nbits), ("bound", bound)):
        if t is not None:
            K.check(t, name, (torch.int32,), 1, dev)
            if t.shape[0] != bufs.shape[0]:
                raise ValueError(f"decode_chunks: expected {name} (B,)")
    B, S = bufs.shape
    if (nbytes.shape[0] != B or shifts.shape[0] != B or nvalid.shape[0] != B
            or tables.shape != (B, 2, 256) or f2s.shape[0] != B
            or f2s.shape[1] not in (4096, 32768)):
        raise ValueError("decode_chunks: expected nbytes, shifts, nvalid (B,), "
                         f"tables (B, 2, 256), f2s (B, 4096 or 32768) for B={B}")
    if S < 1 or glen < 0:
        raise ValueError("decode_chunks: empty rows or negative glen")
    if route == "plain":
        return _decode_chunks_plain(bufs, nbytes, tables, f2s, shifts, nvalid, glen,
                                    nbits, bound)
    out = torch.empty(B, glen, dtype=torch.uint8, device=dev)
    nreads = torch.empty(B, dtype=torch.int32, device=dev)
    K.launch("range_decode", "kz_range_decode", dev, bufs.data_ptr(), S,
             nbytes.data_ptr(), tables.data_ptr(), f2s.data_ptr(), f2s.shape[1],
             shifts.data_ptr(), nvalid.data_ptr(), B, glen, out.data_ptr(),
             nreads.data_ptr(), 0 if nbits is None else nbits.data_ptr(),
             0 if bound is None else bound.data_ptr())
    return out, nreads
