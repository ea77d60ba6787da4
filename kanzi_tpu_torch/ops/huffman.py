"""Huffman lane pack and lane decode.

The reference encoder packs each 16 KiB chunk as 4 independent interleaved
sub-streams (v2/entropy/HuffmanCodec.go:435-511); every (chunk, lane) pair
is one row here. Signatures, shapes and layout follow
kanzi_tpu/ops/huffman.py:28-123, with two dtype changes PyTorch needs:
packed words are int32 tensors holding the bit patterns of the big-endian
u32 stream words, and decode tables are int16 tensors holding the u16
(sym<<8)|len entries.

Each function is a wrapper: a CUDA tensor goes through its kernel
(``csrc/huffman.cu``) or the wrapper raises; a CPU tensor goes through the
plain PyTorch version beside it. There is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels as K

FRAG = 4096  # symbols per lane (16 KiB chunk / 4)
# max lane bits = FRAG * 12; +2 words slack for the split scatter
WORDS = (FRAG * 12 + 31) // 32 + 2

_M32 = 0xFFFFFFFF


def _nwords(frag: int) -> int:
    return (frag * 12 + 31) // 32 + 2


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pack_lanes_plain(syms, lane_len, table_idx, tables):
    K.plain_calls["pack_lanes"] += 1
    L, frag = syms.shape
    nwords = _nwords(frag)
    ctab = tables[table_idx.long()].long()                    # (L, 256)
    codes = torch.gather(ctab, 1, syms.long() & 0xFF)          # (L, frag)
    pos = torch.arange(frag, device=syms.device)[None, :]
    valid = pos < lane_len.long()[:, None]
    if bool((valid & (codes < 0)).any()):
        raise ValueError("pack_lanes: a valid symbol's table entry is negative")
    zero = torch.zeros_like(codes)
    lens = torch.where(valid, codes >> 12, zero)
    vals = torch.where(valid, codes & 0xFFF, zero)
    ends = torch.cumsum(lens, dim=1)                           # inclusive
    offs = ends - lens                                         # exclusive
    nbits = ends[:, -1].to(torch.int32)
    word1 = offs >> 5
    s1 = 32 - (offs & 31) - lens                               # may be negative
    hi = torch.where(s1 >= 0, (vals << s1.clamp(min=0)) & _M32,
                     vals >> (-s1).clamp(max=31))
    lo = torch.where(s1 >= 0, zero, (vals << (32 + s1).clamp(min=0)) & _M32)
    # out-of-range words are dropped, as the JAX scatter drops them: they
    # land in a spare column that is cut off
    words = torch.zeros(L, nwords + 1, dtype=torch.int64, device=syms.device)
    words.scatter_add_(1, word1.clamp(max=nwords), hi)
    words.scatter_add_(1, (word1 + 1).clamp(max=nwords), lo)
    return _to_int32_bits(words[:, :nwords]), nbits


def pack_lanes(syms: torch.Tensor, lane_len: torch.Tensor,
               table_idx: torch.Tensor, tables: torch.Tensor):
    """Packs Huffman codes for a batch of lanes.

    syms:      (L, frag) uint8/int32 symbols (padded with 0), frag <= FRAG
    lane_len:  (L,)      int32  valid symbols per lane
    table_idx: (L,)      int32  chunk/table index per lane, in [0, C)
    tables:    (C, 256)  int32  (len<<12)|code entries

    Returns (words (L, nwords) int32 bit patterns of the big-endian u32
    stream, nbits (L,) int32) with nwords = (frag*12+31)//32 + 2.
    A symbol is read as its low byte. Any non-negative entry is exact:
    length entry >> 12, code entry & 0xFFF, codes wider than their length
    included (parts are summed per word, as kanzi_tpu sums them).
    A table_idx outside [0, C), or a negative entry for a valid symbol,
    raises ValueError on the CPU; on the card the kernel writes no part
    for that lane and gives it nbits -1 and zero words, which the caller
    reads with the result (no host round trip before the launch).
    Replaces kanzi_tpu/ops/huffman.py: pack_lanes.
    """
    route = K.route(syms)
    dev = syms.device
    K.check(syms, "syms", (torch.uint8, torch.int32), 2, dev)
    K.check(lane_len, "lane_len", (torch.int32,), 1, dev)
    K.check(table_idx, "table_idx", (torch.int32,), 1, dev)
    K.check(tables, "tables", (torch.int32,), 2, dev)
    L, frag = syms.shape
    if lane_len.shape[0] != L or table_idx.shape[0] != L or tables.shape[1] != 256:
        raise ValueError("pack_lanes: expected lane_len (L,), table_idx (L,), "
                         f"tables (C, 256) for L={L}")
    if frag > FRAG:
        raise ValueError(f"pack_lanes: at most {FRAG} symbols per lane, got {frag}")
    if route == "plain":
        K.check_index(table_idx, "table_idx", tables.shape[0])
        return _pack_lanes_plain(syms, lane_len, table_idx, tables)
    nwords = _nwords(frag)
    words = torch.empty(L, nwords, dtype=torch.int32, device=dev)
    nbits = torch.empty(L, dtype=torch.int32, device=dev)
    cfunc = "kz_pack_lanes_u8" if syms.dtype == torch.uint8 else "kz_pack_lanes_i32"
    K.launch("pack_lanes", cfunc, dev, syms.data_ptr(), lane_len.data_ptr(),
             table_idx.data_ptr(), tables.data_ptr(), tables.shape[0], L, frag,
             nwords, words.data_ptr(), nbits.data_ptr())
    return words, nbits


def words_to_bytes(words) -> bytes:
    """Big-endian byte view of packed words (host side)."""
    w = words.cpu().numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    return w.view(np.uint32).astype(">u4").tobytes()


def _decode_lanes_plain(lanes, table_idx, dtables):
    K.plain_calls["decode_lanes"] += 1
    L, S = lanes.shape
    dev = lanes.device
    # the 12-bit peek at every bit position of a row, computed up front;
    # bytes past the end of a row read as zero, like the rows' zero padding
    b = torch.cat([lanes.int(), torch.zeros(L, 2, dtype=torch.int32, device=dev)], 1)
    w24 = (b[:, :S] << 16) | (b[:, 1:S + 1] << 8) | b[:, 2:S + 2]
    peek = torch.stack([(w24 >> (12 - r)) & 0xFFF for r in range(8)], dim=2)
    peek = torch.cat([peek.reshape(L, 8 * S),
                      torch.zeros(L, 1, dtype=torch.int32, device=dev)], 1)
    flat = dtables.reshape(-1).long() & 0xFFFF
    base = table_idx.long() * 4096
    bitpos = torch.zeros(L, 1, dtype=torch.int64, device=dev)
    out = torch.empty(L, FRAG, dtype=torch.int64, device=dev)
    for i in range(FRAG):
        code = torch.gather(peek, 1, bitpos.clamp(max=8 * S))[:, 0]
        val = flat[base + code]
        out[:, i] = val
        bitpos += (val & 0xFF)[:, None]
    return (out >> 8).to(torch.uint8)


def decode_lanes(lanes: torch.Tensor, table_idx: torch.Tensor,
                 dtables: torch.Tensor, bad: torch.Tensor | None = None) -> torch.Tensor:
    """Batched table-driven Huffman decode, FRAG steps per lane.

    lanes:     (L, S) uint8   lane byte streams, zero-padded; bytes past S
                              read as zero
    table_idx: (L,)   int32   chunk/table index per lane, in [0, C)
    dtables:   (C, 4096) int16  code -> (symbol<<8)|length, as u16 bits
    bad:       (L,)   int32   output, needed on the card: 1 where
                              table_idx lies outside [0, C), else 0

    Returns symbols (L, FRAG) uint8 (garbage beyond each lane's true
    fragment size; the host slices per chunk).
    A table_idx outside [0, C) raises ValueError on the CPU. On the card
    the kernel reads no table for that lane, decodes it to zeros and flags
    it in `bad`, which the caller reads with the symbols (no host round
    trip before the launch), as pack_lanes' caller reads nbits -1.
    Replaces kanzi_tpu/ops/huffman.py: decode_lanes.
    """
    route = K.route(lanes)
    dev = lanes.device
    K.check(lanes, "lanes", (torch.uint8,), 2, dev)
    K.check(table_idx, "table_idx", (torch.int32,), 1, dev)
    K.check(dtables, "dtables", (torch.int16,), 2, dev)
    L, S = lanes.shape
    if table_idx.shape[0] != L or dtables.shape[1] != 4096:
        raise ValueError("decode_lanes: expected table_idx (L,), dtables "
                         f"(C, 4096) for L={L}")
    if S < 1:
        raise ValueError("decode_lanes: empty lane rows")
    if bad is None and route == "cuda":
        raise ValueError("decode_lanes: on the card, pass `bad` for the "
                         "kernel's table index flags")
    if bad is not None:
        K.check(bad, "bad", (torch.int32,), 1, dev)
        if bad.shape[0] != L:
            raise ValueError(f"decode_lanes: expected bad (L,) for L={L}")
    if route == "plain":
        K.check_index(table_idx, "table_idx", dtables.shape[0])
        if bad is not None:
            bad.zero_()
        return _decode_lanes_plain(lanes, table_idx, dtables)
    out = torch.empty(L, FRAG, dtype=torch.uint8, device=dev)
    K.launch("decode_lanes", "kz_decode_lanes", dev, lanes.data_ptr(), L, S,
             table_idx.data_ptr(), dtables.data_ptr(), dtables.shape[0],
             out.data_ptr(), bad.data_ptr())
    return out
