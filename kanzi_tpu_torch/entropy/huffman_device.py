"""Device-engine Huffman encoder and decoder.

Heterogeneous pipeline: the host (C++) builds per-chunk code tables and the
encoded table headers (kz_huffman_prepare); the device packs the 4
interleaved lane bit-streams of all chunks in one batched kernel
(ops.huffman.pack_lanes); the host splices headers, per-lane varint sizes,
lane payloads and trailing bytes into the final payload. Decode mirrors it:
the host parses headers and builds 4096-entry decode tables
(kz_huffman_dec_prepare), the device decodes all lanes in one kernel
(ops.huffman.decode_lanes), the host reassembles the chunks.

Output is byte-identical to the host C++ encoder, so either engine can feed
the KANZ container. `device` is a CUDA device (the kernels) or "cpu" (the
plain PyTorch versions, used by the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..ops import huffman as ops_huffman
from ..ops.state import to_port_state

_CHUNK = 16384
_FRAG = ops_huffman.FRAG


def _lane_bytes(words: np.ndarray) -> np.ndarray:
    """(L, nwords) int32 bit patterns -> (L, 4*nwords) big-endian bytes."""
    be = np.ascontiguousarray(words.view(np.uint32).astype(">u4"))
    return be.reshape(words.shape[0], -1).view(np.uint8)


class DeviceHuffmanEngine:
    """Device entropy stage with async overlap.

    dispatch() builds the lane batch on the host (C++ table/header prep,
    numpy lane reshape) and launches the pack kernel on the engine's own
    CUDA stream without waiting; the device packs lanes while the host
    transforms the next block. collect() waits on the batch's event and
    splices the payload in C++ (kz_huffman_assemble), byte-identical to the
    host encoder.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)

    def _build_lanes(self, post: np.ndarray, flags: np.ndarray):
        """(syms, lens, tidx) lane arrays for one block, or (None,)*3."""
        n = len(post)
        nchunks = len(flags)
        nfull = n // _CHUNK
        rows, tidx, lens = [], [], []
        # full chunks reshape directly to (4, FRAG)
        if nfull:
            full = post[: nfull * _CHUNK].reshape(nfull, 4, _FRAG)
            keep = flags[:nfull] == 0
            if keep.any():
                kept_chunks = np.nonzero(keep)[0]
                rows.append(full[kept_chunks].reshape(-1, _FRAG))
                tidx.append(np.repeat(kept_chunks, 4))
                lens.append(np.full(4 * len(kept_chunks), _FRAG, np.int32))
        if nchunks > nfull and flags[nfull] == 0:  # partial last chunk
            start = nfull * _CHUNK
            frag = (n - start) // 4
            tail = np.zeros((4, _FRAG), dtype=np.uint8)
            for j in range(4):
                tail[j, :frag] = post[start + j * frag: start + (j + 1) * frag]
            rows.append(tail)
            tidx.append(np.full(4, nfull, np.int32))
            lens.append(np.full(4, frag, np.int32))
        if not rows:
            return None, None, None
        return (np.concatenate(rows),
                np.concatenate(lens).astype(np.int32),
                np.concatenate(tidx).astype(np.int32))

    def dispatch(self, post: np.ndarray):
        """Start packing one block's lanes. Returns an opaque handle."""
        return self.dispatch_many([post])[0]

    def dispatch_many(self, posts):
        """Pack every block's lanes in ONE kernel launch. Returns one
        opaque handle per block, same contract as dispatch()."""
        preps, batch = self.lane_batch(posts)
        holder = self._launch(*batch) if batch is not None else None
        # posts must stay alive until collect(): copy is the caller's concern
        return [(post, hdr, hdr_bits, flags, holder, lo, nl)
                for post, hdr, hdr_bits, flags, lo, nl in preps]

    def lane_batch(self, posts):
        """The host half of dispatch_many: per-block prep records and the
        (syms, lane_len, table_idx, tables) numpy batch of all blocks, or
        None when no chunk carries lanes. Lanes round up to a multiple of
        64 and tables to 16, as the JAX engine buckets its shapes (bounded
        zero padding)."""
        preps = []
        all_syms, all_lens, all_tidx, all_tables = [], [], [], []
        lane_base = 0
        table_base = 0
        for post in posts:
            tables, hdr, hdr_bits, flags = native.huffman_prepare(post)
            syms, lens, tidx = self._build_lanes(post, flags)
            nl = 0 if syms is None else len(syms)
            preps.append((post, hdr, hdr_bits, flags, lane_base, nl))
            if nl:
                all_syms.append(syms)
                all_lens.append(lens)
                all_tidx.append(tidx + table_base)
                lane_base += nl
            all_tables.append(tables)
            table_base += len(tables)
        if not lane_base:
            return preps, None
        syms = np.concatenate(all_syms)
        lens = np.concatenate(all_lens)
        tidx = np.concatenate(all_tidx)
        pad = -(-lane_base // 64) * 64 - lane_base
        if pad:
            syms = np.concatenate([syms, np.zeros((pad, _FRAG), syms.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
            tidx = np.concatenate([tidx, np.zeros(pad, tidx.dtype)])
        tables = np.concatenate(all_tables)
        tpad = -(-len(tables) // 16) * 16 - len(tables)
        if tpad:
            tables = np.concatenate([tables, np.zeros((tpad, 256), tables.dtype)])
        return preps, (syms, lens, tidx, tables)

    def _pack(self, syms, lens, tidx, tables):
        st = to_port_state({"syms": syms, "lane_len": lens,
                            "table_idx": tidx, "tables": tables}, self.device)
        return st, ops_huffman.pack_lanes(st["syms"], st["lane_len"],
                                          st["table_idx"], st["tables"])

    def _launch(self, syms, lens, tidx, tables) -> "_PackResult":
        if self._stream is None:
            _st, (words, nbits) = self._pack(syms, lens, tidx, tables)
            return _PackResult(words, nbits, None, None)
        with torch.cuda.stream(self._stream):
            st, (words, nbits) = self._pack(syms, lens, tidx, tables)
            words_h = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
            nbits_h = torch.empty(nbits.shape, dtype=nbits.dtype, pin_memory=True)
            words_h.copy_(words, non_blocking=True)
            nbits_h.copy_(nbits, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        # the device tensors stay referenced until the event has fired
        return _PackResult(words_h, nbits_h, event, (st, words, nbits))

    def collect(self, handle, dst: np.ndarray, dst_off: int) -> int:
        """Wait for the device result and splice the payload into dst."""
        post, hdr, hdr_bits, flags, holder, lo, nl = handle
        if holder is not None and nl:
            words, nbits = holder.get()
            nbits = np.ascontiguousarray(nbits[lo:lo + nl])
            lane_bytes = _lane_bytes(words[lo:lo + nl])
        else:
            nbits = np.zeros(0, dtype=np.int32)
            lane_bytes = np.zeros((0, 4), dtype=np.uint8)
        return native.huffman_assemble(post, hdr, hdr_bits, flags,
                                       lane_bytes, nbits, dst, dst_off)


class _PackResult:
    """Host copies of one launch's words and bit counts, read once the
    launch's event has fired."""

    __slots__ = ("_words", "_nbits", "_event", "_keep", "_np")

    def __init__(self, words, nbits, event, keep):
        self._words, self._nbits = words, nbits
        self._event, self._keep = event, keep
        self._np = None

    def get(self):
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = (self._words.numpy(), self._nbits.numpy())
            self._keep = None
        return self._np


def huffman_decode_device(payload, out_len: int, device) -> bytes:
    """Decode a Huffman entropy payload with the device pipeline; the
    lane decode runs on `device`. Byte-identical to the host decoder.
    A payload that the host prepare rejects raises RuntimeError."""
    if out_len == 0:
        return b""
    device = torch.device(device)
    src = np.frombuffer(payload, dtype=np.uint8) \
        if not isinstance(payload, np.ndarray) else payload
    dtables, lanes, flags, aux = native.huffman_dec_prepare(src, out_len)
    if len(lanes):
        dev_chunks = np.nonzero(flags == 0)[0].astype(np.int32)
        # the prepare's pooled views are copied here, before the next call
        st = to_port_state({"lanes": lanes, "table_idx": np.repeat(dev_chunks, 4),
                            "dtables": dtables}, device)
        syms = ops_huffman.decode_lanes(st["lanes"], st["table_idx"],
                                        st["dtables"]).cpu().numpy()
    else:
        syms = None
    out = np.empty(out_len, dtype=np.uint8)
    lane = 0
    for c in range(len(flags)):
        start = c * _CHUNK
        size = min(_CHUNK, out_len - start)
        if flags[c] == 1:          # raw small chunk
            out[start:start + size] = aux[c, :size]
        elif flags[c] == 2:        # single symbol
            out[start:start + size] = aux[c, 0]
        else:
            frag = size // 4
            out[start:start + 4 * frag] = syms[lane:lane + 4, :frag].reshape(-1)
            tail = size & 3
            if tail:
                out[start + 4 * frag:start + size] = aux[c, :tail]
            lane += 4
    return out.tobytes()


def huffman_encode_device(buf, device) -> tuple[bytes, int]:
    """Encode a block with the device pipeline, the Writer's own path: one
    engine dispatch and one collect. Returns (payload, bits)."""
    src = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if len(src) == 0:
        return b"", 0
    engine = DeviceHuffmanEngine(device)
    handle = engine.dispatch(src)
    dst = np.zeros(2 * len(src) + 65536, dtype=np.uint8)
    bits = engine.collect(handle, dst, 0)
    return dst[:(bits + 7) >> 3].tobytes(), bits
