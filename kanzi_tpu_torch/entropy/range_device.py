"""Device-engine range codec (Subbotin, order 0).

The split of the Huffman and ANS engines: the host (C++) builds per-chunk
normalized tables and encoded headers (kz_range_prepare), the device runs
the 60-bit coder over every chunk of a batch in one kernel
(ops.range.encode_chunks), and the host splices headers, 28-bit renorm
words and the final 60-bit low of each chunk (kz_range_assemble),
byte-identical to the host encoder.

Decode differs: the range format has no per-chunk stream length (a
chunk's header begins where the previous chunk's last renorm read ended),
so the chunks of one payload are walked one after another: the host parses
a header (kz_range_dec_chunk), the device decodes the chunk
(ops.range.decode_chunks), and the host advances its bit cursor by
60 + 28*nreads. The blocks of a batch walk in lockstep, one launch per
chunk index with a row per block (range_decode_many). `device` is a CUDA device (the kernels) or "cpu" (the
plain PyTorch versions, used by the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core import ERR_PROCESS_BLOCK, KanziError
from ..ops import range as ops_range
from ..ops.state import to_port_state
from . import device_io

_CHUNK = native.RANGE_CHUNK
_BUF_CAP = 2 * _CHUNK + 8192   # a chunk's coder stream, and slack


class DeviceRangeEngine:
    """Device entropy stage with async overlap, the DeviceHuffmanEngine
    contract: dispatch()/dispatch_many() launch the encode kernel on the
    engine's own CUDA stream without waiting; collect() waits on the
    batch's event and splices the payload in C++ (kz_range_assemble)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)

    def dispatch(self, post: np.ndarray):
        """Start encoding one block. Returns an opaque handle."""
        return self.dispatch_many([post])[0]

    def dispatch_many(self, posts):
        """Encode the chunks of every block in ONE kernel launch. Returns
        one opaque handle per block, same contract as dispatch()."""
        return self.dispatch_prepped([self.prep(p) for p in posts])

    @staticmethod
    def prep(post: np.ndarray):
        """The host half of one block: C++ tables and headers of its
        chunks. Owns its arrays, so the Writer runs it for several blocks
        at once on its pool."""
        tables, hdr, hdr_bits, flags, shifts = native.range_prepare(post)
        return post, tables, hdr, hdr_bits, flags, shifts

    def dispatch_prepped(self, preps):
        """Stack the prep() records of a batch and launch the encode once
        (from the calling thread: the engine has one CUDA stream). Returns
        one handle per block."""
        records, batch = self._stack(preps)
        holder = self._launch(batch) if batch is not None else None
        return [(post, hdr, hdr_bits, flags, dev_chunks,
                 holder if len(dev_chunks) else None, lo)
                for post, hdr, hdr_bits, flags, dev_chunks, lo in records]

    def encode_batch(self, posts):
        """The host half of dispatch_many: per-block records and the
        {rng_syms, nvalid, rng_tables, shifts} numpy batch of all device
        chunks, or None when no chunk goes to the device."""
        return self._stack([self.prep(p) for p in posts])

    @staticmethod
    def _stack(preps):
        """Columns: the longest chunk of the batch, rounded up to 256."""
        records = []
        pieces, all_tables, all_shifts = [], [], []
        for post, tables, hdr, hdr_bits, flags, shifts in preps:
            dev_chunks = np.nonzero(flags == 0)[0]
            records.append((post, hdr, hdr_bits, flags, dev_chunks, len(pieces)))
            pieces += [post[c * _CHUNK:(c + 1) * _CHUNK] for c in dev_chunks]
            all_tables.append(tables[dev_chunks])
            all_shifts.append(shifts[dev_chunks])
        if not pieces:
            return records, None
        width = -(-max(len(p) for p in pieces) // 256) * 256
        syms = np.zeros((len(pieces), width), dtype=np.uint8)
        nvalid = np.zeros(len(pieces), dtype=np.int32)
        for r, p in enumerate(pieces):
            syms[r, :len(p)] = p
            nvalid[r] = len(p)
        return records, {"rng_syms": syms, "nvalid": nvalid,
                         "rng_tables": np.concatenate(all_tables),
                         "shifts": np.concatenate(all_shifts)}

    def _launch(self, batch) -> device_io.HostResult:
        def run():
            st = to_port_state(batch, self.device)
            return st, ops_range.encode_chunks(st["rng_syms"], st["nvalid"],
                                               st["rng_tables"], st["shifts"])
        return device_io.launch(self._stream, run)

    def collect(self, handle, dst: np.ndarray, dst_off: int) -> int:
        """Wait for the device result and splice the payload into dst.
        Returns the payload's bit length."""
        post, hdr, hdr_bits, flags, dev_chunks, holder, lo = handle
        nchunks = len(flags)
        words = np.zeros((nchunks, 0), dtype=np.uint32)
        nwords = np.zeros(nchunks, dtype=np.int32)
        lows = np.zeros((nchunks, 2), dtype=np.uint32)
        if holder is not None:
            w, nw, lw = (a[lo:lo + len(dev_chunks)] for a in holder.get())
            maxw = int(nw.max())
            # the assembler reads only words[c, :nwords[c]]: header-only
            # rows may stay uninitialized
            words = np.empty((nchunks, maxw), dtype=np.uint32)
            words[dev_chunks] = w[:, :maxw].view(np.uint32)
            nwords[dev_chunks] = nw
            lows[dev_chunks] = lw.view(np.uint32)
        return native.range_assemble(post, hdr, hdr_bits, flags, words, nwords,
                                     lows, dst, dst_off)


def range_encode_device(buf, device) -> tuple[bytes, int]:
    """Encode one block with the device pipeline, the Writer's own path:
    one engine dispatch and one collect. Returns (payload, bits)."""
    src = np.frombuffer(buf, dtype=np.uint8) \
        if not isinstance(buf, np.ndarray) else buf
    if len(src) == 0:
        return b"", 0
    return device_io.encode_block(DeviceRangeEngine(device), src, 8192)


def chunk_batch(src: np.ndarray, bit_pos: int, size: int):
    """The host half of one step of range_decode_device: parse the chunk
    header at `bit_pos`. Returns (the bit position past the header, the
    single symbol of a header-only chunk or None, and the {bufs, nbytes,
    rng_tables, f2s, shifts, nvalid} numpy row of a chunk to decode)."""
    hdr_end, tables, f2s, shift, flag, aux, buf = \
        native.range_dec_chunk(src, bit_pos, _BUF_CAP)
    if flag == 2:
        return hdr_end, aux, None
    # the payload's bits after the header, as kz_range_dec_chunk copied them
    nbytes = (min(8 * len(src) - hdr_end, 8 * (_BUF_CAP - 16)) + 7) >> 3
    return hdr_end, None, {"bufs": buf[None, :max(nbytes, 1)],
                           "nbytes": np.array([nbytes], np.int32),
                           "rng_tables": tables[None], "f2s": f2s[None],
                           "shifts": np.array([shift], np.int32),
                           "nvalid": np.array([size], np.int32)}


def range_decode_many(payloads, out_lens, device) -> list:
    """Decode the range payloads of a batch of blocks with the device
    pipeline. The format forces each block's chunk walk (a chunk's header
    begins where the previous chunk's renorm reads ended), so the blocks'
    walks step in lockstep: for chunk index c, the host parses the header
    of chunk c of every block that has one, and ONE decode launch takes a
    row for each of those chunks that is not header-only; each block's
    cursor then moves by 60 + 28*nreads of its row. That is as many
    launches as the longest block has chunks, at most. Returns per block
    its uint8 array, byte-identical to the host decoder, or the exception
    that rejected it: RuntimeError for a header the host rejects,
    KanziError for renorm reads past the payload. Nothing is retried on
    the host."""
    device = torch.device(device)
    srcs = [np.frombuffer(p, np.uint8) if not isinstance(p, np.ndarray) else p
            for p in payloads]
    res: list = [np.empty(n, dtype=np.uint8) for n in out_lens]
    bit_pos = [0] * len(srcs)
    live = [i for i, n in enumerate(out_lens) if n > 0]
    start = 0
    while live:
        rows, owners = [], []
        for i in live:
            size = min(_CHUNK, out_lens[i] - start)
            try:
                hdr_end, single, row = chunk_batch(srcs[i], bit_pos[i], size)
            except RuntimeError as e:
                res[i] = e
                continue
            if row is None:              # single-symbol chunk: header only
                res[i][start:start + size] = single
                bit_pos[i] = hdr_end
            else:
                rows.append(row)
                owners.append((i, hdr_end, size))
        if rows:
            batch = device_io.stack(rows)
            st = to_port_state(batch, device)
            syms, nreads = ops_range.decode_chunks(
                st["bufs"], st["nbytes"], st["rng_tables"], st["f2s"],
                st["shifts"], st["nvalid"], int(batch["nvalid"].max()))
            syms = syms.cpu().numpy()
            nreads = nreads.cpu().numpy()
            for r, (i, hdr_end, size) in enumerate(owners):
                nr = int(nreads[r])
                if nr < 0:
                    res[i] = KanziError("range decode: renorm reads past the "
                                        "payload", ERR_PROCESS_BLOCK)
                    continue
                res[i][start:start + size] = syms[r, :size]
                bit_pos[i] = hdr_end + 60 + 28 * nr
        start += _CHUNK
        live = [i for i in live
                if start < out_lens[i] and not isinstance(res[i], Exception)]
    return res


def range_decode_device(payload, out_len: int, device) -> bytes:
    """Decode one range entropy payload with the device pipeline (a batch
    of one: its chunk walk, one launch per chunk); a rejected payload
    raises as range_decode_many says."""
    if out_len == 0:
        return b""
    return device_io.one(range_decode_many([payload], [out_len], device))
