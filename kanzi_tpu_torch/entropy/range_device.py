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
a header, the device decodes the chunk (ops.range.decode_chunks), and the
host advances its bit cursor by 60 + 28*nreads. The blocks of a batch walk
in lockstep (range_decode_many): for each chunk index one native step
(kz_range_dec_step) parses every block's header and writes the launch's
rows into arrays allocated once for the batch, and one launch takes a row
per block. chunk_batch is one block's step alone (kz_range_dec_chunk).
`device` is a CUDA device (the kernels) or "cpu" (the plain PyTorch
versions, used by the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels, native
from ..core import ERR_PROCESS_BLOCK, KanziError
from ..ops import range as ops_range
from ..ops.state import to_port_state
from . import device_io

_CHUNK = native.RANGE_CHUNK
_BUF_CAP = 2 * _CHUNK + 8192   # a chunk's coder stream, and slack
# the most any chunk can read: 60 bits, then two 28-bit words a byte (a
# third word a byte is a state the decode flags), and a guard; a row cut
# at _BUF_CAP that fails decodes again with this much
_BUF_FULL = 7 * _CHUNK + 64


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


def chunk_batch(src: np.ndarray, bit_pos: int, size: int, nbits=None,
                held: np.ndarray | None = None, cap: int = _BUF_CAP):
    """One block's host half of one step of the chunk walk, which
    range_decode_many takes for all blocks at once: parse the chunk
    header at `bit_pos` of the payload's first `nbits` bits (all of it by
    default). `held` is the host decoder's slot table as the block's
    earlier chunks left it (empty for the first): the host decoder grows
    it to the largest table of the block and never clears it, so a
    hostile quotient past this chunk's table reads an earlier chunk's
    slot, and one past the whole table throws. Returns (the bit position
    past the header, the single symbol of a header-only chunk or None,
    the {bufs, nbytes, nbits, rng_tables, f2s, shifts, nvalid, bound} numpy
    row of a chunk to decode, the slot table after this chunk). The row
    holds the payload's next `cap` - 16 bytes at most (its `nbits`)."""
    nbits = 8 * len(src) if nbits is None else nbits
    hdr_end, tables, f2s, shift, flag, aux, buf = \
        native.range_dec_chunk(src, bit_pos, cap, nbits)
    scale = 1 << shift
    held = np.zeros(0, np.uint8) if held is None else held
    if len(held) < scale:
        held = np.concatenate([held, np.zeros(scale - len(held), np.uint8)])
    else:
        held = held.copy()
    held[:scale] = aux if flag == 2 else f2s[:scale]
    if flag == 2:
        return hdr_end, aux, None, held
    # the payload's bits after the header, as kz_range_dec_chunk copied them
    rest = min(nbits - hdr_end, 8 * (cap - 16))
    nbytes = (rest + 7) >> 3
    slots = np.zeros(4096 if len(held) <= 4096 else 1 << 15, np.uint8)
    slots[:len(held)] = held
    return hdr_end, None, {"bufs": buf[None, :max(nbytes, 1)],
                           "nbytes": np.array([nbytes], np.int32),
                           "nbits": np.array([rest], np.int32),
                           "rng_tables": tables[None], "f2s": slots[None],
                           "shifts": np.array([shift], np.int32),
                           "nvalid": np.array([size], np.int32),
                           "bound": np.array([len(held)], np.int32)}, held


# the rows a launch takes, as native.RangeWalk.step writes them
_ROW_INTS = ("nbytes", "nbits", "shifts", "nvalid", "bound", "single")


def _alloc_rows(nrows: int, cap: int, pin: bool) -> dict:
    """Row arrays for `nrows` rows of at most `cap` - 16 payload bytes,
    flat, for _rows to view; f2s holds up to 32768 slots a row; syms and
    nreads take a launch's outputs. In pinned host memory where `pin` is
    set, so that a launch's copies to and from the card start at once."""
    def alloc(n, dtype):
        return torch.empty(n, dtype=dtype, pin_memory=pin).numpy()
    flat = {name: alloc(nrows, torch.int32) for name in _ROW_INTS}
    flat.update(bufs=alloc(nrows * (cap - 16), torch.uint8),
                rng_tables=alloc(nrows * 512, torch.int32),
                f2s=alloc(nrows * _CHUNK, torch.uint8),
                hdr_end=alloc(nrows, torch.int64),
                syms=alloc(nrows * _CHUNK, torch.uint8),
                nreads=alloc(nrows, torch.int32))
    return flat


def _rows(flat: dict, n: int, width: int) -> dict:
    """C-contiguous views of the first `n` rows of _alloc_rows' arrays,
    with `width` bytes a payload row; f2s is left to _slots."""
    out = {name: flat[name][:n] for name in (*_ROW_INTS, "hdr_end")}
    out["bufs"] = flat["bufs"][:n * width].reshape(n, width)
    out["rng_tables"] = flat["rng_tables"][:n * 512].reshape(n, 2, 256)
    return out


def _width(walk, blocks: np.ndarray, cap: int) -> int:
    """The row width of a step over `blocks`: the most payload bytes any
    of their rows can hold (the rest of its payload from its header on,
    at most `cap` - 16)."""
    rest = (walk.bits[blocks] - walk.pos[blocks] + 7) >> 3
    return int(max(1, min(cap - 16, int(rest.max()))))


def _slots(walk, flat: dict, rows: dict, blocks: np.ndarray) -> None:
    """Each row's f2s: its block's held slot table, zeros past its length,
    4096 slots a row, or 32768 where any row's table is longer (the
    batch's widest, as one launch takes them)."""
    n = len(blocks)
    F = 4096 if int(rows["bound"].max()) <= 4096 else _CHUNK
    rows["f2s"] = flat["f2s"][:n * F].reshape(n, F)
    np.take(walk.held[:, :F], blocks, axis=0, out=rows["f2s"])


def _launch(rows: dict, device, flat: dict) -> tuple:
    """ONE chunk decode launch on `device` for the rows (numpy arrays;
    pinned host memory on a CUDA device): (symbols, nreads) as numpy
    arrays, on a CUDA device read back into `flat`'s "syms" and "nreads"
    (views that the next launch into them overwrites). The rows may be
    written again once it returns."""
    names = ("bufs", "nbytes", "rng_tables", "f2s", "shifts", "nvalid", "nbits", "bound")
    n, glen = len(rows["nvalid"]), int(rows["nvalid"].max())
    with _kernels.card_errors("range_decode"):
        st = {name: torch.from_numpy(rows[name]) for name in names}
        if device.type == "cuda":
            st = {name: t.to(device, non_blocking=True) for name, t in st.items()}
        syms, nreads = ops_range.decode_chunks(
            st["bufs"], st["nbytes"], st["rng_tables"], st["f2s"], st["shifts"],
            st["nvalid"], glen, st["nbits"], st["bound"])
        if device.type != "cuda":
            return syms.numpy(), nreads.numpy()
        out = flat["syms"][:n * glen].reshape(n, glen), flat["nreads"][:n]
        for host, t in zip(out, (syms, nreads)):
            torch.from_numpy(host).copy_(t, non_blocking=True)
        # the read-back waits for the launch, and with it the copies
        torch.cuda.current_stream(device).synchronize()
        return out


def range_decode_many(payloads, out_lens, device, nbits=None) -> list:
    """Decode the range payloads of a batch of blocks with the device
    pipeline. The format forces each block's chunk walk (a chunk's header
    begins where the previous chunk's renorm reads ended), so the blocks'
    walks step in lockstep: for chunk index c, one native step
    (native.RangeWalk) parses the header of chunk c of every block that has
    one and writes the rows of the launch, and ONE decode launch takes a
    row for each of those chunks that is not header-only; each block's
    cursor then moves by 60 + 28*nreads of its row. That is as many
    launches as the longest block has chunks, at most. Returns per block
    its uint8 array, byte-identical to the host decoder, or the exception
    that rejected it: NativeError for a header the host rejects,
    KanziError where the host decoder fails (renorm reads past the
    payload, decode_chunks' `bound` rules). `nbits`, where given, holds
    each payload's bit count. A launch or read-back that fails raises
    DeviceFault. Nothing is retried on the host."""
    device = torch.device(device)
    walk = native.RangeWalk(payloads, nbits)
    lens = np.array(out_lens, np.int64)
    # each block's output is a row of one array, so that a step's symbols
    # land in one copy; the rows' tails past their blocks are never read
    out = np.empty((len(lens), int(lens.max(initial=0))), np.uint8)
    res: list = [out[i, :n] for i, n in enumerate(out_lens)]
    failed = np.zeros(len(lens), bool)
    live = np.flatnonzero(lens > 0).astype(np.int32)
    pin = device.type == "cuda"
    flat = _alloc_rows(len(live), _BUF_CAP, pin)
    start = 0
    while len(live):
        sizes = np.minimum(_CHUNK, lens[live] - start).astype(np.int32)
        rows = _rows(flat, len(live), _width(walk, live, _BUF_CAP))
        walk.step(live, sizes, _BUF_CAP, rows)
        _kernels.count_walk("range_steps")
        hdr_end, single = rows["hdr_end"], rows["single"]
        for k in np.flatnonzero(hdr_end < 0):
            res[live[k]] = native.NativeError(
                f"range decode prepare failed (err={hdr_end[k]})")
            failed[live[k]] = True
        for k in np.flatnonzero((hdr_end >= 0) & (single >= 0)):
            # single-symbol chunk: header only
            res[live[k]][start:start + sizes[k]] = single[k]
            walk.pos[live[k]] = hdr_end[k]
        todo = np.flatnonzero((hdr_end >= 0) & (single < 0))
        if len(todo):
            if len(todo) < len(live):
                # the launch's rows first, in order
                for a in rows.values():
                    a[:len(todo)] = a[todo]
                rows = {name: a[:len(todo)] for name, a in rows.items()}
            blocks, sizes = live[todo], sizes[todo]
            _slots(walk, flat, rows, blocks)
            syms, nreads = _launch(rows, device, flat)
            # a row cut short of its payload that failed decodes again
            # with all a chunk can read
            again = np.flatnonzero((nreads < 0) & (
                rows["nbits"] < walk.bits[blocks] - rows["hdr_end"]))
            if len(again):
                more = blocks[again]
                flat_full = _alloc_rows(len(again), _BUF_FULL, pin)
                full = _rows(flat_full, len(again), _width(walk, more, _BUF_FULL))
                walk.step(more, sizes[again], _BUF_FULL, full)
                _kernels.count_walk("range_reparsed", len(again))
                _slots(walk, flat_full, full, more)
                syms2, nreads2 = _launch(full, device, flat_full)
                nreads[again] = nreads2
                syms[again, :syms2.shape[1]] = syms2
            ok = nreads >= 0
            for i in blocks[~ok]:
                res[i] = KanziError("range decode: the chunk's state or "
                                    "renorm reads leave the payload", ERR_PROCESS_BLOCK)
                failed[i] = True
            # symbols past a row's nvalid are zeros, and land past its block
            if ok.all():
                out[blocks, start:start + syms.shape[1]] = syms
            else:
                out[blocks[ok], start:start + syms.shape[1]] = syms[ok]
            walk.pos[blocks[ok]] = rows["hdr_end"][ok] + 60 + 28 * nreads[ok].astype(np.int64)
        start += _CHUNK
        live = live[(start < lens[live]) & ~failed[live]]
    return res


def range_decode_device(payload, out_len: int, device, nbits=None) -> bytes:
    """Decode one range entropy payload (its first `nbits` bits, all of it
    by default) with the device pipeline (a batch of one: its chunk walk,
    one launch per chunk); a rejected payload raises as range_decode_many
    says."""
    if out_len == 0:
        return b""
    return device_io.one(range_decode_many([payload], [out_len], device, [nbits]))
