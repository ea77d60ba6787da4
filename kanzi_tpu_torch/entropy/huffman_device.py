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

from .. import _kernels, native
from ..core import ERR_PROCESS_BLOCK, KanziError
from ..ops import huffman as ops_huffman
from ..ops.state import to_port_state
from . import device_io

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
        return self.dispatch_prepped([self.prep(p) for p in posts])

    def prep(self, post: np.ndarray):
        """The host half of one block: C++ tables and headers, and the
        block's lane rows. Owns its arrays, so the Writer runs it for
        several blocks at once on its pool."""
        tables, hdr, hdr_bits, flags = native.huffman_prepare(post)
        return (post, hdr, hdr_bits, flags, tables) + self._build_lanes(post, flags)

    def dispatch_prepped(self, preps):
        """Stack the prep() records of a batch and launch the pack once
        (from the calling thread: the engine has one CUDA stream). Returns
        one handle per block."""
        records, batch = self._stack(preps)
        holder = self._launch(*batch) if batch is not None else None
        # posts must stay alive until collect(): copy is the caller's concern
        return [(post, hdr, hdr_bits, flags, holder, lo, nl)
                for post, hdr, hdr_bits, flags, lo, nl in records]

    def lane_batch(self, posts):
        """The host half of dispatch_many: per-block records and the
        (syms, lane_len, table_idx, tables) numpy batch of all blocks, or
        None when no chunk carries lanes."""
        return self._stack([self.prep(p) for p in posts])

    def _stack(self, preps):
        """Lanes round up to a multiple of 64 and tables to 16, as the JAX
        engine buckets its shapes (bounded zero padding)."""
        records = []
        all_syms, all_lens, all_tidx, all_tables = [], [], [], []
        lane_base = 0
        table_base = 0
        for post, hdr, hdr_bits, flags, tables, syms, lens, tidx in preps:
            nl = 0 if syms is None else len(syms)
            records.append((post, hdr, hdr_bits, flags, lane_base, nl))
            if nl:
                all_syms.append(syms)
                all_lens.append(lens)
                all_tidx.append(tidx + table_base)
                lane_base += nl
            all_tables.append(tables)
            table_base += len(tables)
        if not lane_base:
            return records, None
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
        return records, (syms, lens, tidx, tables)

    def _pack(self, syms, lens, tidx, tables):
        st = to_port_state({"syms": syms, "lane_len": lens,
                            "table_idx": tidx, "tables": tables}, self.device)
        return st, ops_huffman.pack_lanes(st["syms"], st["lane_len"],
                                          st["table_idx"], st["tables"])

    def _launch(self, syms, lens, tidx, tables) -> device_io.HostResult:
        return device_io.launch(self._stream,
                                lambda: self._pack(syms, lens, tidx, tables))

    def collect(self, handle, dst: np.ndarray, dst_off: int) -> int:
        """Wait for the device result and splice the payload into dst."""
        post, hdr, hdr_bits, flags, holder, lo, nl = handle
        if holder is not None and nl:
            words, nbits = holder.get()
            nbits = np.ascontiguousarray(nbits[lo:lo + nl])
            if (nbits < 0).any():        # the kernel's table index flag
                raise KanziError("huffman encode: a lane's table index is "
                                 "out of range", ERR_PROCESS_BLOCK)
            lane_bytes = _lane_bytes(words[lo:lo + nl])
        else:
            nbits = np.zeros(0, dtype=np.int32)
            lane_bytes = np.zeros((0, 4), dtype=np.uint8)
        return native.huffman_assemble(post, hdr, hdr_bits, flags,
                                       lane_bytes, nbits, dst, dst_off)


def _dec_prep(args):
    """The host half of one block's decode: the prepare's tables, lanes,
    chunk flags and raw bytes (the pooled tables and lanes copied, before
    this thread's next prepare overwrites them)."""
    src, out_len, nbits = args
    dtables, lanes, flags, aux = native.huffman_dec_prepare(src, out_len, nbits)
    return dtables.copy(), lanes.copy(), flags, aux


def decode_rows(batch: dict, device) -> tuple:
    """ONE lane decode launch on `device` for a batch's stacked
    {lanes, table_idx, dtables} rows: (symbols, the kernel's table index
    flags) as numpy arrays, copied back together."""
    st = to_port_state(batch, device)
    bad = torch.empty(len(batch["lanes"]), dtype=torch.int32, device=device)

    def run():
        return st, (ops_huffman.decode_lanes(st["lanes"], st["table_idx"],
                                             st["dtables"], bad), bad)

    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    return device_io.launch(stream, run).get()


def huffman_decode_many(payloads, out_lens, device, map_fn=map, hook=None,
                        nbits=None) -> list:
    """Decode the Huffman payloads of a batch of blocks with ONE lane
    decode launch on `device` for the lanes of every block (each block's
    table indices offset by the tables before it), or through `hook`, a
    function with decode_rows' contract without the device (a mesh's
    sharded decode, parallel.mesh_decode_hooks). The host prepares and
    the per-block assembly run through `map_fn` (the Reader's pool.map).
    Returns per block its uint8 array, byte-identical to the host decoder,
    or the exception that rejected it: NativeError from the host prepare,
    KanziError for a lane whose table index the kernel flags, and for
    every block with lanes the rejection (device_io.REJECTIONS) a hook
    raised. A launch or read-back that fails raises DeviceFault, as does
    an error of the card inside a hook. Nothing is retried on the host."""
    device = torch.device(device)
    preps = device_io.each(map_fn, _dec_prep, [
        (np.frombuffer(p, np.uint8) if not isinstance(p, np.ndarray) else p, n, b)
        for p, n, b in zip(payloads, out_lens, nbits or [None] * len(payloads))])
    rows, spans, table_base = [], {}, 0
    lane_base = 0
    for i, p in enumerate(preps):
        if isinstance(p, Exception) or not len(p[1]):
            continue
        dtables, lanes, flags, _ = p
        dev_chunks = np.nonzero(flags == 0)[0].astype(np.int32)
        rows.append({"lanes": lanes, "table_idx": np.repeat(dev_chunks, 4) + table_base,
                     "dtables": dtables})
        spans[i] = lane_base
        lane_base += len(lanes)
        table_base += len(dtables)
    syms = lane_bad = failed = None
    if rows:
        batch = device_io.stack(rows)
        try:
            with _kernels.card_errors("decode_lanes"):
                syms, lane_bad = hook(batch) if hook else decode_rows(batch, device)
        except device_io.REJECTIONS as e:
            failed = e

    def finish(i):
        p = preps[i]
        if isinstance(p, Exception):
            raise p
        if failed is not None and i in spans:
            raise failed
        _, lanes, flags, aux = p
        lane = spans.get(i, 0)
        if len(lanes) and lane_bad[lane:lane + len(lanes)].any():
            raise KanziError("huffman decode: a lane's table index is out of "
                             "range", ERR_PROCESS_BLOCK)
        out_len = out_lens[i]
        out = np.empty(out_len, dtype=np.uint8)
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
        return out

    return device_io.each(map_fn, finish, range(len(preps)))


def huffman_decode_device(payload, out_len: int, device, hook=None,
                          nbits=None) -> bytes:
    """Decode one Huffman entropy payload (its first `nbits` bits, all of
    it by default) with the device pipeline (a batch of one, through `hook`
    where given); a rejected payload raises as huffman_decode_many says."""
    if out_len == 0:
        return b""
    return device_io.one(huffman_decode_many([payload], [out_len], device,
                                             hook=hook, nbits=[nbits]))


def huffman_encode_device(buf, device) -> tuple[bytes, int]:
    """Encode a block with the device pipeline, the Writer's own path: one
    engine dispatch and one collect. Returns (payload, bits)."""
    src = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if len(src) == 0:
        return b"", 0
    return device_io.encode_block(DeviceHuffmanEngine(device), src, 65536)
