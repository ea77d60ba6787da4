"""Device-engine rANS encoder and decoder (ANS0/ANS1).

Heterogeneous pipeline, as the Huffman engine's: the host (C++) normalizes
per-chunk frequencies and writes the table headers (kz_ans_prepare); the
device runs the 4-state reverse-order encode of every chunk of a batch in
one kernel (ops.ans.encode_chunks); the host splices headers, varint
sizes, final states, renorm pairs and raw tails into the payload
(kz_ans_assemble). Decode mirrors it: the host parses the headers into
freq->symbol maps and (freq, cumFreq) tables (kz_ans_dec_prepare), the
device decodes every chunk of the block in one kernel
(ops.ans.decode_chunks), the host places symbols and tails.

Output is byte-identical to the host C++ encoder, so either engine can
feed the KANZ container. `device` is a CUDA device (the kernels) or "cpu"
(the plain PyTorch versions, used by the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels, native
from ..core import ERR_PROCESS_BLOCK, KanziError
from ..ops import ans as ops_ans
from ..ops.state import to_port_state
from . import device_io

# blocks the engine hands to the host encoder: an order-1 chunk of 2 or 3
# bytes, which the format cannot encode (the host encoder raises for it)
counts = {"host_route": 0}


def _chunk_size(order: int) -> int:
    return native.ANS1_CHUNK if order == 1 else native.ANS0_CHUNK


def _block_rows(post: np.ndarray, order: int, flags: np.ndarray):
    """Symbol matrices of one block's device chunks: ([(G_c, 4)] per chunk,
    the chunk indices)."""
    chunk = _chunk_size(order)
    build = ops_ans.build_syms_order1 if order == 1 else ops_ans.build_syms_order0
    dev_chunks = np.nonzero(flags == 0)[0]
    return [build(post[c * chunk:(c + 1) * chunk]) for c in dev_chunks], dev_chunks


class DeviceANSEngine:
    """Device entropy stage with async overlap, the DeviceHuffmanEngine
    contract: dispatch()/dispatch_many() build the chunk batch on the host
    and launch the encode kernel on the engine's own CUDA stream without
    waiting; collect() waits on the batch's event and splices the payload
    in C++ (kz_ans_assemble), byte-identical to the host encoder."""

    def __init__(self, order: int, device):
        if order not in (0, 1):
            raise ValueError(f"ANS order must be 0 or 1, got {order}")
        self.order = order
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

    def prep(self, post: np.ndarray):
        """The host half of one block: C++ tables and headers, and the
        symbol matrices of its device chunks. Owns its arrays, so the
        Writer runs it for several blocks at once on its pool."""
        if len(post) <= 32:              # raw small block, on the host
            return post, None, [], None
        try:
            tables, hdr, hdr_bits, flags = native.ans_prepare(post, self.order)
        except native.ShortANS1Chunk:
            counts["host_route"] += 1
            return post, "host", [], None
        rows, dev_chunks = _block_rows(post, self.order, flags)
        return post, (hdr, hdr_bits, flags, dev_chunks), rows, tables[dev_chunks]

    def dispatch_prepped(self, preps):
        """Stack the prep() records of a batch and launch the encode once
        (from the calling thread: the engine has one CUDA stream). Returns
        one handle per block."""
        records, batch = self._stack(preps)
        holder = self._launch(batch) if batch is not None else None
        return [(post, prep, holder if nrows else None, lo, nrows)
                for post, prep, lo, nrows in records]

    def encode_batch(self, posts):
        """The host half of dispatch_many: per-block records and the
        {ans_syms, ngroups, ans_tables} numpy batch of all device chunks,
        or None when no chunk goes to the device."""
        return self._stack([self.prep(p) for p in posts])

    @staticmethod
    def _stack(preps):
        """Rows round up to a multiple of 4 and groups to 256, as the JAX
        engine buckets its shapes (bounded zero padding)."""
        records, mats, all_tables = [], [], []
        for post, prep, rows, tables in preps:
            records.append((post, prep, len(mats), len(rows)))
            mats += rows
            if rows:
                all_tables.append(tables)
        if not mats:
            return records, None
        nrows = len(mats)
        rb = -(-nrows // 4) * 4
        gb = -(-max(len(m) for m in mats) // 256) * 256
        syms = np.zeros((rb, gb, 4), dtype=mats[0].dtype)
        ngroups = np.zeros(rb, dtype=np.int32)
        for r, m in enumerate(mats):
            syms[r, :len(m)] = m
            ngroups[r] = len(m)
        tables = np.concatenate(all_tables)
        if rb != nrows:
            tables = np.concatenate(
                [tables, np.zeros((rb - nrows,) + tables.shape[1:], tables.dtype)])
        return records, {"ans_syms": syms, "ngroups": ngroups, "ans_tables": tables}

    def _launch(self, batch) -> device_io.HostResult:
        def run():
            st = to_port_state(batch, self.device)
            return st, ops_ans.encode_chunks(st["ans_syms"], st["ngroups"],
                                             st["ans_tables"])
        return device_io.launch(self._stream, run)

    def collect(self, handle, dst: np.ndarray, dst_off: int) -> int:
        """Wait for the device result and splice the payload into dst.
        Returns the payload's bit length."""
        post, prep, holder, lo, nrows = handle
        if prep is None:                 # raw small block
            dst[dst_off:dst_off + len(post)] = post
            return 8 * len(post)
        if isinstance(prep, str):        # "host": the host encoder raises
            payload, bits = native.entropy_encode(
                5 if self.order == 0 else 8, post, {"bsVersion": 6})
            dst[dst_off:dst_off + ((bits + 7) >> 3)] = np.frombuffer(payload, np.uint8)
            return bits
        hdr, hdr_bits, flags, dev_chunks = prep
        nchunks = len(flags)
        counts_ = np.zeros(nchunks, dtype=np.int32)
        states = np.full((nchunks, 4), ops_ans.ANS_TOP, dtype=np.int32)
        pair_bytes = np.zeros((nchunks, 0), dtype=np.uint8)
        if holder is not None:
            pairs, npairs, fin = (a[lo:lo + nrows] for a in holder.get())
            maxp = int(npairs.max())
            pair_bytes = np.zeros((nchunks, 2 * maxp), dtype=np.uint8)
            pair_bytes[dev_chunks] = np.ascontiguousarray(
                pairs[:, :maxp].view(np.uint16).astype(">u2")).view(np.uint8)
            counts_[dev_chunks] = npairs
            states[dev_chunks] = fin
        return native.ans_assemble(post, self.order, hdr, hdr_bits, flags,
                                   pair_bytes, counts_, states, dst, dst_off)


def decode_batch(src: np.ndarray, out_len: int, order: int, nbits=None):
    """The host half of one block's decode, for a payload of a block longer
    than 32 bytes: ({bufs, nbytes, states0, f2s, dtabs, ngroups, lr} numpy
    rows of the device chunks, or None where there are none; (the chunk
    flags, the single symbols of flag-2 chunks, and of the device chunks
    their lengths and stream lengths)). Every array is the caller's own:
    the rows are copied out of the prepare's pooled scratch. A row's
    `nbytes` are its stream's pairs, before its raw tail (0 where the
    stream is shorter than the tail). Raises as ans_decode_device does."""
    dtabs, f2s, states, bufs, buf_sz, flags, aux, lrs = \
        native.ans_dec_prepare(src, out_len, order, nbits)
    dev = np.nonzero(flags == 0)[0]
    if not len(dev):
        return None, (flags, aux, None, None)
    chunk = _chunk_size(order)
    sizes = np.minimum(chunk, out_len - dev * chunk)
    ngroups = ((sizes & ~3) // 4).astype(np.int32)
    nbytes = np.maximum(buf_sz[dev] - (sizes & 3), 0)   # the pairs, before the tail
    width = (256 if order == 1 else 1) << int(lrs[dev].max())
    return ({"bufs": bufs[dev, :max(int(buf_sz[dev].max()), 1)], "nbytes": nbytes,
             "states0": states[dev], "f2s": f2s[dev, :width],
             "dtabs": dtabs[dev], "ngroups": ngroups, "lr": lrs[dev]},
            (flags, aux, sizes, buf_sz[dev].copy()))


def host_buffer_rows(rb: dict, sizes: np.ndarray, buf_sz: np.ndarray) -> dict:
    """decode_batch's rows of one block as the host decoder reads them
    past a chunk's own stream (a hostile payload: renorm reads beyond its
    pairs, or a stream shorter than its tail). The host decodes every
    chunk of a block from one buffer, grown to 2 * the chunk's length
    (256 at least) + 64 bytes and never cleared: a chunk's stream, then 64
    zeros, then what earlier chunks left there (zeros where none wrote).
    It never reads past that buffer and never fails for it. Each row here
    is that buffer as its chunk finds it, with `nbytes` its whole width, so
    the decode reads the host's bytes and stops where the host stops."""
    widths = np.maximum(2 * sizes, 256) + 64
    bufs = np.zeros((len(sizes), int(widths.max())), np.uint8)
    held = np.zeros(bufs.shape[1], np.uint8)      # the host's buffer
    for r, sz in enumerate(buf_sz.tolist()):
        held[:sz] = rb["bufs"][r, :sz]
        held[sz:sz + 64] = 0
        bufs[r, :widths[r]] = held[:widths[r]]
    return dict(rb, bufs=bufs, nbytes=widths.astype(np.int32))


def _dec_prep(args):
    src, out_len, order, nbits = args
    if out_len <= 32:                    # raw small block
        if (8 * len(src) if nbits is None else nbits) < 8 * out_len:
            raise KanziError("ans decode: payload shorter than the block",
                             ERR_PROCESS_BLOCK)
        return src[:out_len].copy()
    return decode_batch(src, out_len, order, nbits)


def decode_rows(batch: dict, order: int, glen: int, device) -> tuple:
    """ONE chunk decode launch on `device` for a batch's stacked {bufs,
    nbytes, states0, f2s, dtabs, ngroups, lr} rows, with the host decoder's
    rule for a hostile state: (symbols (R, glen, 4), nread (R,)) as numpy
    arrays."""
    st = to_port_state(batch, device)
    syms, nread = ops_ans.decode_chunks(
        st["bufs"], st["nbytes"], st["states0"], st["f2s"], st["dtabs"],
        st["ngroups"], st["lr"], order, glen, host=True)
    return syms.cpu().numpy(), nread.cpu().numpy()


def ans_decode_many(payloads, out_lens, order: int, device, map_fn=map,
                    hook=None, nbits=None) -> list:
    """Decode the ANS payloads of a batch of blocks with ONE chunk decode
    launch on `device` for the device chunks of every block (the rows of
    all blocks together: the f2s width of the batch's widest logRange,
    groups and logRange per row), or through `hook`, a function with
    decode_rows' contract without the device (a mesh's sharded decode,
    parallel.mesh_decode_hooks). The host prepares and the per-block
    assembly run through `map_fn` (the Reader's pool.map). Returns per
    block its uint8 array, byte-identical to the host decoder for any
    logRange the chunk headers carry, or the exception that rejected it:
    NativeError from the host prepare, and for every block with device
    chunks the rejection (device_io.REJECTIONS) a hook raised. A launch or
    read-back that fails raises DeviceFault, as does an error of the card
    inside a hook. A block whose decode reads past a chunk's own stream,
    which only a hostile payload does, is decoded again in a second
    launch on the host decoder's buffer (host_buffer_rows), so that it
    decodes to the host's bytes as the host does, without an error.
    Nothing is retried on the host."""
    device = torch.device(device)
    preps = device_io.each(map_fn, _dec_prep, [
        (np.frombuffer(p, np.uint8) if not isinstance(p, np.ndarray) else p, n, order, b)
        for p, n, b in zip(payloads, out_lens, nbits or [None] * len(payloads))])
    rows, lo = [], {}
    nrows = 0
    for i, p in enumerate(preps):
        if isinstance(p, tuple) and p[0] is not None:
            rows.append(p[0])
            lo[i] = nrows
            nrows += len(p[0]["ngroups"])
    decoded, failed = {}, None           # block -> (bufs, symbols, nread)

    def run(block_rows, at):
        batch = device_io.stack(block_rows)
        glen = int(batch["ngroups"].max())
        with _kernels.card_errors("ans_decode"):
            syms, nread = (hook(batch, order, glen) if hook
                           else decode_rows(batch, order, glen, device))
        for (i, r0), rb in zip(at, block_rows):
            n = len(rb["ngroups"])
            decoded[i] = rb["bufs"], syms[r0:r0 + n], nread[r0:r0 + n]

    if rows:
        try:
            run(rows, list(lo.items()))
            # a block whose renorm reads or tail left a chunk's stream
            # decodes again on the host's buffer
            redo = [i for i in lo
                    if ((decoded[i][2] < 0)
                        | (decoded[i][2] + (preps[i][1][2] & 3) > preps[i][1][3])).any()]
            if redo:
                again = [host_buffer_rows(preps[i][0], *preps[i][1][2:]) for i in redo]
                at = np.cumsum([0] + [len(rb["ngroups"]) for rb in again[:-1]])
                run(again, list(zip(redo, at.tolist())))
        except device_io.REJECTIONS as e:
            failed = e
    chunk = _chunk_size(order)

    def finish(i):
        p = preps[i]
        if not isinstance(p, tuple):     # a raw small block, or its error
            if isinstance(p, Exception):
                raise p
            return p
        if failed is not None and i in lo:
            raise failed
        rb, (flags, aux, _, _) = p
        out_len = out_lens[i]
        out = np.empty(out_len, dtype=np.uint8)
        if rb is not None:
            bufs, syms, nr = decoded[i]
            if (nr < 0).any():           # not even on the host's buffer
                raise KanziError("ans decode: renorm reads left a chunk's stream",
                                 ERR_PROCESS_BLOCK)
            for r, c in enumerate(np.nonzero(flags == 0)[0]):
                start = int(c) * chunk
                size = min(chunk, out_len - start)
                g = int(rb["ngroups"][r])
                e4 = 4 * g
                if order == 0:
                    # group g -> block[4g..4g+3] = states 3, 2, 1, 0
                    out[start:start + e4] = syms[r, :g, ::-1].reshape(-1)
                else:
                    for j in range(4):
                        out[start + j * g:start + (j + 1) * g] = syms[r, :g, j]
                nf = int(nr[r])
                out[start + e4:start + size] = bufs[r, nf:nf + size - e4]
        for c in np.nonzero(flags == 2)[0]:
            start = int(c) * chunk
            out[start:start + min(chunk, out_len - start)] = aux[c]
        return out

    return device_io.each(map_fn, finish, range(len(preps)))


def ans_decode_device(payload, out_len: int, order: int, device, hook=None,
                      nbits=None) -> bytes:
    """Decode one ANS payload (its first `nbits` bits, all of it by
    default) with the device pipeline (a batch of one, through `hook` where
    given); a rejected payload raises as ans_decode_many says."""
    if out_len == 0:
        return b""
    return device_io.one(ans_decode_many([payload], [out_len], order, device,
                                         hook=hook, nbits=[nbits]))


def ans_encode_device(buf, order: int, device) -> tuple[bytes, int]:
    """Encode one block with the device pipeline, the Writer's own path:
    one engine dispatch and one collect. Returns (payload, bits)."""
    src = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if len(src) == 0:
        return b"", 0
    return device_io.encode_block(DeviceANSEngine(order, device), src, 1 << 18)
