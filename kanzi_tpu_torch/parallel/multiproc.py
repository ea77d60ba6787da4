"""Multi-process block compression — the process-level form of the
reference's P3 axis (worker pool over independent work units,
v2/app/BlockCompressor.go:543-618) and the single-node template for
multi-host scaling: each process owns a contiguous run of blocks, encodes
them independently (block statelessness contract, v2/Definitions.go:50-52),
and the parent splices the frames in block order — producing bytes
identical to a single-process run.

On a multi-core host this scales the byte-serial C++ work linearly; across
hosts the same structure applies with each host encoding its stripe and the
stripes concatenated in order (the header is written once by rank 0).

This is the host C++ path, as in kanzi_tpu: it takes no `device`, and its
Writers run with device=None. Blocks striped over CUDA cards are the mesh
(ROADMAP.md, section 1, item 3), not this module. The workers are spawned
processes that import the port and touch no CUDA state.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..kio import Writer


def _encode_span(args):
    """Worker: encode blocks [start:end) of the shared input. Returns a list
    of (payload_bytes, bit_length) in block order."""
    (shm_name, total_len, start, end, block_size, chain, etype,
     checksum_bits, ctx) = args
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        data = np.ndarray((total_len,), dtype=np.uint8, buffer=shm.buf)
        out = []
        scratch = None
        for off in range(start, end, block_size):
            block = data[off:min(off + block_size, total_len)]
            cap = 2 * len(block) + 65536
            if scratch is None or len(scratch) < cap:
                scratch = np.empty(cap, dtype=np.uint8)
            bits, _post, _flags, _cks = native.block_encode(
                np.ascontiguousarray(block), chain, etype, ctx,
                checksum_bits, bool(ctx.get("skipBlocks", False)), scratch)
            out.append((scratch[: (bits + 7) >> 3].tobytes(), bits))
        return out
    finally:
        shm.close()


def compress_multiproc(data, transform: str = "NONE", entropy: str = "NONE",
                       block_size: int = 4 * 1024 * 1024, procs: int = 2,
                       checksum: int = 0, ctx: dict | None = None) -> bytes:
    """Compress `data` with `procs` worker processes; output is byte-identical
    to the single-process Writer (asserted in tests)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import shared_memory

    if not native.available():
        raise RuntimeError("multi-process compression requires the native runtime")
    data = bytes(data)
    n = len(data)

    # the Writer does the header, frame splicing, and the end marker; the
    # workers feed it pre-encoded frames in block order
    w = Writer(None, transform=transform, entropy=entropy,
               block_size=block_size, checksum=checksum, file_size=n,
               ctx=dict(ctx) if ctx else None, device=None)
    w._write_header()

    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        w.close()
        return w.getvalue()
    procs = max(1, min(procs, nblocks))
    per = (nblocks + procs - 1) // procs  # blocks per worker, contiguous

    shm = shared_memory.SharedMemory(create=True, size=max(n, 1))
    try:
        np.ndarray((n,), dtype=np.uint8, buffer=shm.buf)[:] = \
            np.frombuffer(data, dtype=np.uint8)
        spans = []
        for p in range(procs):
            start = p * per * block_size
            end = min((p + 1) * per * block_size, n)
            if start >= n:
                break
            spans.append((shm.name, n, start, end, block_size,
                          w.transform_type, w.entropy_type, w.checksum_bits,
                          dict(w.ctx)))
        # spawn: fork in a multi-threaded parent (torch/thread pools) can
        # deadlock in the children; workers only need numpy + the native lib
        with ProcessPoolExecutor(max_workers=len(spans),
                                 mp_context=mp.get_context("spawn")) as pool:
            results = list(pool.map(_encode_span, spans))
        # ordered splice — the degenerate form of the reference's
        # processedBlockID protocol (each span is already in block order)
        for span_frames in results:
            for payload, bits in span_frames:
                w._append_frame(np.frombuffer(payload, dtype=np.uint8), bits)
        w._block_id = nblocks
    finally:
        shm.unlink()
        shm.close()
    w.close()
    return w.getvalue()


def _decode_span(args):
    """Worker: decode frames [i0:i1) of the shared stream. Frames are
    (bit_pos, block_id) pairs; returns the decoded bytes in block order."""
    (shm_name, total_len, frames, chain, etype, checksum_bits, block_size,
     ctx) = args
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        src = np.ndarray((total_len,), dtype=np.uint8, buffer=shm.buf)
        out = bytearray()
        dst = np.empty(block_size, dtype=np.uint8)
        for pos, _block_id in frames:
            n = native.block_decode(src, pos >> 3, pos & 7, chain, etype,
                                    dict(ctx), checksum_bits, block_size,
                                    dst, 0, block_size)
            out += dst[:n].tobytes()
        return bytes(out)
    finally:
        shm.close()


def decompress_multiproc(blob, procs: int = 2) -> bytes:
    """Decompress with `procs` worker processes: the parent parses the
    header and walks the frame lengths serially (no payload decode — the
    reference's serialized frame reads, v2/io/CompressedStream.go:1798-1856),
    then workers decode contiguous frame spans concurrently and the parent
    concatenates in block order. Byte-identical to single-process decode."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import shared_memory

    from ..kio import frame_table

    if not native.available():
        raise RuntimeError("multi-process decompression requires the native runtime")
    blob = bytes(blob)

    # header parse + serial frame walk (no payload decode), shared with
    # the multi-host decode striping
    frames, r = frame_table(blob)
    if not frames:
        return b""

    procs = max(1, min(procs, len(frames)))
    per = (len(frames) + procs - 1) // procs
    shm = shared_memory.SharedMemory(create=True, size=max(len(blob), 1))
    try:
        np.ndarray((len(blob),), dtype=np.uint8, buffer=shm.buf)[:] = \
            np.frombuffer(blob, dtype=np.uint8)
        spans = []
        for p in range(procs):
            chunk = frames[p * per:(p + 1) * per]
            if not chunk:
                break
            spans.append((shm.name, len(blob), chunk, r.transform_type,
                          r.entropy_type, r.checksum_bits, r.block_size,
                          dict(r.ctx)))
        with ProcessPoolExecutor(max_workers=len(spans),
                                 mp_context=mp.get_context("spawn")) as pool:
            results = list(pool.map(_decode_span, spans))
        return b"".join(results)
    finally:
        shm.unlink()
        shm.close()
