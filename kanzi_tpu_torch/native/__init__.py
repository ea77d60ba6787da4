"""ctypes bindings for the C++ host runtime (libkanzi_torch_native.so).

The library auto-builds on first import (g++ via make) and is cached under
native/build/. Set KANZI_TORCH_NO_NATIVE=1 to disable (pure-Python fallbacks
only cover a subset of codecs and are orders of magnitude slower).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

# Scratch buffers are reused across calls (grow-only, per thread): this host
# has very slow first-touch page faults, so fresh multi-MB allocations per
# block dominate runtime if not pooled.
_scratch = threading.local()


def _get_scratch(kind: str, size: int) -> np.ndarray:
    pool = getattr(_scratch, "pool", None)
    if pool is None:
        pool = _scratch.pool = {}
    buf = pool.get(kind)
    if buf is None or len(buf) < size:
        buf = np.empty(max(size, 1 << 16), dtype=np.uint8)
        buf[:] = 0  # touch pages once
        pool[kind] = buf
    return buf

_DIR = os.path.dirname(os.path.abspath(__file__))
# KANZI_TORCH_NATIVE_LIB overrides the path of the library to load
_LIB_PATH = os.environ.get("KANZI_TORCH_NATIVE_LIB") or \
    os.path.join(_DIR, "build", "libkanzi_torch_native.so")
_lock = threading.Lock()
_lib = None


class Ctx(ctypes.Structure):
    _fields_ = [
        ("bsVersion", ctypes.c_int32),
        ("blockSize", ctypes.c_int32),
        ("size", ctypes.c_int32),
        ("entropyType", ctypes.c_int32),
        ("dataType", ctypes.c_int32),
        ("lzVariant", ctypes.c_int32),
        ("sbrtMode", ctypes.c_int32),
        ("textCodecVariant", ctypes.c_int32),
        ("packOnlyDNA", ctypes.c_int32),
        ("extra", ctypes.c_int32),
        ("jobs", ctypes.c_int32),
        ("histo", ctypes.c_int32 * 256),
        ("hasHisto", ctypes.c_int32),
    ]


def _up_to_date() -> bool:
    if not os.path.exists(_LIB_PATH):
        return False
    lib_mtime = os.path.getmtime(_LIB_PATH)
    src = os.path.join(_DIR, "src")
    return all(os.path.getmtime(os.path.join(src, f)) < lib_mtime
               for f in os.listdir(src))


def _build() -> None:
    """Build the library once across processes: test runners import the
    package from several workers at once, so the make runs under an
    exclusive file lock in the build directory (the threading lock in
    get_lib only serialises threads of one process). The up-to-date check
    runs under the lock too: while make links, the half-written library
    already looks newer than its sources."""
    build_dir = os.path.join(_DIR, "build")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _up_to_date():
                return
            res = subprocess.run(["make", "-j", "-C", _DIR],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"native build failed:\n{res.stdout}\n{res.stderr}")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("KANZI_TORCH_NO_NATIVE"):
            raise RuntimeError("native library disabled by KANZI_TORCH_NO_NATIVE")
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.kz_entropy_encode.restype = ctypes.c_int64
        lib.kz_entropy_encode.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(Ctx)]
        lib.kz_entropy_decode.restype = ctypes.c_int64
        lib.kz_entropy_decode.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(Ctx)]
        lib.kz_transform_forward.restype = ctypes.c_int
        lib.kz_transform_forward.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(Ctx), ctypes.POINTER(ctypes.c_int32)]
        lib.kz_transform_inverse.restype = ctypes.c_int
        lib.kz_transform_inverse.argtypes = lib.kz_transform_forward.argtypes
        lib.kz_xxhash32.restype = ctypes.c_uint32
        lib.kz_xxhash32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
        lib.kz_xxhash64.restype = ctypes.c_uint64
        lib.kz_xxhash64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
        lib.kz_huffman_prepare.restype = ctypes.c_int
        lib.kz_huffman_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.kz_huffman_dec_prepare.restype = ctypes.c_int
        lib.kz_huffman_dec_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.kz_ans_prepare.restype = ctypes.c_int
        lib.kz_ans_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.kz_ans_dec_prepare.restype = ctypes.c_int
        lib.kz_ans_dec_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.kz_ans_assemble.restype = ctypes.c_int64
        lib.kz_ans_assemble.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.kz_block_encode.restype = ctypes.c_int64
        lib.kz_block_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(Ctx), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64)]
        lib.kz_block_decode.restype = ctypes.c_int64
        lib.kz_block_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.POINTER(Ctx), ctypes.c_int, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64]
        lib.kz_block_transform.restype = ctypes.c_int64
        lib.kz_block_transform.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(Ctx), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32)]
        lib.kz_huffman_assemble.restype = ctypes.c_int64
        lib.kz_huffman_assemble.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.kz_range_prepare.restype = ctypes.c_int
        lib.kz_range_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.kz_range_assemble.restype = ctypes.c_int64
        lib.kz_range_assemble.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.kz_range_dec_chunk.restype = ctypes.c_int64
        lib.kz_range_dec_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.kz_frame_append.restype = ctypes.c_int64
        lib.kz_frame_append.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.kz_stream_close.restype = ctypes.c_int64
        lib.kz_stream_close.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.kz_compress.restype = ctypes.c_int64
        lib.kz_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(Ctx), ctypes.c_void_p,
            ctypes.c_int64]
        lib.kz_decompress.restype = ctypes.c_int64
        lib.kz_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(Ctx), ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int32]
        lib.kz_stream_info.restype = ctypes.c_int64
        lib.kz_stream_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


def make_ctx(ctx: dict) -> Ctx:
    c = Ctx()
    c.bsVersion = int(ctx.get("bsVersion", 6))
    c.blockSize = int(ctx.get("blockSize", 4 * 1024 * 1024))
    c.size = int(ctx.get("size", 0))
    c.entropyType = 0
    ename = ctx.get("entropy")
    if ename:
        from .. import entropy as entropy_mod
        try:
            c.entropyType = entropy_mod.get_type(str(ename))
        except ValueError:
            pass
    c.dataType = int(ctx.get("dataType", 0))
    c.lzVariant = int(ctx.get("lz", 0))
    c.sbrtMode = int(ctx.get("sbrt", 0))
    c.textCodecVariant = int(ctx.get("textcodec", 1))
    c.packOnlyDNA = 1 if ctx.get("packOnlyDNA") else 0
    c.extra = 1 if ctx.get("extra") else 0
    c.jobs = int(ctx.get("jobs", 1))
    c.hasHisto = 0
    return c


def _as_buf(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.view(np.uint8))
    return np.frombuffer(data, dtype=np.uint8)


def entropy_encode(etype: int, data, ctx: dict) -> tuple[bytes, int]:
    """Returns (payload_bytes, exact_bit_length)."""
    lib = get_lib()
    src = _as_buf(data)
    n = len(src)
    cap = max(2 * n + 65536, 1 << 16)
    dst = _get_scratch("ee", cap)
    cap = len(dst)
    c = make_ctx(ctx)
    bits = lib.kz_entropy_encode(etype, src.ctypes.data, n, dst.ctypes.data,
                                 cap, ctypes.byref(c))
    if bits < 0:
        raise RuntimeError(f"native entropy encode failed (etype={etype}, err={bits})")
    return dst[: (bits + 7) // 8].tobytes(), int(bits)


def entropy_decode(etype: int, payload, out_len: int, ctx: dict) -> bytes:
    lib = get_lib()
    src = _as_buf(payload)
    dst = _get_scratch("ed", max(out_len, 1))
    c = make_ctx(ctx)
    res = lib.kz_entropy_decode(etype, src.ctypes.data, len(src),
                                dst.ctypes.data, out_len, ctypes.byref(c))
    if res < 0:
        raise RuntimeError(f"native entropy decode failed (etype={etype}, err={res})")
    return dst[:out_len].tobytes()


class NativeSkip(Exception):
    pass


def transform_forward(ttype: int, data, ctx: dict, max_encoded_len: int) -> tuple[bytes, dict]:
    lib = get_lib()
    src = _as_buf(data)
    cap = max(max_encoded_len, len(src), 1024)
    dst = _get_scratch("tf", cap)
    cap = len(dst)
    out_len = ctypes.c_int32(0)
    c = make_ctx(ctx)
    res = lib.kz_transform_forward(ttype, src.ctypes.data, len(src),
                                   dst.ctypes.data, cap, ctypes.byref(c),
                                   ctypes.byref(out_len))
    # the data type a transform detected holds for the rest of the chain
    # even when it vetoes itself, as in the one-call block encode (and the
    # reference's shared ctx map): a vetoing alias codec's detection keeps
    # LZ off small-alphabet data
    ctx["dataType"] = int(c.dataType)
    if res == 1:
        raise NativeSkip()
    if res != 0:
        raise RuntimeError(f"native transform forward failed (ttype={ttype}, err={res})")
    return dst[: out_len.value].tobytes(), ctx


def transform_inverse(ttype: int, data, ctx: dict, cap: int) -> bytes:
    lib = get_lib()
    src = _as_buf(data)
    cap = max(cap, len(src), 1024)
    dst = _get_scratch("ti", cap)
    cap = len(dst)
    out_len = ctypes.c_int32(0)
    c = make_ctx(ctx)
    res = lib.kz_transform_inverse(ttype, src.ctypes.data, len(src),
                                   dst.ctypes.data, cap, ctypes.byref(c),
                                   ctypes.byref(out_len))
    if res != 0:
        raise RuntimeError(f"native transform inverse failed (ttype={ttype}, err={res})")
    return dst[: out_len.value].tobytes()


def xxhash32_native(data, seed: int) -> int:
    lib = get_lib()
    buf = _as_buf(data)
    return int(lib.kz_xxhash32(buf.ctypes.data, len(buf), seed & 0xFFFFFFFF))


def xxhash64_native(data, seed: int) -> int:
    lib = get_lib()
    buf = _as_buf(data)
    return int(lib.kz_xxhash64(buf.ctypes.data, len(buf), seed & 0xFFFFFFFFFFFFFFFF))


def block_encode(src: np.ndarray, chain: int, etype: int, ctx: dict,
                 checksum_bits: int, skip_blocks: bool,
                 dst: np.ndarray) -> tuple[int, int, int, int]:
    """One-shot block payload encode into `dst` (pooled caller buffer).

    Returns (payload_bits, post_transform_len, skip_flags, checksum).
    Mirrors encodingTask.encode (reference: v2/io/CompressedStream.go:729-977)
    entirely in C++ — one FFI call per block, no Python-side byte handling.
    """
    lib = get_lib()
    c = make_ctx(ctx)
    post_len = ctypes.c_int32(0)
    skip_flags = ctypes.c_int32(0)
    checksum = ctypes.c_uint64(0)
    bits = lib.kz_block_encode(
        src.ctypes.data, len(src), chain, etype, ctypes.byref(c),
        checksum_bits, 1 if skip_blocks else 0, dst.ctypes.data, len(dst),
        ctypes.byref(post_len), ctypes.byref(skip_flags), ctypes.byref(checksum))
    if bits < 0:
        raise RuntimeError(f"native block encode failed (err={bits})")
    return int(bits), int(post_len.value), int(skip_flags.value), int(checksum.value)


def block_decode(src: np.ndarray, byte_off: int, bit_off: int, chain: int,
                 etype: int, ctx: dict, checksum_bits: int, block_size: int,
                 dst: np.ndarray, dst_off: int, dst_cap: int) -> int:
    """One-shot block frame decode into dst[dst_off:dst_off+dst_cap].

    Returns the decoded length. Mirrors decodingTask.decode
    (reference: v2/io/CompressedStream.go:1763-2012)."""
    lib = get_lib()
    c = make_ctx(ctx)
    res = lib.kz_block_decode(
        src.ctypes.data + byte_off, len(src) - byte_off, bit_off, chain,
        etype, ctypes.byref(c), checksum_bits, block_size,
        dst.ctypes.data + dst_off, dst_cap)
    if res == -7:
        raise ChecksumMismatch()
    if res < 0:
        raise RuntimeError(f"native block decode failed (err={res})")
    return int(res)


class ChecksumMismatch(Exception):
    pass


def block_transform(src: np.ndarray, chain: int, etype: int, ctx: dict,
                    checksum_bits: int, skip_blocks: bool,
                    dst: np.ndarray):
    """Transform stage only (entropy runs elsewhere, e.g. on the GPU).

    Returns (post_len, mode, extra_skip, skip_flags, checksum, copy_mode)."""
    lib = get_lib()
    c = make_ctx(ctx)
    mode = ctypes.c_int32(0)
    extra = ctypes.c_int32(0)
    flags = ctypes.c_int32(0)
    cks = ctypes.c_uint64(0)
    copy = ctypes.c_int32(0)
    post = lib.kz_block_transform(
        src.ctypes.data, len(src), chain, etype, ctypes.byref(c),
        checksum_bits, 1 if skip_blocks else 0, dst.ctypes.data, len(dst),
        ctypes.byref(mode), ctypes.byref(extra), ctypes.byref(flags),
        ctypes.byref(cks), ctypes.byref(copy))
    if post < 0:
        raise RuntimeError(f"native block transform failed (err={post})")
    return (int(post), int(mode.value), int(extra.value), int(flags.value),
            int(cks.value), int(copy.value))


def huffman_assemble(block: np.ndarray, hdr: np.ndarray, hdr_bits: np.ndarray,
                     flags: np.ndarray, lane_bytes: np.ndarray,
                     lane_bits: np.ndarray, dst: np.ndarray,
                     dst_off: int = 0) -> int:
    """Splice device-packed Huffman lanes into the final entropy payload
    (byte-identical to the host encoder). Returns the payload bit length."""
    lib = get_lib()
    bits = lib.kz_huffman_assemble(
        block.ctypes.data, len(block), hdr.ctypes.data, hdr.shape[1],
        hdr_bits.ctypes.data, flags.ctypes.data,
        lane_bytes.ctypes.data, lane_bytes.shape[1] if lane_bytes.size else 0,
        lane_bits.ctypes.data, dst.ctypes.data + dst_off, len(dst) - dst_off)
    if bits < 0:
        raise RuntimeError(f"huffman assemble failed (err={bits})")
    return int(bits)


HUF_LANE_STRIDE = 6160   # > FRAG*12/8 + refill slack
HUF_AUX_STRIDE = 32


def huffman_dec_prepare(payload, out_len: int):
    """Parse a Huffman entropy payload into device-decodable pieces.

    Returns (dtables (C,4096) uint16, lanes (4*Cn, stride) uint8
    zero-guarded rows for flag==0 chunks, flags (C,) uint8,
    aux (C,32) uint8)."""
    lib = get_lib()
    src = _as_buf(payload)
    nchunks = max((out_len + 16383) // 16384, 1)
    # pooled np.empty scratch (first-touch page faults are slow on some hosts); the
    # C++ side zeroes the refill slack past each lane payload, and every
    # other buffer is fully overwritten
    dtables = _get_scratch("hdp_t", nchunks * 4096 * 2)[
        : nchunks * 4096 * 2].view(np.uint16).reshape(nchunks, 4096)
    lanes = _get_scratch("hdp_l", 4 * nchunks * HUF_LANE_STRIDE)[
        : 4 * nchunks * HUF_LANE_STRIDE].reshape(4 * nchunks, HUF_LANE_STRIDE)
    lane_bits = np.empty(4 * nchunks, dtype=np.int32)
    flags = np.empty(nchunks, dtype=np.uint8)
    aux = np.zeros((nchunks, HUF_AUX_STRIDE), dtype=np.uint8)
    c = lib.kz_huffman_dec_prepare(src.ctypes.data, len(src), out_len,
                                   dtables.ctypes.data, lanes.ctypes.data,
                                   HUF_LANE_STRIDE, lane_bits.ctypes.data,
                                   flags.ctypes.data, aux.ctypes.data,
                                   HUF_AUX_STRIDE)
    if c < 0:
        raise RuntimeError(f"huffman decode prepare failed (err={c})")
    nlanes = 4 * int((flags[:c] == 0).sum())
    return dtables[:c], lanes[:nlanes], flags[:c], aux[:c]


ANS0_CHUNK = 16384
ANS1_CHUNK = 16384 << 8
ANS_HDR_STRIDE = {0: 1024, 1: 131072}


class ShortANS1Chunk(RuntimeError):
    """An order-1 chunk of 2 or 3 bytes, which the format cannot encode
    (the reference indexes before the chunk; the host encoder raises)."""


def ans_prepare(data, order: int):
    """Per-chunk rANS tables + encoded headers for the device pipeline.

    Returns (tables (C, 5, dim*256) int32 [xMax, bias, cmplFreq, invShift,
    invFreq planes], hdr (C, stride) uint8, hdr_bits (C,) int32,
    flags (C,) uint8). Caller guarantees len(data) > 32. Raises
    ShortANS1Chunk for an order-1 chunk of 2 or 3 bytes."""
    lib = get_lib()
    src = _as_buf(data)
    n = len(src)
    chunk = ANS1_CHUNK if order == 1 else ANS0_CHUNK
    stride = ANS_HDR_STRIDE[order]
    dim = 256 if order == 1 else 1
    nchunks = max((n + chunk - 1) // chunk, 1)
    tables = np.empty((nchunks, 5, dim * 256), dtype=np.int32)
    hdr = np.empty((nchunks, stride), dtype=np.uint8)
    hdr_bits = np.empty(nchunks, dtype=np.int32)
    flags = np.empty(nchunks, dtype=np.uint8)
    c = lib.kz_ans_prepare(src.ctypes.data, n, order, tables.ctypes.data,
                           hdr.ctypes.data, stride, hdr_bits.ctypes.data,
                           flags.ctypes.data)
    if c == -2:
        raise ShortANS1Chunk("invalid ANS1 chunk size")
    if c < 0:
        raise RuntimeError(f"ans prepare failed (err={c})")
    return tables[:c], hdr[:c], hdr_bits[:c], flags[:c]


def ans_dec_prepare(payload, out_len: int, order: int):
    """Parse an ANS entropy payload into device-decodable pieces.

    Returns (dtabs (C,2,dim*256) int32 [freq, cumFreq], f2s (C, dim*2^16)
    uint8 [chunk c's map fills the first dim*2^lrs[c] bytes of its row],
    states (C,4) int32, bufs (C, stride) uint8 zero-guarded renorm
    streams, buf_sz (C,) int32 bytes of each stream [pairs and raw tail],
    flags (C,) uint8, aux (C,) uint8, lrs (C,) int32 logRange per chunk).
    Views into pooled scratch: the next call overwrites them."""
    lib = get_lib()
    src = _as_buf(payload)
    chunk = ANS1_CHUNK if order == 1 else ANS0_CHUNK
    dim = 256 if order == 1 else 1
    nchunks = max((out_len + chunk - 1) // chunk, 1)
    buf_stride = min(2 * chunk, 2 * out_len if out_len else 256) + 256
    f2s_stride = dim << 16  # room for the largest logRange the format has
    # pooled scratch: the C++ side writes every byte a decode reads (bufs
    # gets a 64-byte zero guard; an f2s row past a chunk's dim << lr is never
    # read); first-touch page faults are slow on some hosts
    dtabs = _get_scratch("adp_t", nchunks * 2 * dim * 256 * 4)[
        : nchunks * 2 * dim * 256 * 4].view(np.int32).reshape(nchunks, 2, dim * 256)
    f2s = _get_scratch("adp_f", nchunks * f2s_stride)[
        : nchunks * f2s_stride].reshape(nchunks, f2s_stride)
    states = np.empty((nchunks, 4), dtype=np.int32)
    bufs = _get_scratch("adp_b", nchunks * buf_stride)[
        : nchunks * buf_stride].reshape(nchunks, buf_stride)
    buf_sz = np.empty(nchunks, dtype=np.int32)
    flags = np.empty(nchunks, dtype=np.uint8)
    aux = np.empty(nchunks, dtype=np.uint8)
    lrs = np.empty(nchunks, dtype=np.int32)
    c = lib.kz_ans_dec_prepare(src.ctypes.data, len(src), out_len, order,
                               dtabs.ctypes.data, f2s.ctypes.data, f2s_stride,
                               states.ctypes.data, bufs.ctypes.data,
                               buf_stride, buf_sz.ctypes.data,
                               flags.ctypes.data, aux.ctypes.data,
                               lrs.ctypes.data)
    if c < 0:
        raise RuntimeError(f"ans decode prepare failed (err={c})")
    return (dtabs[:c], f2s[:c], states[:c], bufs[:c], buf_sz[:c], flags[:c],
            aux[:c], lrs[:c])


def ans_assemble(block: np.ndarray, order: int, hdr: np.ndarray,
                 hdr_bits: np.ndarray, flags: np.ndarray,
                 pair_bytes: np.ndarray, pair_counts: np.ndarray,
                 states: np.ndarray, dst: np.ndarray, dst_off: int = 0) -> int:
    """Splice device-encoded rANS chunks into the final entropy payload
    (byte-identical to the host encoder). Returns the payload bit length."""
    lib = get_lib()
    bits = lib.kz_ans_assemble(
        block.ctypes.data, len(block), order, hdr.ctypes.data, hdr.shape[1],
        hdr_bits.ctypes.data, flags.ctypes.data,
        pair_bytes.ctypes.data, pair_bytes.shape[1] if pair_bytes.size else 0,
        pair_counts.ctypes.data, states.ctypes.data,
        dst.ctypes.data + dst_off, len(dst) - dst_off)
    if bits < 0:
        raise RuntimeError(f"ans assemble failed (err={bits})")
    return int(bits)


def frame_append(stream: np.ndarray, bitpos: int, payload: np.ndarray,
                 bits: int) -> int:
    """Append one frame (length prefix + payload bits) at `bitpos`;
    returns the new bit position."""
    lib = get_lib()
    res = lib.kz_frame_append(stream.ctypes.data, len(stream), bitpos,
                              payload.ctypes.data, bits)
    if res < 0:
        raise RuntimeError("frame append overflow")
    return int(res)


def stream_close(stream: np.ndarray, bitpos: int) -> int:
    """Write the end-of-stream marker, pad, return total byte length."""
    lib = get_lib()
    res = lib.kz_stream_close(stream.ctypes.data, len(stream), bitpos)
    if res < 0:
        raise RuntimeError("stream close overflow")
    return int(res)


def c_compress(data, block_size: int, chain: int, etype: int, ctx: dict,
               checksum_bits: int = 0, headerless: bool = False,
               skip_blocks: bool = False, orig_size: int | None = None) -> bytes:
    """Whole-stream one-shot compress through the standalone C API
    (kz_compress). Byte-identical to the Python Writer for the same
    parameters; exists so C/C++ consumers have a complete container
    entry point (docs/C_API.md) and so tests can pin that identity."""
    lib = get_lib()
    src = _as_buf(data)
    # Optimistic estimate first; err=-10 means the stream outgrew it (tiny
    # blocks can expand several-fold: per-block entropy headers dominate),
    # so retry once at the provable worst case — each block payload fits the
    # encoder's own 2*bs+64KiB scratch, plus <=8 frame-overhead bytes.
    cap = len(src) + (len(src) >> 1) + 4 * block_size + (1 << 16)
    nblocks = max(1, -(-len(src) // block_size))
    worst = 64 + nblocks * (2 * block_size + (1 << 16) + 8)
    c = make_ctx(ctx)
    while True:
        dst = _get_scratch("cc", cap)
        res = lib.kz_compress(
            src.ctypes.data, len(src), block_size, chain, etype,
            checksum_bits, 1 if headerless else 0, 1 if skip_blocks else 0,
            len(src) if orig_size is None else orig_size,
            ctypes.byref(c), dst.ctypes.data, len(dst))
        if res == -10 and cap < worst:
            cap = worst
            continue
        if res < 0:
            raise RuntimeError(f"kz_compress failed (err={res})")
        return dst[:res].tobytes()


def c_decompress(blob, out_cap: int, ctx: dict | None = None,
                 headerless: bool = False, chain: int = 0, etype: int = 0,
                 checksum_bits: int = 0, block_size: int = 0) -> bytes:
    """Whole-stream one-shot decompress through the standalone C API
    (kz_decompress). v6 headers only; legacy streams go through the Python
    Reader."""
    lib = get_lib()
    src = _as_buf(blob)
    dst = _get_scratch("cd", max(out_cap, 1))
    c = make_ctx(ctx or {"bsVersion": 6})
    res = lib.kz_decompress(
        src.ctypes.data, len(src), dst.ctypes.data, len(dst),
        ctypes.byref(c), 1 if headerless else 0, chain, etype,
        checksum_bits, block_size)
    if res == -7:
        raise ChecksumMismatch()
    if res < 0:
        raise RuntimeError(f"kz_decompress failed (err={res})")
    return dst[:res].tobytes()


def c_stream_info(blob) -> dict:
    """Parse a v6 stream header via kz_stream_info."""
    lib = get_lib()
    src = _as_buf(blob)
    ckb = ctypes.c_int32(0)
    et = ctypes.c_int32(0)
    ch = ctypes.c_uint64(0)
    bs = ctypes.c_int32(0)
    osz = ctypes.c_int64(-1)
    res = lib.kz_stream_info(src.ctypes.data, len(src), ctypes.byref(ckb),
                             ctypes.byref(et), ctypes.byref(ch),
                             ctypes.byref(bs), ctypes.byref(osz))
    if res < 0:
        raise RuntimeError(f"kz_stream_info failed (err={res})")
    return {"header_bits": int(res), "checksum_bits": int(ckb.value),
            "entropy_type": int(et.value), "transform_chain": int(ch.value),
            "block_size": int(bs.value),
            "orig_size": None if osz.value < 0 else int(osz.value)}


HDR_STRIDE = 1024


def huffman_prepare(data):
    """Per-chunk Huffman tables + encoded headers for the device pipeline.

    Returns (tables (C,256) uint16, hdr (C, HDR_STRIDE) uint8,
    hdr_bits (C,) int32, flags (C,) uint8)."""
    lib = get_lib()
    src = _as_buf(data)
    n = len(src)
    nchunks = max((n + 16383) // 16384, 1)
    tables = np.zeros((nchunks, 256), dtype=np.uint16)
    hdr = np.zeros((nchunks, HDR_STRIDE), dtype=np.uint8)
    hdr_bits = np.zeros(nchunks, dtype=np.int32)
    flags = np.zeros(nchunks, dtype=np.uint8)
    c = lib.kz_huffman_prepare(src.ctypes.data, n, tables.ctypes.data,
                               hdr.ctypes.data, HDR_STRIDE,
                               hdr_bits.ctypes.data, flags.ctypes.data)
    if c < 0:
        raise RuntimeError("huffman prepare failed")
    return tables[:c], hdr[:c], hdr_bits[:c], flags[:c]


RANGE_CHUNK = 1 << 15
RANGE_HDR_STRIDE = 1024  # alphabet + 3-bit lr + <=256 12-bit freqs < 1 KiB


def range_prepare(data):
    """Per-chunk range-codec tables + encoded headers for the device
    pipeline (kz_range_prepare).

    Returns (tables (C,2,256) int32 [cumFreq, freq planes], hdr (C, stride)
    uint8, hdr_bits (C,) int32, flags (C,) uint8 [0 device / 2 header-only],
    shifts (C,) int32 per-chunk logRange)."""
    lib = get_lib()
    src = _as_buf(data)
    n = len(src)
    nchunks = max((n + RANGE_CHUNK - 1) // RANGE_CHUNK, 1)
    tables = np.empty((nchunks, 2, 256), dtype=np.int32)
    hdr = np.empty((nchunks, RANGE_HDR_STRIDE), dtype=np.uint8)
    hdr_bits = np.empty(nchunks, dtype=np.int32)
    flags = np.empty(nchunks, dtype=np.uint8)
    shifts = np.empty(nchunks, dtype=np.int32)
    c = lib.kz_range_prepare(src.ctypes.data, n, tables.ctypes.data,
                             hdr.ctypes.data, RANGE_HDR_STRIDE,
                             hdr_bits.ctypes.data, flags.ctypes.data,
                             shifts.ctypes.data)
    if c < 0:
        raise RuntimeError(f"range prepare failed (err={c})")
    return tables[:c], hdr[:c], hdr_bits[:c], flags[:c], shifts[:c]


def range_assemble(block: np.ndarray, hdr: np.ndarray, hdr_bits: np.ndarray,
                   flags: np.ndarray, words: np.ndarray, nwords: np.ndarray,
                   lows: np.ndarray, dst: np.ndarray, dst_off: int = 0) -> int:
    """Splice device-encoded range chunks (28-bit renorm words + final
    60-bit low per chunk) into the final entropy payload, byte-identical to
    the host encoder. Returns the payload bit length."""
    lib = get_lib()
    bits = lib.kz_range_assemble(
        block.ctypes.data, len(block), hdr.ctypes.data, hdr.shape[1],
        hdr_bits.ctypes.data, flags.ctypes.data,
        words.ctypes.data, words.shape[1] if words.size else 0,
        nwords.ctypes.data, lows.ctypes.data,
        dst.ctypes.data + dst_off, len(dst) - dst_off)
    if bits < 0:
        raise RuntimeError(f"range assemble failed (err={bits})")
    return int(bits)


def range_dec_chunk(payload: np.ndarray, bit_pos: int, buf_cap: int):
    """Parse ONE range chunk header at bit_pos and byte-align the rest of
    the payload for the device scan (kz_range_dec_chunk).

    Returns (new_bit_pos just past the header, tables (2,256) int32,
    f2s (4096,) uint8, shift, flag, aux_sym, buf (buf_cap,) uint8)."""
    lib = get_lib()
    src = _as_buf(payload)
    tables = np.empty((2, 256), dtype=np.int32)
    f2s = np.empty(4096, dtype=np.uint8)
    meta = np.empty(3, dtype=np.int32)
    buf = np.empty(buf_cap, dtype=np.uint8)
    pos = lib.kz_range_dec_chunk(src.ctypes.data, len(src), bit_pos,
                                 tables.ctypes.data, f2s.ctypes.data,
                                 meta.ctypes.data, buf.ctypes.data, buf_cap)
    if pos < 0:
        raise RuntimeError(f"range decode prepare failed (err={pos})")
    return int(pos), tables, f2s, int(meta[0]), int(meta[1]), int(meta[2]), buf
