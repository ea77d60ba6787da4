"""KANZ v6 stream container: file header, per-block frames, block scheduler.

Format (reference: v2/io/CompressedStream.go):

File header (write: :429-519):
    32b magic "KANZ" | 4b version(6) | 2b checksum size (0/1/2 -> none/32/64)
    | 5b entropy type | 48b transform chain | 28b blockSize>>4 | 2b szMask
    | szMask*16b original size | 15b padding | 24b header checksum

Per-block frame (:951-976): 5b (lw-3), lw bits payload bit-length, payload
bits. End-of-stream marker = zero-length block (5b=0, 3b=0).

Block payload (:718-728): mode byte (0x80=copy; bits 5-6 = byte-width-1 of
post-transform length; 0x10 = >4 transforms -> separate 8-bit skip-flags
byte, else low nibble = skipFlags>>4); 8*dataSize bits post-transform
length; optional 32/64-bit XXHash of the original block; entropy payload.

Blocks are independent by design, which this framework exploits as the
primary data-parallel axis: the device entropy engine packs the lanes of a
whole batch of blocks in one launch and the frames splice here in block
order — the device-side analogue of the reference's lock-free ordered append.

`device` selects the entropy engine: a CUDA device runs the HUFFMAN, ANS0,
ANS1 and RANGE stages through the port's kernels, "cpu" through their plain
PyTorch versions, and None runs the host C++ engine throughout. The other
entropy types run on the host C++ engine on every path.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import _kernels
from .. import entropy as entropy_mod
from .. import transforms as transforms_mod
from .. import internal
from .. import native
from ..bitstream import BitReader, BitWriter
from ..entropy.device_io import each as _each
from ..core import (BITSTREAM_TYPE, BITSTREAM_FORMAT_VERSION, COPY_BLOCK_MASK,
                    TRANSFORMS_MASK, MIN_BITSTREAM_BLOCK_SIZE,
                    MAX_BITSTREAM_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                    MAX_CONCURRENCY, KanziError, Event, EventType,
                    HashType, HeaderInfo,
                    ERR_INVALID_PARAM, ERR_BLOCK_SIZE, ERR_INVALID_FILE,
                    ERR_INVALID_CODEC, ERR_STREAM_VERSION, ERR_CRC_CHECK,
                    ERR_PROCESS_BLOCK, ERR_WRITE_FILE, ERR_READ_FILE)
from ..xxhash import xxhash32, xxhash64

_HEADER_HASH = 0x1E35A7BD
_M32 = 0xFFFFFFFF


def _notify(listeners, evt: Event) -> None:
    for bl in listeners:
        try:
            bl.process_event(evt)
        except Exception:
            pass  # listener failures never affect the stream (ref :979-991)


def _block_checksum(data: np.ndarray, checksum_bits: int) -> int:
    if checksum_bits == 0:
        return 0
    try:
        from .. import native
        if checksum_bits == 32:
            return native.xxhash32_native(data, BITSTREAM_TYPE)
        return native.xxhash64_native(data, BITSTREAM_TYPE)
    except Exception:
        pass
    if checksum_bits == 32:
        return xxhash32(data.tobytes(), BITSTREAM_TYPE)
    return xxhash64(data.tobytes(), BITSTREAM_TYPE)


def compress_block_payload(data: np.ndarray, transform_type: int,
                           entropy_type: int, ctx: dict,
                           checksum_bits: int = 0, block_id: int = 0,
                           listeners=()) -> tuple[bytes, int]:
    """Encode one block into its frame payload.

    Returns (payload_bytes, exact_bit_length). Mirrors encodingTask.encode
    (reference: v2/io/CompressedStream.go:729-977).
    """
    block_length = len(data)
    mode = 0
    checksum = _block_checksum(data, checksum_bits) if checksum_bits else 0
    hash_type = HashType(checksum_bits // 32)
    if listeners:
        _notify(listeners, Event(EventType.BEFORE_TRANSFORM, block_id,
                                 block_length, checksum, hash_type, time.time()))

    t_type, e_type = transform_type, entropy_type
    if block_length <= SMALL_BLOCK_SIZE:
        t_type, e_type = transforms_mod.NONE_TYPE, entropy_mod.NONE_TYPE
        mode |= COPY_BLOCK_MASK
    elif ctx.get("skipBlocks", False):
        skip = False
        if block_length >= 8:
            skip = internal.is_data_compressed(internal.get_magic_type(data[:8]))
        if not skip:
            histo = internal.compute_histogram_order0(data)
            skip = internal.first_order_entropy_1024(block_length, histo) >= \
                entropy_mod.INCOMPRESSIBLE_THRESHOLD
        if skip:
            t_type, e_type = transforms_mod.NONE_TYPE, entropy_mod.NONE_TYPE
            mode |= COPY_BLOCK_MASK

    ctx = dict(ctx)
    ctx["size"] = block_length
    seq = transforms_mod.new_sequence(ctx, t_type)

    magic = internal.get_magic_type(data[:8]) if block_length >= 4 else internal.NO_MAGIC
    if internal.is_data_compressed(magic):
        ctx["dataType"] = internal.DataType.BIN
    elif internal.is_data_multimedia(magic):
        ctx["dataType"] = internal.DataType.MULTIMEDIA
    elif internal.is_data_executable(magic):
        ctx["dataType"] = internal.DataType.EXE

    out, skip_flags = seq.forward(data)
    post_len = len(out)
    ctx["size"] = post_len
    if listeners:
        _notify(listeners, Event(EventType.AFTER_TRANSFORM, block_id,
                                 post_len, checksum, hash_type, time.time()))

    data_size = 1
    if post_len >= 256:
        data_size = (internal.log2_no_check(post_len) >> 3) + 1
        if data_size > 4:
            raise KanziError("Invalid block data length", ERR_WRITE_FILE)
    mode |= ((data_size - 1) & 0x03) << 5

    hdr = BitWriter()
    if (mode & COPY_BLOCK_MASK) != 0 or len(seq) <= 4:
        mode |= skip_flags >> 4
        hdr.write_bits(mode, 8)
    else:
        mode |= TRANSFORMS_MASK
        hdr.write_bits(mode, 8)
        hdr.write_bits(skip_flags, 8)
    hdr.write_bits(post_len, 8 * data_size)
    if checksum_bits:
        hdr.write_bits(checksum, checksum_bits)
    hdr_bytes = hdr.getvalue()  # all header fields are whole bytes

    if listeners:
        _notify(listeners, Event(EventType.BEFORE_ENTROPY, block_id,
                                 post_len, checksum, hash_type, time.time()))
    payload, payload_bits = entropy_mod.encode(e_type, out, ctx)
    if listeners:
        _notify(listeners, Event(EventType.AFTER_ENTROPY, block_id,
                                 (payload_bits + 7) >> 3, checksum, hash_type,
                                 time.time()))
    return hdr_bytes + payload, len(hdr_bytes) * 8 + payload_bits


def _parse_block_header(payload: bytes, transform_type: int, entropy_type: int,
                        block_size: int, checksum_bits: int):
    """The header fields of one block frame payload: (transform type,
    entropy type, skip flags, pre-transform length, byte offset of the
    entropy payload, checksum). A copy-mode block has transform and
    entropy NONE. Raises ERR_BLOCK_SIZE for a length outside the block's
    bounds."""
    br = BitReader(payload)
    mode = br.read_bits(8)
    skip_flags = 0
    t_type, e_type = transform_type, entropy_type

    if mode & COPY_BLOCK_MASK:
        t_type, e_type = transforms_mod.NONE_TYPE, entropy_mod.NONE_TYPE
    elif mode & TRANSFORMS_MASK:
        skip_flags = br.read_bits(8)
    else:
        skip_flags = ((mode << 4) | 0x0F) & 0xFF

    data_size = 1 + ((mode >> 5) & 0x03)
    pre_len = br.read_bits(8 * data_size)
    max_len = min(max(block_size + block_size // 2, 2048), MAX_BITSTREAM_BLOCK_SIZE)
    if pre_len == 0 or pre_len > max_len:
        raise KanziError(f"Invalid compressed block size: {pre_len}", ERR_BLOCK_SIZE)

    checksum1 = br.read_bits(checksum_bits) if checksum_bits else 0
    # header fields are whole bytes
    return t_type, e_type, skip_flags, pre_len, br.read >> 3, checksum1


def _inverse_block(buf, t_type: int, skip_flags: int, ctx: dict,
                   pre_len: int) -> bytes:
    """The inverse transform of one block's entropy output."""
    ctx = dict(ctx)
    ctx["size"] = pre_len
    seq = transforms_mod.new_sequence(ctx, t_type)
    seq.set_skip_flags(skip_flags)
    out = seq.inverse(np.frombuffer(buf, dtype=np.uint8))
    return out.tobytes() if isinstance(out, np.ndarray) else bytes(out)


def _verify_checksum(result: bytes, checksum_bits: int, checksum1: int) -> bytes:
    """`result`, unless its checksum differs from the frame's
    (ERR_CRC_CHECK)."""
    if checksum_bits:
        checksum2 = _block_checksum(np.frombuffer(result, dtype=np.uint8), checksum_bits)
        if checksum2 != checksum1:
            raise KanziError(
                f"Corrupted bitstream: expected checksum {checksum1:x}, found {checksum2:x}",
                ERR_CRC_CHECK)
    return result


def _block_error(block_id: int, e: Exception) -> KanziError:
    """A block's decode failure as the Reader raises it, naming the block:
    a KanziError keeps its code, a payload the decoders reject
    (ValueError, RuntimeError) is ERR_PROCESS_BLOCK."""
    if isinstance(e, KanziError):
        err = KanziError(f"Block {block_id}: {e.msg}", e.code)
    else:
        err = KanziError(f"Block {block_id}: {e}", ERR_PROCESS_BLOCK)
    err.__cause__ = e
    return err


def decompress_block_payload(payload: bytes, transform_type: int,
                             entropy_type: int, ctx: dict,
                             block_size: int, checksum_bits: int = 0,
                             block_id: int = 0, listeners=()) -> bytes:
    """Decode one block frame payload back to its original bytes.

    Mirrors decodingTask.decode (reference: v2/io/CompressedStream.go:1763-2012).
    """
    t_type, e_type, skip_flags, pre_len, offset, checksum1 = _parse_block_header(
        payload, transform_type, entropy_type, block_size, checksum_bits)
    hash_type = HashType(checksum_bits // 32)
    if listeners:
        _notify(listeners, Event(EventType.BEFORE_ENTROPY, block_id,
                                 len(payload), checksum1, hash_type, time.time()))
    ctx = dict(ctx)
    ctx["size"] = pre_len
    buf = entropy_mod.decode(e_type, payload[offset:], pre_len, ctx)
    if listeners:
        _notify(listeners, Event(EventType.AFTER_ENTROPY, block_id,
                                 pre_len, checksum1, hash_type, time.time()))
        _notify(listeners, Event(EventType.BEFORE_TRANSFORM, block_id,
                                 pre_len, checksum1, hash_type, time.time()))
    result = _inverse_block(buf, t_type, skip_flags, ctx, pre_len)
    if listeners:
        _notify(listeners, Event(EventType.AFTER_TRANSFORM, block_id,
                                 len(result), checksum1, hash_type, time.time()))
    return _verify_checksum(result, checksum_bits, checksum1)


class Writer:
    """Compressing writer producing a KANZ v6 stream.

    Library surface mirrors kio.NewWriter (reference:
    v2/io/CompressedStream.go:216-256). `output` is a file-like object with
    write(); use kanzi_tpu_torch.compress() for bytes in, bytes out.

    `device` ("cuda" by default) runs the HUFFMAN, ANS0, ANS1 and RANGE
    entropy stages on that device; "cpu" runs the kernels' plain PyTorch
    versions; None runs the host C++ engine. A "cuda" request without a
    card raises.
    """

    def __init__(self, output, transform: str = "NONE", entropy: str = "NONE",
                 block_size: int = 4 * 1024 * 1024, jobs: int = 1,
                 checksum: int = 0, file_size: int = 0,
                 headerless: bool = False, ctx: dict | None = None,
                 obs=None, device="cuda"):
        self.ctx = dict(ctx) if ctx else {}
        self.ctx.setdefault("entropy", entropy)
        self.ctx.setdefault("transform", transform)
        self.ctx.setdefault("blockSize", block_size)
        self.ctx.setdefault("jobs", jobs)
        self.ctx.setdefault("checksum", checksum)
        self.ctx.setdefault("fileSize", file_size)
        self.ctx.setdefault("headerless", headerless)

        jobs = int(self.ctx["jobs"])
        if not 1 <= jobs <= MAX_CONCURRENCY:
            raise KanziError(
                f"The number of jobs must be in [1..{MAX_CONCURRENCY}], got {jobs}",
                ERR_INVALID_PARAM)
        bsize = int(self.ctx["blockSize"])
        if bsize > MAX_BITSTREAM_BLOCK_SIZE:
            raise KanziError(
                f"The block size must be at most {MAX_BITSTREAM_BLOCK_SIZE >> 20} MB",
                ERR_INVALID_PARAM)
        if bsize < MIN_BITSTREAM_BLOCK_SIZE:
            raise KanziError(
                f"The block size must be at least {MIN_BITSTREAM_BLOCK_SIZE}",
                ERR_INVALID_PARAM)
        if bsize & 15:
            raise KanziError("The block size must be a multiple of 16", ERR_INVALID_PARAM)

        self.entropy_type = entropy_mod.get_type(str(self.ctx["entropy"]))
        self.transform_type = transforms_mod.get_type(str(self.ctx["transform"]))
        # normalize names in ctx (factory may key on them)
        self.ctx["entropy"] = entropy_mod.get_name(self.entropy_type)
        self.ctx["transform"] = transforms_mod.get_name(self.transform_type)

        self.block_size = bsize
        self.jobs = jobs
        self.headerless = bool(self.ctx["headerless"])
        self.input_size = int(self.ctx.get("fileSize") or 0)
        nb_blocks = (self.input_size + bsize - 1) // bsize if self.input_size else 0
        self.nb_input_blocks = min(nb_blocks, MAX_CONCURRENCY - 1)

        cks = int(self.ctx.get("checksum") or 0)
        if cks not in (0, 32, 64):
            raise KanziError("The block checksum size must be 32 or 64 bits",
                             ERR_INVALID_PARAM)
        self.checksum_bits = cks
        self.ctx["bsVersion"] = BITSTREAM_FORMAT_VERSION

        self._os = output
        # custom output bitstream injection (reference NewWriterWithCtx2,
        # v2/io/CompressedStream.go:254): when `obs` is given, every
        # container bit routes through it — e.g. a DebugBitWriter wrapping
        # a BitWriter — and the native one-shot splice is bypassed so the
        # injected stream observes the real bit sequence.
        self._bw = obs if obs is not None else BitWriter()
        self._pending = bytearray()
        self._block_id = 0
        self._initialized = False
        self._closed = False
        self._finalized = False
        self.listeners: list = []
        self._pool = ThreadPoolExecutor(max_workers=jobs) if jobs > 1 else None
        # native fast path: the stream lives in a pooled numpy buffer and
        # every block is one C++ call (encode) + one C++ call (frame splice)
        self._use_native = native.available() and obs is None
        self._stream: np.ndarray | None = None
        self._bitpos = 0        # bit position within self._stream
        self._bits_total = 0    # bits written over the stream's lifetime
        # device entropy engine: the device encodes the entropy stage of a
        # batch while the host transforms the next; entropy types without a
        # device engine in kanzi_tpu run on the host C++ engine
        self.device = _kernels.resolve_device(device)
        self._dev_engine = None
        # one buffer per block of a batch, so that its blocks work at once
        self._dev_posts: list = []     # the device path's transformed blocks
        self._slot_scratch: list = []  # encoded payloads
        if self.device is not None:
            self._dev_engine = entropy_mod.device_engine(self.entropy_type,
                                                         self.device)
            if self._dev_engine is not None and not self._use_native:
                raise KanziError(
                    "the device entropy engines need the native host library "
                    "and no injected bitstream", ERR_INVALID_PARAM)

    # -- events ----------------------------------------------------------
    def add_listener(self, bl) -> bool:
        """Attach a block-event listener. A device Writer keeps its entropy
        stage on the device and sends the events from its batches."""
        if bl is None:
            return False
        self.listeners.append(bl)
        return True

    def remove_listener(self, bl) -> bool:
        try:
            self.listeners.remove(bl)
            return True
        except ValueError:
            return False

    # -- header ----------------------------------------------------------
    def _write_header(self) -> None:
        if self.headerless or self._initialized:
            return
        self._initialized = True
        ck_size = {0: 0, 32: 1, 64: 2}[self.checksum_bits]
        bw = self._bw
        bw.write_bits(BITSTREAM_TYPE, 32)
        bw.write_bits(BITSTREAM_FORMAT_VERSION, 4)
        bw.write_bits(ck_size, 2)
        bw.write_bits(self.entropy_type, 5)
        bw.write_bits(self.transform_type, 48)
        bw.write_bits(self.block_size >> 4, 28)

        if self.input_size == 0 or self.input_size >= (1 << 48):
            sz_mask = 0
        elif self.input_size >= (1 << 32):
            sz_mask = 3
        elif self.input_size >= (1 << 16):
            sz_mask = 2
        else:
            sz_mask = 1
        bw.write_bits(sz_mask, 2)
        if sz_mask:
            bw.write_bits(self.input_size, 16 * sz_mask)
        bw.write_bits(0, 15)  # padding

        bw.write_bits(self._header_crc(ck_size, sz_mask), 24)
        if self._use_native:
            hdr = bw.getvalue()  # the header is whole bytes by construction
            self._ensure_stream(len(hdr) + 1024)
            self._stream[:len(hdr)] = np.frombuffer(hdr, dtype=np.uint8)
            self._bitpos = len(hdr) * 8
            self._bits_total = self._bitpos
            self._bw = BitWriter()  # unused on the native path

    def _header_crc(self, ck_size: int, sz_mask: int) -> int:
        seed = (0x01030507 * BITSTREAM_FORMAT_VERSION) & _M32
        cksum = (_HEADER_HASH * seed) & _M32
        cksum ^= (_HEADER_HASH * ((~ck_size) & _M32)) & _M32
        cksum ^= (_HEADER_HASH * ((~self.entropy_type) & _M32)) & _M32
        cksum ^= (_HEADER_HASH * (((~self.transform_type) >> 32) & _M32)) & _M32
        cksum ^= (_HEADER_HASH * ((~self.transform_type) & _M32)) & _M32
        cksum ^= (_HEADER_HASH * ((~self.block_size) & _M32)) & _M32
        if sz_mask:
            cksum ^= (_HEADER_HASH * (((~self.input_size) >> 32) & _M32)) & _M32
            cksum ^= (_HEADER_HASH * ((~self.input_size) & _M32)) & _M32
        return ((cksum >> 23) ^ (cksum >> 3)) & 0xFFFFFF

    # -- data path -------------------------------------------------------
    def write(self, data) -> int:
        if self._closed:
            raise KanziError("Stream closed", ERR_WRITE_FILE)
        mv = memoryview(data).cast("B") if not isinstance(data, memoryview) else data
        limit = self.jobs * self.block_size
        off = 0
        n = len(mv)
        # top up any pending partial batch first
        if self._pending:
            take = min(limit - len(self._pending), n)
            self._pending += mv[:take]
            off = take
            if len(self._pending) >= limit:
                self._process_batch(self._pending)
                self._pending = bytearray()
        # process full batches straight from the caller's buffer (no copy)
        while n - off >= limit:
            self._process_batch(mv[off:off + limit])
            off += limit
        if off < n:
            self._pending += mv[off:]
        # sink IO happens only after ALL input is consumed into the encoded
        # buffer, so a transient sink failure is retryable via close()
        self._flush_chunks()
        return n

    def _ensure_stream(self, nbytes: int) -> None:
        if self._stream is None or len(self._stream) < nbytes:
            # presize from the file-size hint: one warm allocation per stream
            hint = self.input_size + (self.input_size >> 3) + (1 << 16) \
                if self._os is None else self.jobs * self.block_size * 2 + (1 << 16)
            new = np.empty(max(nbytes, hint, 1 << 16,
                               0 if self._stream is None
                               else 2 * len(self._stream)), dtype=np.uint8)
            if self._stream is not None:
                used = (self._bitpos + 7) >> 3
                new[:used] = self._stream[:used]
            self._stream = new

    def _encode_one(self, args):
        block, block_id = args
        data = np.frombuffer(block, dtype=np.uint8)
        ctx = dict(self.ctx)
        return compress_block_payload(data, self.transform_type,
                                      self.entropy_type, ctx,
                                      self.checksum_bits, block_id,
                                      tuple(self.listeners))

    @staticmethod
    def _slot_buf(bufs: list, slot: int, cap: int) -> np.ndarray:
        """bufs[slot], grown to `cap` bytes (the list is sized by the
        calling thread before a batch goes to the pool)."""
        if bufs[slot] is None or len(bufs[slot]) < cap:
            bufs[slot] = np.empty(cap, dtype=np.uint8)
        return bufs[slot]

    def _size_slots(self, n: int) -> None:
        for bufs in (self._slot_scratch, self._dev_posts):
            bufs.extend([None] * (n - len(bufs)))

    def _encode_one_native(self, block, slot: int = 0) -> tuple[np.ndarray, int]:
        """Encode one block through the C++ one-shot path into the slot's
        scratch buffer; returns (scratch, bits)."""
        data = np.frombuffer(block, dtype=np.uint8)
        scratch = self._slot_buf(self._slot_scratch, slot, 2 * len(data) + 65536)
        bits, _post, _flags, _cks = native.block_encode(
            data, self.transform_type, self.entropy_type, self.ctx,
            self.checksum_bits, bool(self.ctx.get("skipBlocks", False)),
            scratch)
        return scratch, bits

    def _process_batch(self, batch) -> None:
        self._write_header()
        if not batch:
            return
        batch = memoryview(batch)
        blocks = [batch[i:i + self.block_size]
                  for i in range(0, len(batch), self.block_size)]
        if self._use_native and self._dev_engine is not None:
            self._process_batch_device(blocks)
            self._block_id += len(blocks)
            return
        if self._use_native and not self.listeners:
            # fully-native path: one encode + one splice call per block;
            # encodes run concurrently (ctypes releases the GIL — reference
            # P1, one task per block) and frames splice in block order (P2)
            self._size_slots(len(blocks))
            if self._pool is not None and len(blocks) > 1:
                results = list(self._pool.map(
                    lambda sb: self._encode_one_native(sb[1], sb[0]),
                    enumerate(blocks)))
            else:
                results = [self._encode_one_native(b) for b in blocks]
            for scratch, bits in results:
                self._append_frame(scratch, bits)
            self._block_id += len(blocks)
            return
        args = [(b, self._block_id + i + 1) for i, b in enumerate(blocks)]
        if self._pool is not None and len(blocks) > 1:
            results = list(self._pool.map(self._encode_one, args))
        else:
            results = [self._encode_one(a) for a in args]
        for i, (payload, bits) in enumerate(results):
            offset = self.written_bytes
            self._write_frame(payload, bits)
            if self.listeners:
                self._block_info(self._block_id + i + 1, payload, bits, offset)
        self._block_id += len(blocks)

    def _block_info(self, block_id: int, payload, bits: int, offset: int) -> None:
        """The BLOCK_INFO event of a frame just written at byte `offset`:
        block offset + skip flags (reference EVT_BLOCK_INFO,
        v2/io/CompressedStream.go:922-931); flags sit in the mode byte (or
        the byte after it when > 4 transforms)."""
        mode = int(payload[0])
        if mode & COPY_BLOCK_MASK:
            flags = 0xFF
        elif mode & TRANSFORMS_MASK:
            flags = int(payload[1])
        else:
            flags = ((mode << 4) | 0x0F) & 0xFF
        _notify(self.listeners, Event(
            EventType.BLOCK_INFO, block_id, (bits + 7) >> 3, 0, HashType.NONE,
            time.time(),
            msg=f'{{ "type":"BLOCK_INFO", "id":{block_id},'
                f' "offset":{offset}, "skipFlags":"{flags:08b}" }}'))

    def _process_batch_device(self, blocks) -> None:
        """Heterogeneous batch: host C++ transforms + the device entropy
        engine, `jobs` blocks at a time.

        Phase 1 transforms each block, writes its frame header and makes
        the engine's host prep of it, each block into its own slot buffer,
        on the Writer's pool (ctypes releases the GIL, as on the native
        path). The calling thread stacks the batch's device rows and
        launches the encode of all of them once (the engine has one CUDA
        stream). Phase 2 assembles each block's payload into its own slot
        scratch, on the pool, and the frames splice in block order here
        (the device-era analogue of the reference's processedBlockID
        ordering, v2/io/CompressedStream.go:934-949).

        Listeners get compress_block_payload's events, sizes and hashes:
        the transform events and BEFORE_ENTROPY from phase 1 and
        AFTER_ENTROPY from phase 2, on the pool's threads, and BLOCK_INFO
        in block order as each frame splices.
        """
        engine = self._dev_engine
        self._size_slots(len(blocks))
        run = self._pool.map if self._pool is not None and len(blocks) > 1 else map
        listeners = tuple(self.listeners)
        hash_type = HashType(self.checksum_bits // 32)
        first_id = self._block_id + 1

        def transform(slot):
            data = np.frombuffer(blocks[slot], dtype=np.uint8)
            post_buf = self._slot_buf(self._dev_posts, slot, 2 * len(data) + 65536)
            t0 = time.time()
            post_len, mode, extra, flags, cks, copy = native.block_transform(
                data, self.transform_type, self.entropy_type, self.ctx,
                self.checksum_bits, bool(self.ctx.get("skipBlocks", False)),
                post_buf)
            if listeners:
                bid, t1 = first_id + slot, time.time()
                for evt, size, t in ((EventType.BEFORE_TRANSFORM, len(data), t0),
                                     (EventType.AFTER_TRANSFORM, post_len, t1),
                                     (EventType.BEFORE_ENTROPY, post_len, t1)):
                    _notify(listeners, Event(evt, bid, size, cks, hash_type, t))
            hdr = bytearray([mode])
            if extra:
                hdr.append(flags)
            ds = 1 + ((mode >> 5) & 0x03)
            hdr += post_len.to_bytes(ds, "big")
            if self.checksum_bits:
                hdr += cks.to_bytes(self.checksum_bits // 8, "big")
            post = post_buf[:post_len]
            return hdr, post, cks, None if copy else engine.prep(post)

        def assemble(args):
            slot, (hdr, post, cks, handle) = args
            scratch = self._slot_buf(self._slot_scratch, slot,
                                     len(hdr) + 2 * len(post) + 65536)
            scratch[:len(hdr)] = np.frombuffer(hdr, dtype=np.uint8)
            if handle is None:  # copy mode: raw payload
                scratch[len(hdr):len(hdr) + len(post)] = post
                pbits = 8 * len(post)
            else:
                pbits = engine.collect(handle, scratch, len(hdr))
            if listeners:  # the entropy payload alone, without the frame header
                _notify(listeners, Event(EventType.AFTER_ENTROPY, first_id + slot,
                                         (pbits + 7) >> 3, cks, hash_type,
                                         time.time()))
            return scratch, 8 * len(hdr) + pbits

        staged = list(run(transform, range(len(blocks))))
        preps = [prep for *_, prep in staged if prep is not None]
        handles = iter(engine.dispatch_prepped(preps) if preps else ())
        framed = [(hdr, post, cks, None if prep is None else next(handles))
                  for hdr, post, cks, prep in staged]
        for slot, (scratch, bits) in enumerate(run(assemble, enumerate(framed))):
            offset = self.written_bytes
            self._append_frame(scratch, bits)
            if listeners:
                self._block_info(first_id + slot, scratch, bits, offset)

    def _append_frame(self, payload: np.ndarray, bits: int) -> None:
        need = ((self._bitpos + bits) >> 3) + 64
        self._ensure_stream(need)
        new_pos = native.frame_append(self._stream, self._bitpos, payload, bits)
        self._bits_total += new_pos - self._bitpos
        self._bitpos = new_pos

    def _write_frame(self, payload: bytes, bits: int) -> None:
        if self._use_native:
            self._append_frame(np.frombuffer(payload, dtype=np.uint8), bits)
            return
        lw = 3 if bits < 8 else internal.log2_no_check(bits >> 3) + 4
        self._bw.write_bits(lw - 3, 5)
        self._bw.write_bits(bits, lw)
        self._bw.write_array(payload, bits)
        self._flush_chunks()

    def _flush_chunks(self) -> None:
        # move completed bytes out to the underlying stream
        if self._use_native:
            if self._os is None:
                return  # one-shot mode: getvalue() hands out the buffer
            nbytes = self._bitpos >> 3
            if nbytes:
                self._os.write(self._stream[:nbytes].tobytes())
                # keep the trailing partial byte, restart at the front
                self._stream[0] = self._stream[nbytes]
                self._bitpos &= 7
            return
        if self._os is None:
            return  # injected-obs mode: the obs owns the bytes
        # Drain incrementally: advance the cursor only after each write
        # succeeded, so a retried close() after a transient sink failure
        # resumes at the first unwritten chunk instead of duplicating
        # already-flushed bytes (cursor, not pop(0): O(n) total).
        data = self._bw._chunks
        i = 0
        try:
            while i < len(data):
                self._os.write(data[i])
                i += 1
        finally:
            del data[:i]

    def close(self) -> None:
        """Close the stream. Retryable after a transient sink failure
        (reference: v2/bitstream/DefaultOutputBitStream.go:237-257 + tests):
        a failed write leaves the buffered state intact, and a second close()
        resumes without duplicating the end marker."""
        if self._closed:
            return
        if not self._finalized:
            self._process_batch(self._pending)
            self._pending = bytearray()
            self._write_header()  # empty input still gets a header
            if self._use_native:
                self._ensure_stream((self._bitpos >> 3) + 16)
                nbytes = native.stream_close(self._stream, self._bitpos)
                self._bits_total += nbytes * 8 - self._bitpos
                self._bitpos = nbytes * 8
            else:
                # end-of-stream marker: zero-length block
                self._bw.write_bits(0, 5)
                self._bw.write_bits(0, 3)
                self._bw.close()
            self._finalized = True
        if self._use_native:
            if self._os is not None:
                nbytes = self._bitpos >> 3
                self._os.write(self._stream[:nbytes].tobytes())
                self._bitpos = 0
        else:
            self._flush_chunks()
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def getvalue(self) -> bytes:
        """One-shot mode (output=None): the full stream after close()."""
        if not self._closed:
            raise KanziError("Stream not closed", ERR_WRITE_FILE)
        if not self._use_native or self._os is not None:
            raise KanziError("getvalue() requires output=None", ERR_WRITE_FILE)
        return self._stream[: self._bitpos >> 3].tobytes()

    @property
    def written_bytes(self) -> int:
        if self._use_native:
            return (self._bits_total + 7) >> 3
        return (self._bw.written + 7) >> 3


class Reader:
    """Decompressing reader for KANZ streams (v5/v6 headers; v6 payloads).

    Accepts bytes (zero-copy) or a file-like object, which is read
    incrementally with consumed bytes dropped — decoding is
    constant-memory in the stream size. Mirrors kio.NewReader
    (reference: v2/io/CompressedStream.go:1047-1110).

    `device` ("cuda" by default) decodes HUFFMAN, ANS0, ANS1 and RANGE
    payloads on that device; "cpu" uses the plain PyTorch versions; None is
    the fully native host path. With `jobs` > 1, a device stream decodes
    `jobs` blocks a launch (_read_batch_device), listeners or not; with
    `jobs=1`, block by block, through the per-block payload path.
    """

    _REFILL = 1 << 20       # streaming read granularity
    _COMPACT = 32 << 20     # drop consumed source bytes past this point

    def __init__(self, source, jobs: int = 1, headerless: bool = False,
                 ctx: dict | None = None, ibs=None, device="cuda"):
        # custom input bitstream injection (reference NewReaderWithCtx2,
        # v2/io/CompressedStream.go:1098): `ibs` is a wrapper callable
        # receiving the container's internal bit reader and returning the
        # reader to use — DebugBitReader fits directly
        # (Reader(blob, ibs=lambda br: DebugBitReader(br))). Forces the
        # Python bit path so the wrapper observes every container read.
        self._ibs_wrap = ibs
        self._fh = None
        if hasattr(source, "read"):
            self._fh = source
            self._srcbuf = np.empty(self._REFILL, dtype=np.uint8)
            self._src_len = 0
        else:
            self._srcbuf = np.frombuffer(source, dtype=np.uint8)
            self._src_len = len(self._srcbuf)
        self._rebind(0)
        self._use_native = native.available() and ibs is None
        self._fast: bool | None = None
        self._outbuf: np.ndarray | None = None
        self._outbuf_len = 0
        self._slot_out: list = []  # per-block buffers for parallel decode
        self.ctx = dict(ctx) if ctx else {}
        self.ctx.setdefault("jobs", jobs)
        self.device = _kernels.resolve_device(device)
        # read by entropy.decode on the per-block payload path
        self.ctx["device"] = None if self.device is None else str(self.device)
        self.headerless = headerless or bool(self.ctx.get("headerless", False))
        self.jobs = int(self.ctx.get("jobs", 1))
        if not 1 <= self.jobs <= MAX_CONCURRENCY:
            raise KanziError(
                f"The number of jobs must be in [1..{MAX_CONCURRENCY}], got {self.jobs}",
                ERR_INVALID_PARAM)
        self._initialized = False
        self._eos = False
        self._block_id = 0
        self._chunks: list = []
        self._chunks_len = 0
        self._out = bytearray()
        self._out_pos = 0
        self.outputSize = 0
        self.listeners: list = []
        self.checksum_bits = 0
        self._pool = ThreadPoolExecutor(max_workers=self.jobs) if self.jobs > 1 else None
        if self.headerless:
            self._init_headerless()

    def add_listener(self, bl) -> bool:
        if bl is None:
            return False
        self.listeners.append(bl)
        return True

    def _rebind(self, bitpos: int) -> None:
        """(Re)create the bit reader + native view over the valid prefix."""
        self._src = self._srcbuf[:self._src_len]
        self._br = BitReader(self._src)
        self._br._pos = bitpos
        if self._ibs_wrap is not None:
            self._br = self._ibs_wrap(self._br)

    def _ensure_bits(self, end_bits: int) -> None:
        """Best-effort fill of the source buffer up to `end_bits`."""
        if self._fh is None:
            return
        need = (end_bits + 7) >> 3
        while self._src_len < need:
            chunk = self._fh.read(max(need - self._src_len, self._REFILL))
            if not chunk:
                break
            arr = np.frombuffer(chunk, dtype=np.uint8)
            if self._src_len + len(arr) > len(self._srcbuf):
                new = np.empty(max(2 * len(self._srcbuf),
                                   self._src_len + len(arr)), dtype=np.uint8)
                new[:self._src_len] = self._srcbuf[:self._src_len]
                self._srcbuf = new
            self._srcbuf[self._src_len:self._src_len + len(arr)] = arr
            self._src_len += len(arr)
        self._rebind(self._br._pos)

    def _compact(self) -> None:
        """Drop consumed whole source bytes (streaming mode, frame-aligned
        call sites only — no outstanding positions may exist)."""
        if self._fh is None:
            return
        drop = self._br._pos >> 3
        if drop < self._COMPACT:
            return
        keep = self._src_len - drop
        self._srcbuf[:keep] = self._srcbuf[drop:self._src_len]
        self._src_len = keep
        self._rebind(self._br._pos & 7)

    def _init_headerless(self) -> None:
        self._initialized = True
        self.entropy_type = entropy_mod.get_type(str(self.ctx.get("entropy", "NONE")))
        self.transform_type = transforms_mod.get_type(str(self.ctx.get("transform", "NONE")))
        self.block_size = int(self.ctx.get("blockSize", 4 * 1024 * 1024))
        self.checksum_bits = int(self.ctx.get("checksum", 0))
        self.outputSize = int(self.ctx.get("outputSize", 0) or 0)
        self.ctx.setdefault("bsVersion", BITSTREAM_FORMAT_VERSION)

    def _read_header(self) -> None:
        if self._initialized:
            return
        self._initialized = True
        self._ensure_bits(64 * 8)
        br = self._br
        if br.read_bits(32) != BITSTREAM_TYPE:
            raise KanziError("Invalid stream type", ERR_INVALID_FILE)
        bs_version = br.read_bits(4)
        if bs_version > BITSTREAM_FORMAT_VERSION:
            raise KanziError(
                f"Invalid bitstream, cannot read this version of the stream: {bs_version}",
                ERR_STREAM_VERSION)
        self.ctx["bsVersion"] = bs_version

        ck_size = 0
        if bs_version >= 6:
            ck_size = br.read_bits(2)
            if ck_size == 3:
                raise KanziError(
                    f"Invalid bitstream, incorrect checksum size: {ck_size}",
                    ERR_INVALID_CODEC)
            self.checksum_bits = {0: 0, 1: 32, 2: 64}[ck_size]
        else:
            if br.read_bit() == 1:
                self.checksum_bits = 32
                ck_size = 1

        self.entropy_type = br.read_bits(5)
        try:
            self.ctx["entropy"] = entropy_mod.get_name(self.entropy_type)
        except ValueError:
            raise KanziError(
                f"Invalid bitstream, incorrect entropy type: {self.entropy_type}",
                ERR_INVALID_CODEC)
        self.transform_type = br.read_bits(48)
        try:
            self.ctx["transform"] = transforms_mod.get_name(self.transform_type)
        except ValueError:
            raise KanziError(
                f"Invalid bitstream, incorrect transform type: {self.transform_type}",
                ERR_INVALID_CODEC)
        self.block_size = br.read_bits(28) << 4
        if not MIN_BITSTREAM_BLOCK_SIZE <= self.block_size <= MAX_BITSTREAM_BLOCK_SIZE:
            raise KanziError(
                f"Invalid bitstream, incorrect block size: {self.block_size}",
                ERR_BLOCK_SIZE)
        self.ctx["blockSize"] = self.block_size

        if bs_version >= 5:
            sz_mask = br.read_bits(2)
            if sz_mask:
                self.outputSize = br.read_bits(16 * sz_mask)
                self.ctx["outputSize"] = self.outputSize

            crc_size, seed = 16, bs_version
            if bs_version >= 6:
                br.read_bits(15)  # padding
                crc_size = 24
                seed = (0x01030507 * bs_version) & _M32

            cksum1 = br.read_bits(crc_size)
            cksum2 = (_HEADER_HASH * seed) & _M32
            if bs_version >= 6:
                cksum2 ^= (_HEADER_HASH * ((~ck_size) & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * ((~self.entropy_type) & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * (((~self.transform_type) >> 32) & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * ((~self.transform_type) & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * ((~self.block_size) & _M32)) & _M32
            if sz_mask:
                cksum2 ^= (_HEADER_HASH * (((~self.outputSize) >> 32) & _M32)) & _M32
                cksum2 ^= (_HEADER_HASH * ((~self.outputSize) & _M32)) & _M32
            cksum2 = ((cksum2 >> 23) ^ (cksum2 >> 3)) & ((1 << crc_size) - 1)
            if cksum1 != cksum2:
                raise KanziError("Invalid bitstream: checksum mismatch", ERR_CRC_CHECK)
        elif bs_version >= 3:
            # v3/v4 header (CompressedStream.go:1461-1474): 6-bit input block
            # count and a 4-bit checksum over the UNinverted fields
            nb_input_blocks = br.read_bits(6)
            cksum1 = br.read_bits(4)
            cksum2 = (_HEADER_HASH * bs_version) & _M32
            cksum2 ^= (_HEADER_HASH * (self.entropy_type & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * ((self.transform_type >> 32) & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * (self.transform_type & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * (self.block_size & _M32)) & _M32
            cksum2 ^= (_HEADER_HASH * (nb_input_blocks & _M32)) & _M32
            cksum2 = ((cksum2 >> 23) ^ (cksum2 >> 3)) & 0x0F
            if cksum1 != cksum2:
                raise KanziError("Invalid bitstream: corrupted header",
                                 ERR_INVALID_FILE)
        else:
            # pre-v3 header (CompressedStream.go:1475-1479): block count +
            # 4 reserved bits, no checksum
            br.read_bits(6)
            br.read_bits(4)

        if self.listeners:
            _notify(self.listeners, Event(
                EventType.AFTER_HEADER_DECODING, 0, self.block_size, 0,
                HashType.NONE, time.time(),
                msg=f'{{ "type":"AFTER_HEADER_DECODING", "bsVersion":{bs_version},'
                    f' "blockSize":{self.block_size},'
                    f' "entropy":"{self.ctx["entropy"]}",'
                    f' "transform":"{self.ctx["transform"]}",'
                    f' "checksum":{self.checksum_bits},'
                    f' "outputSize":{self.outputSize} }}',
                info=HeaderInfo(
                    bs_version=bs_version,
                    checksum_size=self.checksum_bits,
                    block_size=self.block_size,
                    entropy_type=self.ctx["entropy"],
                    transform_type=self.ctx["transform"],
                    original_size=self.outputSize if self.outputSize else -1,
                    file_size=self.ctx.get("fileSize", -1),
                    input_name=self.ctx.get("inputName", ""))))

    def _ensure_outbuf(self, nbytes: int) -> None:
        if self._outbuf is None:
            init = self.outputSize + 16 if (self.outputSize and
                                            self._fh is None) else max(
                4 * self.block_size, nbytes)
            self._outbuf = np.empty(max(init, nbytes), dtype=np.uint8)
        elif len(self._outbuf) < nbytes:
            new = np.empty(max(nbytes, 2 * len(self._outbuf)), dtype=np.uint8)
            new[:self._outbuf_len] = self._outbuf[:self._outbuf_len]
            self._outbuf = new

    def _native_path(self) -> bool:
        """The fully native decode, `jobs` frames at a time: no listener,
        and no device work. A device decode routes through the Python
        payload path (the device entropy engines live there); a stream
        whose entropy type has no device engine, or whose bitstream version
        is below 6, never touches the device and decodes natively, as
        kanzi_tpu's default Reader decodes it."""
        return (self._use_native and not self.listeners
                and not entropy_mod.decodes_on_device(self.entropy_type, self.ctx))

    def _device_batch(self) -> bool:
        """The batched device decode, `jobs` frames a launch: the stream
        decodes on the device, with no injected bit reader. Listeners get
        their events from the batch (_read_batch_device)."""
        return (self._use_native
                and entropy_mod.decodes_on_device(self.entropy_type, self.ctx))

    def _read_next_block(self) -> bool:
        """Read+decode the next block into the output buffer.
        Returns False at end of stream."""
        self._compact()
        self._ensure_bits(self._br._pos + 40)
        br = self._br
        lw = br.read_bits(5) + 3
        bits = br.read_bits(lw)
        if bits == 0:
            return False
        if bits > 1 << 34:
            raise KanziError("Invalid block size", ERR_BLOCK_SIZE)
        self._ensure_bits(br.read + bits + 40)
        br = self._br
        self._block_id += 1

        frm = self.ctx.get("from")
        to = self.ctx.get("to")
        if (frm is not None and self._block_id < frm) or \
                (to is not None and self._block_id >= to):
            br._pos += bits  # skipped block: advance past the payload
            return True

        if self._fast is None:
            # freeze the path on the first block so output ordering is
            # consistent even if listeners are mutated mid-stream
            self._fast = self._native_path()
        if self._fast:
            # fully-native path: decode straight from the stream buffer into
            # the (single) output buffer — zero Python-side byte handling
            pos = br._pos
            self._ensure_outbuf(self._outbuf_len + self.block_size)
            try:
                n = native.block_decode(
                    self._src, pos >> 3, pos & 7, self.transform_type,
                    self.entropy_type, self.ctx, self.checksum_bits,
                    self.block_size, self._outbuf, self._outbuf_len,
                    len(self._outbuf) - self._outbuf_len)
            except native.ChecksumMismatch:
                raise KanziError(
                    f"Corrupted bitstream: block {self._block_id} checksum mismatch",
                    ERR_CRC_CHECK)
            except RuntimeError as e:
                raise KanziError(f"Block {self._block_id}: {e}", ERR_PROCESS_BLOCK)
            if n > self.block_size:
                raise KanziError(f"Block {self._block_id} incorrectly decompressed",
                                 ERR_PROCESS_BLOCK)
            self._outbuf_len += n
            br._pos = pos + bits
            return True

        payload = br.read_array(bits)
        try:
            data = decompress_block_payload(payload, self.transform_type,
                                            self.entropy_type, self.ctx,
                                            self.block_size, self.checksum_bits,
                                            self._block_id, tuple(self.listeners))
        except KanziError:
            raise
        except (ValueError, RuntimeError) as e:
            # a payload the decoders reject: the error contract of the
            # native path above, device decodes included
            raise _block_error(self._block_id, e) from e
        if len(data) > self.block_size:
            raise KanziError(f"Block {self._block_id} incorrectly decompressed",
                             ERR_PROCESS_BLOCK)
        self._chunks.append(data)
        self._chunks_len += len(data)
        return True

    def _read_frames(self):
        """Read up to `jobs` frames serially (the frame reads are serialized
        on the shared bitstream, reference v2/io/CompressedStream.go:1798-1856),
        skipping the blocks outside ctx's from/to. Returns ([(bit position
        of the payload, its bit length, block id)], False once the end
        marker was consumed)."""
        self._compact()
        frames = []
        more = True
        while len(frames) < self.jobs:
            self._ensure_bits(self._br._pos + 40)
            br = self._br
            lw = br.read_bits(5) + 3
            bits = br.read_bits(lw)
            if bits == 0:
                more = False
                break
            if bits > 1 << 34:
                raise KanziError("Invalid block size", ERR_BLOCK_SIZE)
            self._ensure_bits(br.read + bits + 40)
            br = self._br
            pos = br._pos
            br._pos = pos + bits
            self._block_id += 1
            frm, to = self.ctx.get("from"), self.ctx.get("to")
            if (frm is not None and self._block_id < frm) or \
                    (to is not None and self._block_id >= to):
                continue
            frames.append((pos, bits, self._block_id))
        if frames and int(self.ctx.get("bsVersion", BITSTREAM_FORMAT_VERSION)) < 5:
            raise KanziError(
                "Legacy bitstream payloads (version < 5) are not supported",
                ERR_STREAM_VERSION)
        return frames, more

    def _read_batch_device(self) -> bool:
        """Read up to `jobs` frames and decode them together: the frame
        headers on the pool, the device entropy stage of the batch in one
        launch (one per chunk index for RANGE, entropy.decode_many), the
        inverse transforms and checksums on the pool; the outputs append
        in block order. A block that fails raises as _read_next_block
        would, under its own id (the first failing block of the batch).
        Listeners get decompress_block_payload's events: BEFORE_ENTROPY
        (the decoder's ordered phase) in block order before the launch; the
        other three, stamped on the pool when they happen, in block order
        once the batch is done, so that a block's lines come in block order
        as on the per-block path.
        Returns False once the end marker was consumed."""
        frames, more = self._read_frames()
        if not frames:
            return more
        payloads = []
        for pos, bits, _ in frames:
            br = BitReader(self._src)
            br._pos = pos
            payloads.append(br.read_array(bits))
        run = self._pool.map
        heads = _each(run, lambda p: _parse_block_header(
            p, self.transform_type, self.entropy_type, self.block_size,
            self.checksum_bits), payloads)
        listeners = tuple(self.listeners)
        hash_type = HashType(self.checksum_bits // 32)
        if listeners:
            for (_, _, block_id), p, h in zip(frames, payloads, heads):
                if isinstance(h, Exception):
                    break
                _notify(listeners, Event(EventType.BEFORE_ENTROPY, block_id,
                                         len(p), h[5], hash_type, time.time()))
        # copy-mode blocks (entropy NONE) need no device work
        dev = [i for i, h in enumerate(heads)
               if not isinstance(h, Exception) and h[1] != entropy_mod.NONE_TYPE]
        decoded = dict(zip(dev, entropy_mod.decode_many(
            self.entropy_type, [payloads[i][heads[i][4]:] for i in dev],
            [heads[i][3] for i in dev], self.ctx, run))) if dev else {}

        def finish(i):
            if isinstance(heads[i], Exception):
                raise heads[i]
            t_type, e_type, skip_flags, pre_len, offset, checksum1 = heads[i]
            if e_type == entropy_mod.NONE_TYPE:
                buf = entropy_mod.decode(e_type, payloads[i][offset:], pre_len, self.ctx)
            else:
                buf = decoded[i]
                if isinstance(buf, Exception):
                    raise buf
            block_id, events = frames[i][2], []
            if listeners:
                t = time.time()
                events += [Event(evt, block_id, pre_len, checksum1, hash_type, t)
                           for evt in (EventType.AFTER_ENTROPY,
                                       EventType.BEFORE_TRANSFORM)]
            result = _inverse_block(buf, t_type, skip_flags, self.ctx, pre_len)
            if listeners:
                events.append(Event(EventType.AFTER_TRANSFORM, block_id, len(result),
                                    checksum1, hash_type, time.time()))
            return _verify_checksum(result, self.checksum_bits, checksum1), events

        outs = _each(run, finish, range(len(frames)))
        for (_, _, block_id), out in zip(frames, outs):
            if isinstance(out, Exception):
                raise _block_error(block_id, out)
            for evt in out[1]:
                _notify(listeners, evt)
            if len(out[0]) > self.block_size:
                raise KanziError(f"Block {block_id} incorrectly decompressed",
                                 ERR_PROCESS_BLOCK)
        for out, _ in outs:
            self._chunks.append(out)
            self._chunks_len += len(out)
        return more

    def _read_batch_parallel(self) -> bool:
        """Read up to `jobs` frames serially, decode them concurrently
        (reference: frame reads are serialized on the shared bitstream,
        decodes overlap — v2/io/CompressedStream.go:1798-1856), then append
        in block order. Returns False once the end marker was consumed."""
        frames, more = self._read_frames()
        if not frames:
            return more

        while len(self._slot_out) < len(frames):
            self._slot_out.append(None)
        for i in range(len(frames)):
            if self._slot_out[i] is None or len(self._slot_out[i]) < self.block_size:
                self._slot_out[i] = np.empty(self.block_size, dtype=np.uint8)

        def decode_one(args):
            i, (pos, _, block_id) = args
            try:
                return native.block_decode(
                    self._src, pos >> 3, pos & 7, self.transform_type,
                    self.entropy_type, self.ctx, self.checksum_bits,
                    self.block_size, self._slot_out[i], 0, self.block_size)
            except native.ChecksumMismatch:
                raise KanziError(
                    f"Corrupted bitstream: block {block_id} checksum mismatch",
                    ERR_CRC_CHECK)
            except RuntimeError as e:
                raise KanziError(f"Block {block_id}: {e}", ERR_PROCESS_BLOCK)

        lens = list(self._pool.map(decode_one, enumerate(frames)))
        total = sum(lens)
        self._ensure_outbuf(self._outbuf_len + total)
        for i, ln in enumerate(lens):
            self._outbuf[self._outbuf_len:self._outbuf_len + ln] = \
                self._slot_out[i][:ln]
            self._outbuf_len += ln
        return more

    def read(self, n: int = -1) -> bytes:
        if not self._initialized:
            self._read_header()
        if self._fast is None:
            self._fast = self._native_path()
        batch = None
        if self._pool is not None:
            if self._fast:
                batch = self._read_batch_parallel
            elif self._device_batch():
                batch = self._read_batch_device
        while not self._eos and (
                n < 0 or self._available() < n):
            if batch is not None:
                if not batch():
                    self._eos = True
            elif not self._read_next_block():
                self._eos = True
        if self._fast:
            end = self._outbuf_len if n < 0 else min(self._outbuf_len,
                                                     self._out_pos + n)
            res = (b"" if self._outbuf is None
                   else self._outbuf[self._out_pos:end].tobytes())
            self._out_pos = end
            if self._fh is not None and self._out_pos >= (32 << 20):
                # streaming mode: drop served output, keep memory bounded
                rem = self._outbuf_len - self._out_pos
                self._outbuf[:rem] = self._outbuf[self._out_pos:self._outbuf_len]
                self._outbuf_len = rem
                self._out_pos = 0
            return res
        if self._chunks:
            if not self._out and self._out_pos == 0 and len(self._chunks) == 1:
                self._out = bytearray(self._chunks[0])
            else:
                self._out += b"".join(self._chunks)
            self._chunks = []
            self._chunks_len = 0
        end = len(self._out) if n < 0 else min(len(self._out), self._out_pos + n)
        if n < 0 and self._out_pos == 0:
            res = bytes(self._out)
        else:
            res = bytes(self._out[self._out_pos:end])
        self._out_pos = end
        return res

    def _available(self) -> int:
        if self._fast:
            return self._outbuf_len - self._out_pos
        return len(self._out) - self._out_pos + self._chunks_len

    def read_all(self) -> bytes:
        return self.read(-1)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def frame_table(blob: bytes):
    """Serial frame walk over a headered stream, no payload decode (the
    reference's serialized frame reads, v2/io/CompressedStream.go:1798-1856):
    returns ([(bit_pos, block_id), ...], reader) with the reader holding
    the parsed header config. Shared by the multi-process and multi-host
    decode striping (parallel/multiproc.py, parallel/multihost.py) so the
    frame-header layout lives in one place. The reader parses headers only,
    so it is built with device=None.
    """
    import io as _io

    r = Reader(_io.BytesIO(blob), device=None)
    r._read_header()
    br = BitReader(blob)
    br._pos = r._br._pos
    frames = []
    block_id = 0
    while True:
        lw = br.read_bits(5) + 3
        bits = br.read_bits(lw)
        if bits == 0:
            break
        block_id += 1
        frames.append((br._pos, block_id))
        br._pos += bits
    return frames, r
