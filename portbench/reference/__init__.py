"""A plain decoder of the KANZ v6 streams the benchmark's cells write.

The container is here: the file header, the block frames and the block
header (mode, length, XXHash32), from the format (kanzi-go v2:
io/CompressedStream.go). The entropy decoders and inverse transforms are
files of their own, found by id: `entropy/<name>.py` and
`transform/<name>.py` each name the ids they take (IDS), so a cell with
another codec adds a file and edits none. Each is written from kanzi-go's
source (entropy/RangeCodec.go, entropy/ANSRangeCodec.go,
transform/LZCodec.go, hash/XXHash32.go) in plain Python, one symbol at a
time. The reference imports nothing of the program under test and shares
no table with it: it is the yardstick that the program's streams are held
to.

It is slow (a few microseconds a symbol), so the benchmark runs it on a
sample of blocks drawn from the seed, after the measured window.
"""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass

from .format import Bits, FormatError, M32, take_bits
from .xxhash32 import MAGIC, xxhash32

__all__ = ["Bits", "FormatError", "MAGIC", "ERR_CRC_CHECK", "Header", "Frame", "BlockHead",
           "parse", "block_head", "decode_block", "xxhash32", "codecs"]

VERSION = 6
COPY_BLOCK_MASK = 0x80
TRANSFORMS_MASK = 0x10
HEADER_HASH = 0x1E35A7BD
ERR_CRC_CHECK = 19            # kanzi's error code for a block checksum mismatch
ENTROPY_NONE, TRANSFORM_NONE = 0, 0
HERE = os.path.dirname(os.path.abspath(__file__))


def codecs(kind: str) -> dict:
    """{id: module} of the files under `kind` (entropy or transform)."""
    found = {}
    for f in sorted(os.listdir(os.path.join(HERE, kind))):
        if f.endswith(".py") and not f.startswith("_"):
            mod = importlib.import_module(f"{__name__}.{kind}.{f[:-3]}")
            for i in mod.IDS:
                if i in found:
                    raise ValueError(f"{kind} id {i} in two files")
                found[i] = mod
    return found


@dataclass
class Header:
    checksum_bits: int
    entropy: int
    transform: int
    block_size: int
    size: int


@dataclass
class Frame:
    index: int      # 0-based block index
    pos: int        # bit position of the payload in the stream
    nbits: int      # payload bit count


def read_header(bits: Bits) -> Header:
    if bits.read(32) != MAGIC:
        raise FormatError("not a KANZ stream")
    if bits.read(4) != VERSION:
        raise FormatError("not a version 6 stream")
    ck = bits.read(2)
    if ck == 3:
        raise FormatError("bad checksum size")
    entropy = bits.read(5)
    transform = bits.read(48)
    block_size = bits.read(28) << 4
    sz_mask = bits.read(2)
    size = bits.read(16 * sz_mask) if sz_mask else 0
    bits.read(15)
    crc = bits.read(24)
    h = (HEADER_HASH * ((0x01030507 * VERSION) & M32)) & M32
    for v in (ck, entropy, transform >> 32, transform, block_size):
        h ^= (HEADER_HASH * ((~v) & M32)) & M32
    if sz_mask:
        h ^= (HEADER_HASH * (((~size) >> 32) & M32)) & M32
        h ^= (HEADER_HASH * ((~size) & M32)) & M32
    if crc != ((h >> 23) ^ (h >> 3)) & 0xFFFFFF:
        raise FormatError("header checksum mismatch")
    return Header(32 * ck, entropy, transform, block_size, size)


def parse(stream: bytes) -> tuple[Header, list[Frame]]:
    """The stream's header and its block frames, up to the end marker."""
    bits = Bits(stream)
    header = read_header(bits)
    frames = []
    while True:
        lw = bits.read(5) + 3
        nbits = bits.read(lw)
        if nbits == 0:
            return header, frames
        frames.append(Frame(len(frames), bits.pos, nbits))
        bits._advance(nbits)


@dataclass
class BlockHead:
    entropy: int
    transform: int
    skip: int          # skip flags: bit 7 - i set, transform i skipped
    length: int        # the entropy stage's output bytes
    stored: int        # the checksum the block stores
    checksum_pos: int  # bit position of that checksum in the stream
    payload_pos: int   # bit position of the entropy payload in the stream


def block_head(stream: bytes, header: Header, frame: Frame) -> BlockHead:
    bits = Bits(stream, frame.pos)
    mode = bits.read(8)
    entropy, transform, skip = header.entropy, header.transform, 0
    if mode & COPY_BLOCK_MASK:
        entropy, transform = ENTROPY_NONE, TRANSFORM_NONE
    elif mode & TRANSFORMS_MASK:
        skip = bits.read(8)
    else:
        skip = ((mode << 4) | 0x0F) & 0xFF
    length = bits.read(8 * (1 + ((mode >> 5) & 3)))
    checksum_pos = bits.pos
    stored = bits.read(header.checksum_bits) if header.checksum_bits else 0
    return BlockHead(entropy, transform, skip, length, stored, checksum_pos, bits.pos)


def decode_block(stream: bytes, header: Header, frame: Frame) -> tuple[bytes, int]:
    """A block's original bytes, and the checksum its header stores."""
    head = block_head(stream, header, frame)
    rel = head.payload_pos - frame.pos
    bits = Bits(take_bits(stream, frame.pos, frame.nbits), rel)
    entropy, transforms = codecs("entropy"), codecs("transform")
    if head.entropy not in entropy:
        raise FormatError(f"entropy type {head.entropy}: no decoder in reference/entropy/")
    data = entropy[head.entropy].decode(bits, head.length)
    for i in reversed(range(8)):
        t = (head.transform >> (42 - 6 * i)) & 0x3F
        if t == TRANSFORM_NONE or head.skip & (1 << (7 - i)):
            continue
        if t not in transforms:
            raise FormatError(f"transform type {t}: no inverse in reference/transform/")
        data = transforms[t].inverse(data)
    return bytes(data), head.stored
