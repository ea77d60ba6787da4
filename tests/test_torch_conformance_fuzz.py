"""Mutated streams through the port against kanzi_tpu, on the CPU.

test_faults_and_cli.py::test_fuzz_mutations_never_crash_or_pass_silently's
recipe (one to three seeded byte XORs anywhere in a stream of 64 KiB
blocks), at levels 0, 1, 2 and 5 and for ANS1 and RANGE, with checksum 32
and 0, decoded by kanzi_tpu and by the port on its host route
(device=None) and its plain-version route (device="cpu"), each mutant at
jobs 1 or 4 in turns. The outcomes must be equal: the same bytes (with
checksum 0 a mutant may decode to other bytes, and then to the same
ones), or a KanziError with the same code. With checksum 32 no mutant
decodes to anything but the input. Targeted edits of the entropy
payloads' chunk headers and of the block sizes are in
test_torch_conformance_edits below; the same recipe runs on the card in
chip_smoke.py's robustness phase and tests/test_torch_gpu.py.
"""

import hashlib

import numpy as np
import pytest

import kanzi_tpu
from kanzi_tpu.core import KanziError as JaxKanziError
import kanzi_tpu_torch as kt
from kanzi_tpu_torch.core import KanziError

ROUTES = [None, "cpu"]

# the recipe's base; ANS1 and RANGE take a 6 KiB piece of it on the "cpu"
# route, whose plain range and ANS loops take seconds a block
_RNG = np.random.default_rng(123)
BASE = (b"fuzz corpus data " * 1000
        + _RNG.integers(0, 256, 10000, dtype=np.uint8).tobytes())
SHORT = BASE[14000:20000]

CONFIGS = {
    "level0": (dict(level=0), BASE, 10),
    "level1": (dict(level=1), BASE, 10),
    "level2": (dict(level=2), BASE, 10),
    "level5": (dict(level=5), BASE, 10),
    "ANS1": (dict(transform="NONE", entropy="ANS1"), SHORT, 8),
    "RANGE": (dict(transform="LZ", entropy="RANGE"), SHORT, 8),
}


def outcome(decode):
    try:
        return "bytes", hashlib.sha256(decode()).hexdigest()
    except (JaxKanziError, KanziError) as e:
        return "KanziError", e.code


def mutants(blob: bytes, seed: int, n: int):
    """The recipe's mutants of `blob`: 1-3 byte XORs each."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(b)))
            b[i] ^= int(rng.integers(1, 256))
        yield bytes(b)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("checksum", [32, 0])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mutated_stream_outcomes_match(config, checksum, route):
    kw, data, n = CONFIGS[config]
    blob = kanzi_tpu.compress(data, block_size=65536, checksum=checksum, **kw)
    assert kt.compress(data, block_size=65536, checksum=checksum, device=route,
                       **kw) == blob
    good = ("bytes", hashlib.sha256(data).hexdigest())
    seed = 1000 * checksum + sorted(CONFIGS).index(config)
    for k, bad in enumerate(mutants(blob, seed, n)):
        jobs = 1 + 3 * (k & 1)
        want = outcome(lambda: kanzi_tpu.decompress(bad, jobs=jobs))
        got = outcome(lambda: kt.decompress(bad, jobs=jobs, device=route))
        assert got == want, (k, jobs)
        if checksum:
            assert got[0] == "KanziError" or got == good, (k, "silent corruption")


# -- targeted edits: chunk headers and block sizes --------------------------

def _frames(blob):
    """The bit position and bit length of each frame's payload."""
    from kanzi_tpu_torch.kio.compressed_stream import frame_table
    frames, _ = frame_table(blob)
    return [pos for pos, _ in frames]


def _flip_bits(blob: bytes, bit: int, mask: int, width: int = 8) -> bytes:
    """XOR `mask` (`width` bits, most significant first) into the stream at
    bit position `bit`."""
    b = bytearray(blob)
    for j in range(width):
        if mask >> (width - 1 - j) & 1:
            p = bit + j
            b[p >> 3] ^= 0x80 >> (p & 7)
    return bytes(b)


def edits(blob: bytes, checksum: int, seed: int, n: int):
    """Mutants aimed at the fields a decoder trusts: each block's
    pre-transform size (the bytes after the mode byte), and the first 48
    bytes of its entropy payload, where the first chunk's header sits
    (ANS: logRange in its first 3 bits, then the alphabet and frequencies;
    range: the frequency table; Huffman: the code lengths), and a chunk's
    stream-size varint after it."""
    rng = np.random.default_rng(seed)
    starts = _frames(blob)
    for k in range(n):
        pos = starts[int(rng.integers(0, len(starts)))]
        mode = blob[pos >> 3] if pos & 7 == 0 else \
            ((blob[pos >> 3] << 8 | blob[(pos >> 3) + 1]) >> (8 - (pos & 7))) & 0xFF
        size_bytes = 1 + ((mode >> 5) & 3)
        hdr = 8 + (8 if mode & 0x10 else 0)
        payload = pos + hdr + 8 * size_bytes + checksum
        if k % 3 == 0:                   # the block size field
            bit = pos + hdr + int(rng.integers(0, 8 * size_bytes))
            yield _flip_bits(blob, bit, 1, 1)
        elif k % 3 == 1:                 # logRange / first header bits
            yield _flip_bits(blob, payload, int(rng.integers(1, 8)), 3)
        else:                            # a byte of the chunk header
            bit = payload + 8 * int(rng.integers(0, 48))
            yield _flip_bits(blob, min(bit, 8 * len(blob) - 8), int(rng.integers(1, 256)))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("checksum", [32, 0])
@pytest.mark.parametrize("config", ["level2", "level5", "ANS1", "RANGE"])
def test_conformance_edits(config, checksum, route):
    kw, data, _ = CONFIGS[config]
    data = data[:12288] if config in ("level2", "level5") else data
    blob = kanzi_tpu.compress(data, block_size=4096, checksum=checksum, **kw)
    seed = 7 + 100 * checksum + sorted(CONFIGS).index(config)
    for k, bad in enumerate(edits(blob, checksum, seed, 9)):
        jobs = 1 + 3 * (k & 1)
        want = outcome(lambda: kanzi_tpu.decompress(bad, jobs=jobs))
        got = outcome(lambda: kt.decompress(bad, jobs=jobs, device=route))
        assert got == want, (k, jobs)
