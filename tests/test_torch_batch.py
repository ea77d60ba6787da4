"""The device Writer and Reader work `jobs` blocks at a time, on the CPU
(device="cpu": the kernels' plain versions) against kanzi_tpu: the streams
equal kanzi_tpu's byte for byte at jobs 1 and 4, the batched Reader
restores them, the Writer's transforms run on its pool, and one launch
(plain call here) decodes a batch: one for HUFFMAN, ANS0 and ANS1, one per
chunk index for RANGE. Blocks are small because the plain ANS and range
loops are slow on the CPU."""

import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kanzi_tpu
from kanzi_tpu.core import KanziError as JaxKanziError
from kanzi_tpu.kio import Reader as JaxReader
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch._kernels import PLAIN_SMS
from kanzi_tpu_torch.bitstream import BitReader
from kanzi_tpu_torch.core import ERR_CRC_CHECK, ERR_PROCESS_BLOCK, KanziError
from kanzi_tpu_torch.kio import Reader
from kanzi_tpu_torch.kio.compressed_stream import _parse_block_header, device_batch_frames
from torch_jax_native import jax_native  # noqa: F401  (builds kanzi_tpu's library once)

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _fh:
    _TEXT = _fh.read()


def _data(nblocks: int, bs: int, seed: int = 5) -> bytes:
    """nblocks - 1 full blocks and a partial one: text, DNA, sparse zeros,
    and one block of random bytes (a copy-mode block under skipBlocks)."""
    rng = np.random.default_rng(seed)
    parts = [_TEXT[:bs],
             rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),
             np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, bs)].tobytes(),
             np.where(rng.random(bs) < 0.02, 7, 0).astype(np.uint8).tobytes()]
    body = b"".join(parts[i % 4] for i in range(nblocks))
    return body[:nblocks * bs - bs // 3]


# (stream parameters, block size, blocks): small blocks, several per batch
_CASES = {
    "level2": (dict(level=2), 1 << 15, 6),
    "level3": (dict(level=3), 1 << 15, 6),
    "level5": (dict(level=5), 1 << 15, 6),
    "ANS1": (dict(transform="NONE", entropy="ANS1"), 1 << 13, 6),
    "RANGE": (dict(transform="LZ", entropy="RANGE"), 1 << 15, 5),
}


def _compress(name, jobs, device="cpu"):
    kw, bs, nblocks = _CASES[name]
    data = _data(nblocks, bs)
    kw = dict(kw, block_size=bs, jobs=jobs, checksum=32, skip=True)
    if device == "jax":
        return data, kanzi_tpu.compress(data, **kw)
    return data, kt.compress(data, device=device, **kw)


def _frames(blob):
    """The stream's Reader and its [(payload, bit position, bit length,
    block id)]."""
    r = Reader(blob, jobs=64, device="cpu")
    r._read_header()
    out = []
    for pos, bits, block_id in r._read_frames()[0]:
        br = BitReader(r._src)
        br._pos = pos
        out.append((br.read_array(bits), pos, bits, block_id))
    return r, out


def _no_single(*_a):
    raise AssertionError("the per-block path ran at jobs=4")


@pytest.mark.parametrize("jobs", [1, 4])
@pytest.mark.parametrize("name", list(_CASES))
def test_device_writer_streams_match_reference(name, jobs):
    data, blob = _compress(name, jobs)
    assert blob == _compress(name, jobs, device="jax")[1]
    assert blob == _compress(name, jobs, device=None)[1]
    r, frames = _frames(blob)
    heads = [_parse_block_header(p, r.transform_type, r.entropy_type, r.block_size, 32)
             for p, *_ in frames]
    # the batch mixes a copy-mode block (entropy NONE) with device blocks
    assert len(frames) == _CASES[name][2] and len(data) % _CASES[name][1]
    assert any(h[1] == 0 for h in heads) and any(h[1] != 0 for h in heads)


@pytest.mark.parametrize("name", list(_CASES))
def test_batched_reader_restores_the_input(name, monkeypatch):
    data, blob = _compress(name, 4)
    monkeypatch.setattr(Reader, "_read_next_block", _no_single)
    _kernels.reset_counts()
    assert kt.decompress(blob, jobs=4, device="cpu") == data
    assert sum(_kernels.launches.values()) == 0
    assert kanzi_tpu.decompress(blob, jobs=4) == data


def test_writer_transforms_on_the_pool(monkeypatch):
    threads = set()
    transform = native.block_transform

    def spy(*a):
        threads.add(threading.get_ident())
        time.sleep(0.02)        # keep a worker busy while the batch is handed out
        return transform(*a)

    monkeypatch.setattr(native, "block_transform", spy)
    data = _data(8, 1 << 14)
    blob = kt.compress(data, level=2, block_size=1 << 14, jobs=4, device="cpu")
    assert len(threads) > 1
    assert blob == kanzi_tpu.compress(data, level=2, block_size=1 << 14, jobs=4)
    threads.clear()
    kt.compress(data, level=2, block_size=1 << 14, jobs=1, device="cpu")
    assert threads == {threading.get_ident()}


def _count(kernel, blob, jobs):
    _kernels.reset_counts()
    kt.decompress(blob, jobs=jobs, device="cpu")
    return _kernels.plain_calls[kernel]


# frames a wide batch of the "cpu" route holds at jobs=4 and small blocks
_WIDE = device_batch_frames(torch.device("cpu"), 1 << 11, 4)


def test_ans1_batch_decodes_in_one_launch():
    # a wide batch, then a second one of four blocks
    data = _TEXT[:(_WIDE + 4) << 11]
    assert len(data) == (_WIDE + 4) << 11
    blob = kt.compress(data, transform="NONE", entropy="ANS1", block_size=1 << 11,
                       jobs=4, device=None)
    assert _count("ans_decode", blob, 4) == 2
    assert _count("ans_decode", blob, 1) == _WIDE + 4


def test_range_batch_launches_per_chunk_index():
    # transform NONE: each 33 KiB block is two range chunks (32 KiB and 1
    # KiB), the last block one chunk of 500 bytes; a wide batch of full
    # blocks, then a second one of the last block alone
    rng = np.random.default_rng(2)
    bs = 33 << 10
    data = np.frombuffer(b"abcdefgh", np.uint8)[
        rng.integers(0, 8, _WIDE * bs + 500)].tobytes()
    blob = kt.compress(data, transform="NONE", entropy="RANGE", block_size=bs,
                       jobs=4, device=None)
    assert blob == kanzi_tpu.compress(data, transform="NONE", entropy="RANGE",
                                      block_size=bs)
    assert device_batch_frames(torch.device("cpu"), bs, 4) == _WIDE
    _kernels.reset_counts()
    assert kt.decompress(blob, jobs=4, device="cpu") == data
    # the longest block's chunks a wide batch (2, then 1), not a sum over
    # batches of `jobs` blocks (2 a batch, 9)
    assert _kernels.plain_calls["range_decode"] == 3


def test_huffman_batch_decodes_in_one_launch():
    data = _data(_WIDE + 4, 1 << 14)
    blob = kt.compress(data, level=2, block_size=1 << 14, jobs=4, device=None)
    assert _count("decode_lanes", blob, 4) == 2     # two wide batches
    assert _count("decode_lanes", blob, 1) > 2


@pytest.mark.parametrize("entropy", ["RANGE", "ANS1", "HUFFMAN"])
def test_wide_batch_spans_more_than_jobs_blocks(entropy):
    """Nine blocks at jobs=4 decode in one wide batch: one launch (plain
    call here), or the longest block's chunk count for RANGE (two: 33 KiB
    blocks, the last one shorter)."""
    kernel, bs = {"RANGE": ("range_decode", 33 << 10), "ANS1": ("ans_decode", 1 << 12),
                  "HUFFMAN": ("decode_lanes", 1 << 12)}[entropy]
    rng = np.random.default_rng(8)
    data = np.frombuffer(b"abcdefgh", np.uint8)[rng.integers(0, 8, 8 * bs + 700)].tobytes()
    blob = kt.compress(data, transform="NONE", entropy=entropy, block_size=bs,
                       checksum=32, jobs=4, device=None)
    assert device_batch_frames(torch.device("cpu"), bs, 4) >= 9
    _kernels.reset_counts()
    assert kt.decompress(blob, jobs=4, device="cpu") == data
    assert _kernels.plain_calls[kernel] == (2 if entropy == "RANGE" else 1)


@pytest.mark.parametrize("cuda_sms,block_size,jobs,want", [
    (None, 4 << 20, 4, PLAIN_SMS), (None, 4 << 20, 3, PLAIN_SMS - PLAIN_SMS % 3),
    (None, 64 << 20, 2, 4), (None, 1 << 10, 64, 64), (132, 4 << 20, 4, 64),
    (132, 1 << 20, 4, 132), (132, 1 << 20, 8, 128), (132, 256 << 20, 4, 4)])
def test_device_batch_frames_rule(cuda_sms, block_size, jobs, want, monkeypatch):
    """A wide batch is one wave of chains (the SM count, PLAIN_SMS on the
    CPU), at most 256 MiB of decoded blocks, a multiple of `jobs` and at
    least `jobs`."""
    device = torch.device("cpu")
    if cuda_sms is not None:
        device = torch.device("cuda", 0)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d: SimpleNamespace(multi_processor_count=cuda_sms))
    assert device_batch_frames(device, block_size, jobs) == want


def _read_until_error(reader, n=3000):
    """What a read(n) loop returns before it stops: (bytes, None) at the
    end, or (bytes, (code, block id in the message or None)) where it
    raises."""
    out = bytearray()
    try:
        while True:
            chunk = reader.read(n)
            if not chunk:
                return bytes(out), None
            out += chunk
    except (KanziError, JaxKanziError) as e:
        m = re.search(r"[Bb]lock (\d+)", e.msg)
        return bytes(out), (e.code, m and int(m.group(1)))


def _mutant(case):
    """Ten 4 KiB HUFFMAN blocks with checksums, broken as `case` says:
    block 6 corrupt (inside the wide batch, the second group of four);
    block 2 corrupt and the stream cut inside frame 9's header; the stream
    cut inside frame 9's header alone."""
    rng = np.random.default_rng(11)
    data = np.frombuffer(b"abcdefgh", np.uint8)[rng.integers(0, 8, 10 << 12)].tobytes()
    blob = kt.compress(data, transform="NONE", entropy="HUFFMAN", block_size=1 << 12,
                       checksum=32, jobs=4, device=None)
    _, frames = _frames(blob)
    bad = bytearray(blob)
    for i in {"corrupt": [5], "corrupt_and_cut": [1], "cut": []}[case]:
        _, pos, bits, _ = frames[i]
        bad[(pos + bits // 2) >> 3] ^= 0xFF
    if case != "corrupt":
        bad = bad[:(frames[8][1] - 1) >> 3]
    return bytes(bad)


@pytest.mark.parametrize("case", ["corrupt", "corrupt_and_cut", "cut"])
@pytest.mark.parametrize("jobs", [1, 4])
def test_wide_batch_fails_where_a_jobs_batch_fails(jobs, case):
    """The wide batch's outcome is the `jobs`-frame batch's, as kanzi_tpu
    has it at the same `jobs`: the bytes a read(n) loop returns before the
    error, the error's code and the block it names; a frame read's error
    met while reading ahead comes out after the groups before its own."""
    bad = _mutant(case)
    want = _read_until_error(JaxReader(bad, jobs=jobs))
    got = _read_until_error(Reader(bad, jobs=jobs, device="cpu"))
    assert got == want
    assert got[1] is not None
    if jobs == 4:       # the groups before the failing one came out, read 3000 at a time
        out = {"corrupt": 4, "corrupt_and_cut": 0, "cut": 8}[case] << 12
        assert len(got[0]) == out - out % 3000


@pytest.mark.parametrize("entropy", ["HUFFMAN", "ANS0"])
def test_corrupted_middle_block_names_its_block(entropy, monkeypatch):
    data = _data(4, 1 << 14, seed=4)[:4 << 14]
    blob = kt.compress(data, transform="NONE", entropy=entropy, block_size=1 << 14,
                       checksum=32, jobs=4, device="cpu")
    _, frames = _frames(blob)
    _, pos, bits, block_id = frames[2]
    bad = bytearray(blob)
    bad[(pos + bits // 2) >> 3] ^= 0xFF          # inside block 3's payload
    with pytest.raises(KanziError) as serial:
        kt.decompress(bytes(bad), jobs=1, device="cpu")
    monkeypatch.setattr(Reader, "_read_next_block", _no_single)
    with pytest.raises(KanziError) as batched:
        kt.decompress(bytes(bad), jobs=4, device="cpu")
    assert batched.value.code == serial.value.code
    assert batched.value.code in (ERR_CRC_CHECK, ERR_PROCESS_BLOCK)
    assert batched.value.msg.startswith(f"Block {block_id}:")


def test_from_to_skip_the_same_blocks():
    _, blob = _compress("level2", 4)
    for ctx in ({"from": 2, "to": 5}, {"from": 4}, {"to": 2}):
        want = kanzi_tpu.decompress(blob, jobs=4, ctx=dict(ctx))
        assert kt.decompress(blob, jobs=4, ctx=dict(ctx), device="cpu") == want
