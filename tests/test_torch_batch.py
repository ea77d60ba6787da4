"""The device Writer and Reader work `jobs` blocks at a time, on the CPU
(device="cpu": the kernels' plain versions) against kanzi_tpu: the streams
equal kanzi_tpu's byte for byte at jobs 1 and 4, the batched Reader
restores them, the Writer's transforms run on its pool, and one launch
(plain call here) decodes a batch: one for HUFFMAN, ANS0 and ANS1, one per
chunk index for RANGE. Blocks are small because the plain ANS and range
loops are slow on the CPU."""

import threading
import time

import numpy as np
import pytest

import kanzi_tpu
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.bitstream import BitReader
from kanzi_tpu_torch.core import ERR_CRC_CHECK, ERR_PROCESS_BLOCK, KanziError
from kanzi_tpu_torch.kio import Reader
from kanzi_tpu_torch.kio.compressed_stream import _parse_block_header
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


def test_ans1_batch_decodes_in_one_launch():
    data = _TEXT[:4 << 13]                           # four device blocks
    blob = kt.compress(data, transform="NONE", entropy="ANS1", block_size=1 << 13,
                       jobs=4, device="cpu")
    assert _count("ans_decode", blob, 4) == 1
    assert _count("ans_decode", blob, 1) == 4


def test_range_batch_launches_per_chunk_index():
    # transform NONE: each 64 KiB block is two 32 KiB range chunks, the last
    # one chunk; four blocks in the first batch, one in the second
    rng = np.random.default_rng(2)
    bs = 1 << 16
    data = np.frombuffer(b"abcdefgh", np.uint8)[rng.integers(0, 8, 4 * bs + 9000)].tobytes()
    blob = kt.compress(data, transform="NONE", entropy="RANGE", block_size=bs,
                       jobs=4, device="cpu")
    assert blob == kanzi_tpu.compress(data, transform="NONE", entropy="RANGE",
                                      block_size=bs)
    _kernels.reset_counts()
    assert kt.decompress(blob, jobs=4, device="cpu") == data
    # longest block's chunks per batch (2, then 1), not their sum (9)
    assert _kernels.plain_calls["range_decode"] == 3


def test_huffman_batch_decodes_in_one_launch():
    data = _data(8, 1 << 14)
    blob = kt.compress(data, level=2, block_size=1 << 14, jobs=4, device="cpu")
    assert _count("decode_lanes", blob, 4) == 2     # two batches of four
    assert _count("decode_lanes", blob, 1) > 2


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
