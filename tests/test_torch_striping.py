"""The port's host striping against kanzi_tpu's: compress_multiproc,
decompress_multiproc and the multi-host library and launcher give the
streams and outputs of kanzi_tpu's and of the port's own Writer and
Reader; stripes pack, unpack and assemble across the two packages."""

import os
import subprocess
import sys

import numpy as np
import pytest

import kanzi_tpu
import kanzi_tpu_torch as kt
from kanzi_tpu.parallel import multihost as ref_multihost
from kanzi_tpu.parallel.multiproc import compress_multiproc as ref_compress_multiproc
from kanzi_tpu_torch.parallel import (compress_multiproc, decompress_multiproc,
                                      multihost)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 65536


def _corpus(n: int) -> bytes:
    rng = np.random.default_rng(0x4057)
    with open(os.path.join(ROOT, "tests", "fixtures", "golden_corpus.bin"), "rb") as fh:
        text = fh.read()
    arr = np.frombuffer((text * (n // len(text) + 1))[:n], np.uint8).copy()
    idx = rng.integers(0, n, n // 200)
    arr[idx] = rng.integers(0, 256, len(idx), dtype=np.uint8)
    return arr.tobytes()


def test_multiproc_matches_reference_and_writer():
    data = _corpus(BLOCK * 4 + 12345)   # 5 blocks over 3 processes
    kw = dict(transform="TEXT+UTF+BWT+RANK+ZRLT", entropy="ANS0", checksum=32)
    multi = compress_multiproc(data, block_size=BLOCK, procs=3, **kw)
    assert multi == ref_compress_multiproc(data, block_size=BLOCK, procs=3, **kw)
    assert multi == kt.compress(data, block_size=BLOCK, device=None, **kw)
    assert multi == kt.compress(data, block_size=BLOCK, device="cpu", jobs=4, **kw)
    out = decompress_multiproc(multi, procs=2)
    assert out == data == kanzi_tpu.decompress(multi)


def test_multiproc_edge_sizes():
    for n in (0, 16385):
        data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
        multi = compress_multiproc(data, transform="LZ", entropy="NONE",
                                   block_size=16384, procs=2)
        assert multi == kanzi_tpu.compress(data, transform="LZ", entropy="NONE",
                                           block_size=16384)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("cfg", [
    dict(transform="LZ", entropy="HUFFMAN", checksum=32),
    dict(transform="TEXT+UTF+BWT+RANK+ZRLT", entropy="ANS0", checksum=0),
    dict(transform="ROLZ", entropy="CM", checksum=64),
])
def test_multihost_matches_reference(world, cfg):
    data = _corpus(BLOCK * 4 + 999)   # 5 blocks
    striped = multihost.compress_multihost(data, world=world, block_size=BLOCK, **cfg)
    assert striped == ref_multihost.compress_multihost(data, world=world,
                                                       block_size=BLOCK, **cfg)
    assert striped == kt.compress(data, block_size=BLOCK, device=None, **cfg)
    assert multihost.decompress_multihost(striped, world=world) == data
    assert [multihost.decode_stripe(striped, r, world) for r in range(world)] == \
        [ref_multihost.decode_stripe(striped, r, world) for r in range(world)]


def test_stripes_assemble_across_packages():
    data = _corpus(BLOCK * 4 + 999)
    cfg = dict(transform="LZ", entropy="HUFFMAN", block_size=BLOCK, checksum=32)
    single = kanzi_tpu.compress(data, **cfg)
    spans = [multihost.stripe_range(len(data), BLOCK, r, 2) for r in range(2)]
    assert spans == [ref_multihost.stripe_range(len(data), BLOCK, r, 2) for r in range(2)]
    (s0, e0), (s1, e1) = spans
    # rank 0 packed by kanzi_tpu, rank 1 by the port
    ref_stripe = ref_multihost.pack_stripe(
        ref_multihost.encode_stripe(data[s0:e0], "LZ", "HUFFMAN", BLOCK, 32),
        "LZ", "HUFFMAN", BLOCK, 32)
    port_stripe = multihost.pack_stripe(
        multihost.encode_stripe(data[s1:e1], "LZ", "HUFFMAN", BLOCK, 32),
        "LZ", "HUFFMAN", BLOCK, 32)
    assert port_stripe == ref_multihost.pack_stripe(
        ref_multihost.encode_stripe(data[s1:e1], "LZ", "HUFFMAN", BLOCK, 32),
        "LZ", "HUFFMAN", BLOCK, 32)
    stripes = [ref_stripe, port_stripe]
    assert multihost.assemble(stripes, "LZ", "HUFFMAN", BLOCK, len(data), 32) == single
    assert ref_multihost.assemble(stripes, "LZ", "HUFFMAN", BLOCK, len(data), 32) == single
    assert multihost.unpack_stripe(ref_stripe) == ref_multihost.unpack_stripe(ref_stripe)
    with pytest.raises(ValueError, match="assemble invoked"):
        multihost.assemble(stripes, "LZ", "NONE", BLOCK, len(data), 32)
    with pytest.raises(ValueError):
        multihost.unpack_stripe(b"XXXX\x00\x00\x00\x00")


def test_multihost_launcher_cli(tmp_path):
    """Worker-mode subprocesses per rank (rank and world from KANZI_RANK and
    KANZI_WORLD), then --assemble; then the decode striping the same way."""
    data = _corpus(BLOCK * 4 + 999)
    single = kanzi_tpu.compress(data, transform="LZ", entropy="HUFFMAN",
                                block_size=BLOCK, checksum=32)
    inp, out, back = tmp_path / "in.bin", tmp_path / "out.knz", tmp_path / "back.bin"
    inp.write_bytes(data)
    base = [sys.executable, "-m", "kanzi_tpu_torch.parallel.multihost"]
    args = [*base, "-i", str(inp), "-o", str(out), "--transform", "LZ", "--entropy",
            "HUFFMAN", "--block-size", str(BLOCK), "--checksum", "32"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(args, env=dict(env, KANZI_RANK=str(r), KANZI_WORLD="2"),
                              cwd=ROOT) for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert subprocess.run(args + ["--assemble", "--world", "2"], env=env, cwd=ROOT,
                          timeout=120).returncode == 0
    assert out.read_bytes() == single
    dargs = [*base, "-d", "-i", str(out), "-o", str(back)]
    procs = [subprocess.Popen(dargs + ["--rank", str(r), "--world", "2"], env=env,
                              cwd=ROOT) for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert subprocess.run(dargs + ["--assemble", "--world", "2"], env=env, cwd=ROOT,
                          timeout=120).returncode == 0
    assert back.read_bytes() == data
