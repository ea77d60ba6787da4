"""The port's stream API and frame table against kanzi_tpu's:
compress_stream/decompress_stream give kanzi_tpu's streams and outputs with
writes and reads below and above a batch (`jobs * block_size`), a device
Writer on a sink gives the bytes it gives with output=None, and
kio.frame_table walks a stream as kanzi_tpu's does."""

import io
import os

import numpy as np
import pytest
import torch

import kanzi_tpu
import kanzi_tpu_torch as kt
from kanzi_tpu.kio import frame_table as ref_frame_table
from kanzi_tpu_torch import _kernels
from kanzi_tpu_torch.kio import Writer, frame_table
from kanzi_tpu_torch.kio.compressed_stream import device_batch_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()


def _mixed(n: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    parts = [_TEXT, rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes(),
             np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n // 4)].tobytes(),
             rng.integers(0, 4, n // 2, dtype=np.uint8).tobytes()]
    return b"".join(parts)[:n]


class Source(io.BytesIO):
    """A file-like source that records the size of every read."""

    def __init__(self, data):
        super().__init__(data)
        self.reads = []

    def read(self, n=-1):
        self.reads.append(n)
        return super().read(n)


# chunk sizes below a batch (4 blocks of 16 KiB), of a batch, and above it
@pytest.mark.parametrize("chunk", [5000, 4 * 16384, 2 * 4 * 16384 + 11])
@pytest.mark.parametrize("device", ["cpu", None])
def test_stream_api_matches_reference(chunk, device):
    data = _mixed(120000)
    for kw in (dict(level=2, block_size=16384), dict(level=5, block_size=16384),
               dict(transform="LZ", entropy="HUFFMAN", block_size=16384,
                    checksum=32)):
        want = io.BytesIO()
        n = kanzi_tpu.compress_stream(io.BytesIO(data), want, jobs=4,
                                      chunk_size=chunk, **kw)
        got = io.BytesIO()
        assert kt.compress_stream(io.BytesIO(data), got, jobs=4, chunk_size=chunk,
                                  device=device, **kw) == n == len(data)
        assert got.getvalue() == want.getvalue(), kw
        out, ref_out = io.BytesIO(), io.BytesIO()
        assert kanzi_tpu.decompress_stream(io.BytesIO(want.getvalue()), ref_out,
                                           jobs=4, chunk_size=chunk) == len(data)
        assert kt.decompress_stream(io.BytesIO(got.getvalue()), out, jobs=4,
                                    chunk_size=chunk, device=device) == len(data)
        assert out.getvalue() == ref_out.getvalue() == data


def test_device_writer_on_a_sink_matches_one_shot():
    """Writes smaller than a batch top up the pending batch; the stream goes
    to the sink at close(), equal to the one-shot (output=None) bytes."""
    data = _mixed(200000, seed=4)
    kw = dict(transform="DNA+LZ", entropy="HUFFMAN", block_size=16384, jobs=4,
              checksum=32, device="cpu")
    one = Writer(None, **kw)
    one.write(data)
    one.close()
    sink = io.BytesIO()
    w = Writer(sink, **kw)
    for i in range(0, len(data), 7000):
        w.write(data[i:i + 7000])
    w.close()
    assert sink.getvalue() == one.getvalue()


def test_decompress_stream_reads_the_source_in_refills():
    """decompress_stream on a device Reader reads a file source in 1 MiB
    pieces, decodes a wide batch of blocks a launch (device_batch_frames)
    and writes at most chunk_size a write."""
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 3 << 19, dtype=np.uint8).tobytes()   # 1.5 MiB
    blob = kt.compress(data, level=2, block_size=1 << 16, device=None)
    assert len(blob) > 1 << 20
    src, dst = Source(blob), io.BytesIO()
    writes = []
    dst.write = lambda b, _w=dst.write: writes.append(len(b)) or _w(b)
    _kernels.reset_counts()
    assert kt.decompress_stream(src, dst, jobs=4, device="cpu") == len(data)
    assert dst.getvalue() == data
    assert set(src.reads) == {1 << 20}
    assert max(writes) == 1 << 20
    # 24 blocks, a wide batch of 16 and one of 8: one plain decode a batch
    assert device_batch_frames(torch.device("cpu"), 1 << 16, 4) == 16
    assert _kernels.plain_calls["decode_lanes"] == 2


@pytest.mark.parametrize("kw", [dict(level=2, checksum=64),
                                dict(level=0),
                                dict(transform="BWT", entropy="ANS1", checksum=32)])
def test_frame_table_matches_reference(kw):
    data = _mixed(150000, seed=5)
    blob = kanzi_tpu.compress(data, block_size=16384, **kw)
    frames, r = frame_table(blob)
    want, ref = ref_frame_table(blob)
    assert frames == want and len(frames) == 10
    for attr in ("transform_type", "entropy_type", "checksum_bits", "block_size",
                 "outputSize"):
        assert getattr(r, attr) == getattr(ref, attr), attr
    assert r.device is None
    assert {k: r.ctx[k] for k in ("transform", "entropy", "blockSize", "bsVersion")} \
        == {k: ref.ctx[k] for k in ("transform", "entropy", "blockSize", "bsVersion")}
