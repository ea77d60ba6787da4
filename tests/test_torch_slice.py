"""The PyTorch port's slice end to end against the JAX package: host prep
equals kanzi_tpu.native; Writer(device="cpu") streams equal kanzi_tpu's
host and device-engine streams; Reader(device="cpu") restores them; the
fused compress step equals kanzi_tpu's on a 1-device mesh; nothing falls
back silently."""

import io
import os

import numpy as np
import pytest
import torch

import kanzi_tpu
import kanzi_tpu_torch as kt
from torch_jax_native import jax_native
from kanzi_tpu import parallel as jax_parallel
from kanzi_tpu.kio import Writer as JaxWriter
from kanzi_tpu_torch import _kernels, native, parallel
from kanzi_tpu_torch.core import ERR_CRC_CHECK, ERR_PROCESS_BLOCK, KanziError
from kanzi_tpu_torch.entropy.huffman_device import DeviceHuffmanEngine
from kanzi_tpu_torch.kio import Reader, Writer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()


def _mixed(n: int, seed: int = 42) -> bytes:
    rng = np.random.default_rng(seed)
    parts = [_TEXT[: n // 2],
             rng.integers(0, 256, n // 8, dtype=np.uint8).tobytes(),
             np.zeros(n // 8, dtype=np.uint8).tobytes(),
             np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n // 8)].tobytes(),
             rng.integers(0, 4, n // 8, dtype=np.uint8).tobytes()]
    return b"".join(parts)[:n]


def _port_stream(data, device, **kw):
    w = Writer(None, file_size=len(data), device=device, **kw)
    if device is not None and kw.get("entropy") == "HUFFMAN":
        assert type(w._dev_engine) is DeviceHuffmanEngine
    w.write(data)
    w.close()
    return w.getvalue()


def _jax_device_stream(data, ctx=None, **kw):
    w = JaxWriter(None, file_size=len(data),
                  ctx=dict(ctx or {}, useDevice=True), **kw)
    assert w._dev_engine is not None
    w.write(data)
    w.close()
    return w.getvalue()


def test_host_prep_equals_reference():
    data = np.frombuffer(_mixed(200000), np.uint8)
    for a, b in zip(native.huffman_prepare(data), jax_native.huffman_prepare(data)):
        assert np.array_equal(a, b)
    chain = kt.transforms.get_type("TEXT+UTF+PACK+MM+LZX")
    ctx = {"bsVersion": 6, "entropy": "HUFFMAN", "blockSize": len(data)}
    dst1 = np.empty(2 * len(data) + 65536, np.uint8)
    dst2 = np.empty_like(dst1)
    r1 = native.block_transform(data, chain, 1, dict(ctx), 32, False, dst1)
    r2 = jax_native.block_transform(data, chain, 1, dict(ctx), 32, False, dst2)
    assert r1 == r2
    assert np.array_equal(dst1[: r1[0]], dst2[: r2[0]])


@pytest.mark.parametrize("transform,block_size,checksum,jobs,skip", [
    ("NONE", 1 << 17, 32, 1, False),
    ("DNA+LZ", 1 << 17, 32, 4, False),                  # level 2 chain
    ("TEXT+UTF+PACK+MM+LZX", 1 << 18, 64, 1, False),    # level 3 chain
    ("DNA+LZ", 1 << 16, 64, 1, True),                   # skipBlocks
])
def test_writer_reader_match_reference(transform, block_size, checksum, jobs, skip):
    data = _mixed(3 * block_size + 12345)   # multi-block + partial
    kw = dict(transform=transform, entropy="HUFFMAN", block_size=block_size,
              checksum=checksum, jobs=jobs)
    ctx = {"skipBlocks": True} if skip else None
    _kernels.reset_counts()
    port = _port_stream(data, "cpu", ctx=ctx, **kw)
    assert _kernels.plain_calls["pack_lanes"] > 0
    assert _kernels.launches["pack_lanes"] == 0
    host = kanzi_tpu.compress(data, skip=skip, **kw)
    assert port == host
    assert port == _jax_device_stream(data, ctx=ctx, **kw)
    assert port == _port_stream(data, None, ctx=ctx, **kw)

    r = Reader(port, device="cpu")
    assert r.read_all() == data
    assert _kernels.plain_calls["decode_lanes"] > 0
    assert kanzi_tpu.decompress(port) == data


@pytest.mark.parametrize("level", [2, 3, 5])
def test_levels_match_reference(level):
    data = _mixed(300000, seed=level)
    port = kt.compress(data, level=level, checksum=32, device="cpu")
    assert port == kanzi_tpu.compress(data, level=level, checksum=32)
    assert kt.decompress(port, device="cpu") == data


def test_tiny_and_copy_blocks():
    rng = np.random.default_rng(3)
    rand = rng.integers(0, 256, 200000, dtype=np.uint8).tobytes()
    for data in (b"tiny", rand, b""):
        kw = dict(transform="LZ", entropy="HUFFMAN", block_size=65536)
        ctx = {"skipBlocks": True}
        blob = _port_stream(data, "cpu", ctx=ctx, **kw)
        w2 = JaxWriter(None, file_size=len(data), ctx=ctx, **kw)
        w2.write(data)
        w2.close()
        assert blob == w2.getvalue()
        assert kt.decompress(blob, device="cpu") == data
        assert kanzi_tpu.decompress(blob) == data


def test_streaming_output_and_input():
    data = _mixed(150000)
    sink = io.BytesIO()
    w = Writer(sink, transform="DNA+LZ", entropy="HUFFMAN", block_size=1 << 16,
               checksum=32, device="cpu")
    w.write(data[:70000])
    w.write(data[70000:])
    w.close()
    blob = sink.getvalue()
    sink2 = io.BytesIO()
    w2 = JaxWriter(sink2, transform="DNA+LZ", entropy="HUFFMAN",
                   block_size=1 << 16, checksum=32)
    w2.write(data)
    w2.close()
    assert blob == sink2.getvalue()
    r = Reader(io.BytesIO(blob), device="cpu")
    out = b"".join(iter(lambda: r.read(50000), b""))
    assert out == data


@pytest.mark.parametrize("entropy", ["NONE", "FPAQ"])
def test_host_entropy_types_run_on_host_engine(entropy):
    data = _mixed(100000)
    blob = kt.compress(data, transform="LZ", entropy=entropy, block_size=1 << 16,
                       device="cpu")
    assert blob == kanzi_tpu.compress(data, transform="LZ", entropy=entropy,
                                      block_size=1 << 16)
    assert kt.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("level", [1, 6])
def test_host_codecs_decode_natively_in_parallel(level, monkeypatch):
    # entropy NONE (level 1) and FPAQ (level 6) have no device engine: with
    # a device set, the Reader still decodes them natively, `jobs` frames
    # at a time, as kanzi_tpu's default Reader does
    data = _mixed(300000)
    blob = kanzi_tpu.compress(data, level=level, block_size=1 << 16, jobs=4,
                              checksum=32)
    assert kt.compress(data, level=level, block_size=1 << 16, jobs=4, checksum=32,
                       device="cpu") == blob
    batches = []
    read_batch = Reader._read_batch_parallel
    monkeypatch.setattr(Reader, "_read_batch_parallel",
                        lambda self: batches.append(1) or read_batch(self))
    _kernels.reset_counts()
    assert kt.decompress(blob, jobs=4, device="cpu") == kanzi_tpu.decompress(blob, jobs=4)
    assert len(batches) >= 2
    assert sum(_kernels.plain_calls.values()) == 0


@pytest.mark.parametrize("entropy", ["ANS0", "ANS1", "RANGE"])
def test_pending_device_engines_raise(entropy):
    """ANS0, ANS1 and RANGE on device="cpu": the stream equals kanzi_tpu's
    host and device-engine streams and decodes, through the plain versions
    of the ANS or range kernels."""
    data = _mixed(40000)
    name = "range" if entropy == "RANGE" else "ans"
    _kernels.reset_counts()
    blob = kt.compress(data, transform="NONE", entropy=entropy, device="cpu")
    assert _kernels.plain_calls[f"{name}_encode"] == 1
    assert blob == kanzi_tpu.compress(data, transform="NONE", entropy=entropy)
    assert blob == _jax_device_stream(data, transform="NONE", entropy=entropy)
    assert blob == kt.compress(data, transform="NONE", entropy=entropy, device=None)
    assert kt.decompress(blob, device="cpu") == data
    assert _kernels.plain_calls[f"{name}_decode"] > 0
    assert sum(_kernels.launches.values()) == 0
    assert kt.decompress(blob, device=None) == data


@pytest.mark.parametrize("entropy,transform,block_size", [
    ("ANS0", "NONE", 1 << 18),
    ("ANS0", "TEXT+UTF+BWT+RANK+ZRLT", 1 << 18),   # level-5 chain
    ("ANS1", "NONE", 1 << 15),
    ("ANS1", "DNA+LZ", 1 << 15),
    ("RANGE", "LZ", 1 << 15),
])
def test_ans_range_writer_reader_match_reference(entropy, transform, block_size):
    # the cases of kanzi_tpu's tests/test_device_engine.py, with ANS1 and
    # RANGE blocks cut to 32 KiB to keep the plain loops short
    data = _mixed(2 * block_size + 7777, seed=7)
    kw = dict(transform=transform, entropy=entropy, block_size=block_size,
              checksum=32, jobs=2)
    w = Writer(None, file_size=len(data), device="cpu", **kw)
    assert type(w._dev_engine).__name__ == (
        "DeviceRangeEngine" if entropy == "RANGE" else "DeviceANSEngine")
    w.write(data)
    w.close()
    port = w.getvalue()
    assert port == kanzi_tpu.compress(data, **kw)
    assert port == _jax_device_stream(data, **kw)
    r = Reader(port, device="cpu")
    assert r.read_all() == data
    assert kanzi_tpu.decompress(port) == data


def _corrupt_huffman_block():
    data = _mixed(100000)
    blob = bytearray(kt.compress(data, transform="NONE", entropy="HUFFMAN",
                                 block_size=1 << 17, checksum=32, device=None))
    return data, blob


def test_corrupted_block_raises_without_host_fallback(monkeypatch):
    data, blob = _corrupt_huffman_block()
    from kanzi_tpu_torch.entropy import huffman as host_huffman

    def no_host(*_a, **_k):
        raise AssertionError("the host Huffman decoder ran on the device path")

    monkeypatch.setattr(host_huffman, "huffman_decode", no_host)
    monkeypatch.setattr(native, "entropy_decode", no_host)
    assert kt.decompress(bytes(blob), device="cpu") == data
    # a chunk header the device prepare rejects (err -5, -4), and lane
    # bytes whose decode fails the block checksum
    for pos, code in ((115, ERR_PROCESS_BLOCK), (22716, ERR_PROCESS_BLOCK),
                      (len(blob) // 2, ERR_CRC_CHECK)):
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        with pytest.raises(KanziError) as ei:
            kt.decompress(bytes(bad), device="cpu")
        assert ei.value.code == code, (pos, str(ei.value))


def test_compress_step_matches_reference_mesh():
    rng = np.random.default_rng(0)
    B, N = 2, 4096
    blocks = rng.integers(0, 64, (B, N), dtype=np.uint8)
    blocks[1] = rng.integers(0, 256, N, dtype=np.uint8)
    posts = [blocks[0], blocks[1]]
    _preps, (syms, lens, tidx, tables) = DeviceHuffmanEngine("cpu").lane_batch(posts)
    fn = jax_parallel.compress_step(jax_parallel.device_mesh(1))
    want = fn(blocks, syms.astype(np.int32), lens, tidx, tables.astype(np.int32))
    got = parallel.compress_step(blocks, syms, lens, tidx, tables, device="cpu")
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))           # histos
    assert np.abs(got[1].numpy().astype(np.int64) - np.asarray(want[1])).max() <= 1
    assert np.array_equal(got[2].numpy().view(np.uint32), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) == int(got[3].sum())


def test_listeners_need_the_host_path():
    w = Writer(None, entropy="HUFFMAN", device="cpu")
    with pytest.raises(KanziError):
        w.add_listener(object())
    assert Writer(None, entropy="HUFFMAN", device=None).add_listener(object())


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    data = _mixed(20000)
    blob = kt.compress(data, level=2, device=None)
    for call in (lambda: kt.compress(data, level=2),
                 lambda: kt.decompress(blob),
                 lambda: Writer(None, entropy="HUFFMAN"),
                 lambda: Writer(None, entropy="ANS1"),
                 lambda: kt.compress(data, entropy="RANGE"),
                 lambda: Reader(blob),
                 lambda: kt.entry(),
                 lambda: parallel.compress_step(
                     np.zeros((1, 16), np.uint8), np.zeros((4, 16), np.uint8),
                     np.zeros(4, np.int32), np.zeros(4, np.int32),
                     np.zeros((1, 256), np.int32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_is_a_full_width_pack_step():
    fn, args = kt.entry(device="cpu")
    words, nbits = fn(*args)
    assert args[0].shape == (8, 4096)
    assert words.shape == (8, 1538) and (nbits.numpy() == 8 * 4096).all()

