"""The port's mesh (kanzi_tpu_torch.parallel) on the CPU against kanzi_tpu's.

The port runs on device_mesh(4, device="cpu") (and a 3-device mesh for
uneven shares): the kernels' plain versions, one call a shard with rows.
kanzi_tpu runs on its forced 8-device CPU mesh (tests/conftest.py), cut to
4. Streams must equal kanzi_tpu.compress (and, for HUFFMAN and ANS,
kanzi_tpu's own mesh stream) byte for byte and decode through the mesh's
hooks; compress_step's outputs and reduced total must equal kanzi_tpu's.
Sizes are small because the plain ANS and range loops are slow on the CPU.
"""

import numpy as np
import pytest
import torch

import kanzi_tpu
import kanzi_tpu_torch as kt
from kanzi_tpu import parallel as jax_parallel
from kanzi_tpu_torch import _kernels, native, parallel
from kanzi_tpu_torch.core import ERR_PROCESS_BLOCK, KanziError
from kanzi_tpu_torch.entropy import huffman as host_huffman
from kanzi_tpu_torch.entropy.huffman_device import DeviceHuffmanEngine
from kanzi_tpu_torch.kio import Reader
from torch_jax_native import jax_native  # noqa: F401  (builds kanzi_tpu's library once)

with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _fh:
    _TEXT = _fh.read()


def _corpus(n: int, seed: int = 3) -> bytes:
    """Text, random bytes, 3-bit symbols and zeros in turns."""
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n:
        for p in (_TEXT[:6000], rng.integers(0, 256, 2048, dtype=np.uint8).tobytes(),
                  rng.integers(0, 8, 4096, dtype=np.uint8).tobytes(), bytes(1024)):
            parts.append(p)
            size += len(p)
    return b"".join(parts)[:n]


# label -> (transform, entropy, checksum, bytes, block size, kernels the
# encode and decode call, compared with kanzi_tpu's mesh)
_CONFIGS = {
    "L1": ("LZX", "NONE", 32, 512 << 10, 1 << 16, (), False),
    "huffman-mesh": ("LZ", "HUFFMAN", 32, 512 << 10, 1 << 16,
                     ("pack_lanes", "decode_lanes"), True),
    "ans0-mesh": ("NONE", "ANS0", 32, 24 << 10, 6 << 10,
                  ("ans_encode", "ans_decode"), True),
    "ans1-mesh": ("NONE", "ANS1", 32, 64 << 10, 16 << 10,
                  ("ans_encode", "ans_decode"), True),
    "L5": ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", 64, 24 << 10, 6 << 10,
           ("ans_encode", "ans_decode"), True),
    "L8": ("EXE+RLT+TEXT+UTF+DNA", "TPAQ", 32, 512 << 10, 1 << 16, (), False),
    "range-mesh": ("LZ", "RANGE", 32, 32 << 10, 8 << 10, ("range_encode",), False),
}


def _nonempty(mesh, rows: int) -> int:
    return sum(hi > lo for lo, hi in mesh.shares(rows))


@pytest.fixture
def launches(monkeypatch):
    """The row count of every sharded launch, in order."""
    rows = []
    real = parallel._launch_rows

    def spy(mesh, streams, row_arrays, tables, kernel):
        rows.append(len(next(iter(row_arrays.values()))))
        return real(mesh, streams, row_arrays, tables, kernel)

    monkeypatch.setattr(parallel, "_launch_rows", spy)
    return rows


def _run_mesh(mesh, label, launches):
    """compress_multichip and decompress_multichip of one config: the
    stream and, per direction, (plain calls, sharded launches' rows)."""
    transform, entropy, cksum, n, bs, kernels, _ = _CONFIGS[label]
    data = _corpus(n)
    kw = dict(transform=transform, entropy=entropy, block_size=bs, checksum=cksum)
    _kernels.reset_counts()
    blob = parallel.compress_multichip(data, mesh, **kw)
    enc = (dict(_kernels.plain_calls), list(launches))
    launches.clear()
    _kernels.reset_counts()
    assert parallel.decompress_multichip(blob, mesh) == data
    dec = (dict(_kernels.plain_calls), list(launches))
    return data, kw, blob, enc, dec


@pytest.mark.parametrize("label", list(_CONFIGS))
def test_mesh_streams_match_reference(label, launches):
    mesh = parallel.device_mesh(4, device="cpu")
    data, kw, blob, enc, dec = _run_mesh(mesh, label, launches)
    assert blob == kanzi_tpu.compress(data, **kw)
    assert kt.decompress(blob, device=None) == data
    kernels, vs_jax_mesh = _CONFIGS[label][5:]
    if vs_jax_mesh:
        assert blob == jax_parallel.compress_multichip(data, jax_parallel.device_mesh(4), **kw)
    nblocks = -(-len(data) // kw["block_size"])
    if not kernels:          # the host C++ engine: no device launch
        assert sum(enc[0].values()) == sum(dec[0].values()) == 0
        assert enc[1] == dec[1] == []
        return
    # one sharded launch a batch of `jobs` = 4 blocks, and one plain call a
    # shard with rows
    assert len(enc[1]) == -(-nblocks // mesh.size)
    assert enc[0][kernels[0]] == sum(_nonempty(mesh, r) for r in enc[1])
    if len(kernels) > 1:
        assert len(dec[1]) == -(-nblocks // mesh.size)
        assert dec[0][kernels[1]] == sum(_nonempty(mesh, r) for r in dec[1])
    else:                    # RANGE decodes on the mesh's first device
        assert dec[1] == [] and dec[0]["range_decode"] > 0


@pytest.mark.parametrize("label", ["huffman-mesh", "ans0-mesh", "range-mesh"])
def test_uneven_mesh_shares(label, launches):
    """Three devices: shares of ceil(rows / 3), the last ones short or
    empty; an empty share launches nothing."""
    mesh = parallel.device_mesh(3, device="cpu")
    assert mesh.shares(4) == [(0, 2), (2, 4), (4, 4)]
    assert mesh.shares(7) == [(0, 3), (3, 6), (6, 7)]
    data, kw, blob, enc, dec = _run_mesh(mesh, label, launches)
    assert blob == kanzi_tpu.compress(data, **kw)
    kernels = _CONFIGS[label][5]
    assert enc[0][kernels[0]] == sum(_nonempty(mesh, r) for r in enc[1])
    if len(kernels) > 1:
        assert dec[0][kernels[1]] == sum(_nonempty(mesh, r) for r in dec[1])
    if label == "range-mesh":   # 3 batches of 3 blocks, one chunk each: 3 rows
        assert enc[1] == [3, 1] and enc[0]["range_encode"] == 4


def test_compress_step_matches_reference_mesh():
    rng = np.random.default_rng(0)
    B, N = 4, 4096
    blocks = rng.integers(0, 64, (B, N), dtype=np.uint8)
    blocks[1] = rng.integers(0, 256, N, dtype=np.uint8)
    blocks[3] = 0
    _preps, (syms, lens, tidx, tables) = DeviceHuffmanEngine("cpu").lane_batch(list(blocks))
    fn = jax_parallel.compress_step(jax_parallel.device_mesh(4))
    want = fn(blocks, syms.astype(np.int32), lens, tidx, tables.astype(np.int32))
    mesh = parallel.device_mesh(4, device="cpu")
    _kernels.reset_counts()
    got = parallel.compress_step(blocks, syms, lens, tidx, tables, mesh=mesh)
    # one block-stats call and one lane-pack call a shard
    assert _kernels.plain_calls["block_stats"] == _kernels.plain_calls["pack_lanes"] == 4
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))           # histos
    assert np.abs(got[1].numpy().astype(np.int64) - np.asarray(want[1])).max() <= 1
    assert np.array_equal(got[2].numpy().view(np.uint32), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) == int(got[3].sum())
    assert got[4].dtype == torch.int64
    # the mesh gathers what one device computes, on 3 devices too
    one = parallel.compress_step(blocks, syms, lens, tidx, tables, device="cpu")
    three = parallel.compress_step(blocks, syms, lens, tidx, tables,
                                   mesh=parallel.device_mesh(3, device="cpu"))
    for a, b, c in zip(got, one, three):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_compress_step_mesh_rejects_bad_input():
    mesh = parallel.device_mesh(2, device="cpu")
    blocks = np.zeros((2, 64), np.uint8)
    syms = np.zeros((8, 16), np.uint8)
    lens = np.full(8, 16, np.int32)
    tables = np.full((1, 256), 8 << 12, np.int32)
    with pytest.raises(ValueError, match="table_idx"):
        parallel.compress_step(blocks, syms, lens, np.full(8, 1, np.int32), tables,
                               mesh=mesh)
    with pytest.raises(TypeError, match="numpy"):
        parallel.compress_step(torch.from_numpy(blocks), syms, lens,
                               np.zeros(8, np.int32), tables, mesh=mesh)


def test_mesh_readers_are_reentrant():
    """Two mesh Readers decoding interleaved in one process do not
    interfere: the hooks are per-Reader state, each with its own streams."""
    mesh = parallel.device_mesh(4, device="cpu")
    d1 = _corpus(24 << 10, seed=1)
    d2 = bytes(reversed(_corpus(200 << 10, seed=2)))
    b1 = kanzi_tpu.compress(d1, transform="LZ", entropy="ANS0", block_size=6 << 10,
                            checksum=32)
    b2 = kanzi_tpu.compress(d2, transform="NONE", entropy="HUFFMAN",
                            block_size=1 << 15, checksum=32)
    r1 = Reader(b1, jobs=2, device="cpu",
                ctx={"deviceDecodeHooks": parallel.mesh_decode_hooks(mesh)})
    r2 = Reader(b2, jobs=4, device="cpu",
                ctx={"deviceDecodeHooks": parallel.mesh_decode_hooks(mesh)})
    o1, o2 = bytearray(), bytearray()
    while True:
        c1, c2 = r1.read(5000), r2.read(30000)
        o1 += c1
        o2 += c2
        if not c1 and not c2:
            break
    assert bytes(o1) == d1
    assert bytes(o2) == d2


@pytest.mark.parametrize("raised", ["fault", "rejection"])
@pytest.mark.parametrize("jobs", [1, 4])
@pytest.mark.parametrize("entropy", ["HUFFMAN", "ANS0"])
def test_failing_hook_raises_under_block_id(entropy, jobs, raised, monkeypatch):
    """A hook that raises fails the Reader under the block's id (the
    batched and the per-block path); the host decoder never runs. A
    failure of the card (DeviceFault) leaves as a DeviceFault, never as a
    corrupt block; a data rejection (KanziError) as KanziError with its
    code."""
    data = _corpus(12 << 10)
    blob = kt.compress(data, transform="NONE", entropy=entropy, block_size=4 << 10,
                       checksum=32, device=None)

    def broken(*_a):
        if raised == "fault":
            raise _kernels.DeviceFault("card lost")
        raise KanziError("payload refused", ERR_PROCESS_BLOCK)

    def no_host(*_a, **_k):
        raise AssertionError("the host decoder ran on the mesh path")

    monkeypatch.setattr(host_huffman, "huffman_decode", no_host)
    monkeypatch.setattr(native, "entropy_decode", no_host)
    r = Reader(blob, jobs=jobs, device="cpu",
               ctx={"deviceDecodeHooks": {"huffman": broken, "ans": broken}})
    if raised == "fault":
        with pytest.raises(_kernels.DeviceFault, match="Block 1.*: card lost") as info:
            r.read_all()
        assert not isinstance(info.value, KanziError)
    else:
        with pytest.raises(KanziError, match="Block 1: payload refused") as info:
            r.read_all()
        assert info.value.code == ERR_PROCESS_BLOCK


def test_mesh_writer_engines_and_routes():
    mesh = parallel.device_mesh(2, device="cpu")
    with pytest.raises(parallel.NoDeviceEngine):
        parallel.mesh_writer(mesh, transform="LZ", entropy="NONE")
    # the host C++ route of compress_multichip: no launch
    data = _corpus(100 << 10)
    _kernels.reset_counts()
    blob = parallel.compress_multichip(data, mesh, transform="LZ", entropy="FPAQ",
                                       block_size=1 << 15)
    assert blob == kanzi_tpu.compress(data, transform="LZ", entropy="FPAQ",
                                      block_size=1 << 15)
    assert sum(_kernels.plain_calls.values()) == 0
    assert parallel.decompress_multichip(blob, mesh) == data
    with pytest.raises(TypeError):
        parallel.mesh_writer(mesh, entropy="HUFFMAN", device="cpu")


def test_device_mesh_never_shrinks():
    cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError):
        parallel.device_mesh(cards + 1)
    with pytest.raises(RuntimeError):
        parallel.Mesh([f"cuda:{cards}"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.device_mesh()
    mesh = parallel.device_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert parallel.device_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        parallel.device_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        parallel.device_mesh(2, device=None)
    with pytest.raises(ValueError):
        parallel.Mesh([])


def test_dryrun_multihost():
    parallel.dryrun_multihost(2)
