"""The port's decode contract against kanzi_tpu's on legacy and hostile
streams, and the split between a corrupt stream and a failed card.

Each case makes its stream from a seed with numpy (or with the spec-model
writers of bitstream versions 1-5, tests/specmodel/legacy_v14.py and
legacy_v5.py), decodes it with kanzi_tpu and with the port, on its host
route (device=None) and on its plain-version route (device="cpu"), and
holds the outcomes equal: the same bytes, or a KanziError with the same
code. A DeviceFault is never an outcome of a stream.

The fault tests raise a card's failure (a refused launch, an error of the
CUDA context, a failed build) inside the "cpu" route's kernels and hold
the Reader, the Writer and the CLI to it: the failure leaves as
_kernels.DeviceFault under the block's id, never as a corrupt block.

The mutated streams are in test_torch_conformance_fuzz.py, the C API and
the golden digests in test_torch_conformance_api.py. The "cpu" route's
inputs stay small: the plain range and ANS loops are slow on the CPU.
"""

import hashlib
import io
import os

import numpy as np
import pytest
import torch

import kanzi_tpu
from kanzi_tpu.core import KanziError as JaxKanziError
from kanzi_tpu.kio import Reader as JaxReader
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels, app, native
from kanzi_tpu_torch.core import (ERR_CRC_CHECK, ERR_PROCESS_BLOCK, ERR_UNKNOWN,
                                  KanziError)
from kanzi_tpu_torch.entropy import device_io
from kanzi_tpu_torch.kio import Reader
from kanzi_tpu_torch.ops import ans as ops_ans, huffman as ops_huffman
from kanzi_tpu_torch.ops import range as ops_range
from specmodel import ans as sans
from specmodel import legacy_v14 as l14
from specmodel import legacy_v5 as l5
from torch_jax_native import jax_native  # noqa: F401  (builds kanzi_tpu's library once)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = [None, "cpu"]

with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()


def outcome(decode):
    """("bytes", sha256) of what `decode()` returns, or ("KanziError",
    code) of the KanziError (kanzi_tpu's or the port's) it raises; any
    other exception propagates and fails the case."""
    try:
        return "bytes", hashlib.sha256(decode()).hexdigest()
    except (JaxKanziError, KanziError) as e:
        return "KanziError", e.code


def hold(blob, route, jobs=1, **kw):
    """The port's outcome on `route` equals kanzi_tpu's on the same bytes
    and arguments. Returns the outcome."""
    want = outcome(lambda: kanzi_tpu.decompress(blob, jobs=jobs, **kw))
    got = outcome(lambda: kt.decompress(blob, jobs=jobs, device=route, **kw))
    assert got == want, (route, jobs, kw)
    return got


def _corpus(n=80000):
    rng = np.random.default_rng(3)
    return _TEXT[:n - 30000] + rng.integers(0, 40, 30000, dtype=np.uint8).tobytes()


def _mixed(n, seed):
    """Text, 3-bit symbols and random bytes, shuffled in 4 KiB pieces."""
    rng = np.random.default_rng(seed)
    parts = [_TEXT[:n // 2], rng.integers(0, 8, n // 4, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, n - n // 2 - n // 4, dtype=np.uint8).tobytes()]
    data = np.frombuffer(b"".join(parts), np.uint8)
    pieces = np.array_split(data, max(len(data) // 4096, 1))
    return b"".join(pieces[i].tobytes() for i in rng.permutation(len(pieces)))


def _ans_chunked_32k(b, order=0):
    enc = sans.SpecANSEncoder(order=order, chunk_size=32768)
    enc.write(b)
    return enc.finish()


# -- legacy streams: bitstream versions 1-5 ---------------------------------

def _legacy_streams():
    data = _corpus()
    d2 = data[:32769 + 17]
    rng = np.random.default_rng(55)
    narrow = rng.integers(0, 8, 30000, dtype=np.uint8).tobytes()
    return {
        "v4_ans0": (data, lambda: l14.compress_legacy(
            data, 4, 5, lambda b: sans.ans_encode(b, 0), 65536)),
        "v3_ans0_32k": (data, lambda: l14.compress_legacy(data, 3, 5, _ans_chunked_32k, 65536)),
        "v3_blocks_32k": (data, lambda: l14.compress_legacy(data, 3, 5, _ans_chunked_32k, 32768)),
        "v2_no_crc": (data, lambda: l14.compress_legacy(data, 2, 5, _ans_chunked_32k, 65536)),
        "v1_ans0": (data, lambda: l14.compress_legacy(
            data, 1, 5, lambda b: l14.ans_encode_v1(b, 0), 65536)),
        "v1_ans1": (data, lambda: l14.compress_legacy(
            data, 1, 8, lambda b: l14.ans_encode_v1(b, 1), 65536)),
        "v1_odd_chunk": (d2, lambda: l14.compress_legacy(
            d2, 1, 5, lambda b: l14.ans_encode_v1(b, 0), 1 << 20)),
        "v3_fpaq": (data, lambda: l14.compress_legacy(data, 3, 2, l14.fpaq_encode_v1, 65536)),
        "v3_cm": (data[:50000], lambda: l14.compress_legacy(
            data[:50000], 3, 6, l14.cm_encode_v3, 65536)),
        "v5_huffman_text": (_TEXT[:40000], lambda: l5.compress_v5_huffman(_TEXT[:40000], 65536)),
        "v5_huffman_narrow": (narrow, lambda: l5.compress_v5_huffman(narrow, 16384)),
        "v5_huffman_const": (b"A" * 20000, lambda: l5.compress_v5_huffman(b"A" * 20000, 65536)),
    }


_LEGACY = _legacy_streams()
_LEGACY_BLOBS: dict = {}


def _legacy(name):
    if name not in _LEGACY_BLOBS:
        _LEGACY_BLOBS[name] = _LEGACY[name][1]()
    return _LEGACY[name][0], _LEGACY_BLOBS[name]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(_LEGACY))
def test_legacy_stream_outcomes_match(name, route):
    """The legacy stream decodes to its input as in kanzi_tpu; at jobs=4
    it gives kanzi_tpu's outcome (streams below version 5 take the
    parallel frame reader, which refuses them with ERR_STREAM_VERSION in
    both packages); its truncations and three seeded byte flips give
    kanzi_tpu's outcome."""
    data, blob = _legacy(name)
    assert hold(blob, route) == ("bytes", hashlib.sha256(data).hexdigest())
    hold(blob, route, jobs=4)
    rng = np.random.default_rng(sum(name.encode()))
    for cut in (len(blob) // 2, len(blob) - 1):
        hold(blob[:cut], route)
    for _ in range(3):
        bad = bytearray(blob)
        i = int(rng.integers(0, len(bad)))
        bad[i] ^= int(rng.integers(1, 256))
        hold(bytes(bad), route, jobs=4)


@pytest.mark.parametrize("route", ROUTES)
def test_legacy_from_to_and_streaming(route):
    """--from/--to on a v3 stream, through the streaming Reader, as in
    kanzi_tpu."""
    data, blob = _legacy("v3_blocks_32k")
    for ctx in ({"from": 2, "to": 4}, {"from": 3}, {"to": 2}):
        want = JaxReader(io.BytesIO(blob), ctx=dict(ctx)).read_all()
        got = Reader(io.BytesIO(blob), ctx=dict(ctx), device=route).read_all()
        assert got == want
    assert want == data[:32768]


@pytest.mark.parametrize("case", ["lzp_v3", "utf_v0", "rolz_v2", "rolz_v3",
                                  "rolzx_v2", "rolzx_v3", "exe_v2"])
def test_legacy_transform_inverse_matches(case):
    """The port's host library inverts the legacy transform payloads of
    tests/test_legacy_v14.py as kanzi_tpu's does."""
    import specmodel.lzx as slzx
    from specmodel import content_aware as sca, rolz as srolz
    from kanzi_tpu import transforms as T
    from test_legacy_v14 import _repack_utf_v0

    text = _TEXT[:30000] * 2
    if case == "lzp_v3":
        orig = slzx.LZP_MIN_MATCH
        slzx.LZP_MIN_MATCH = 96
        try:
            enc = slzx.lzp_forward(_TEXT[:20000] * 4)
        finally:
            slzx.LZP_MIN_MATCH = orig
        ttype, version, n = T.LZP_TYPE, 3, 80000
    elif case == "utf_v0":
        src = ("λögic ünïcode ωords — " * 3000).encode("utf-8")
        enc = _repack_utf_v0(sca.utf_forward(src, must_validate=False))
        ttype, version, n = T.UTF_TYPE, 3, len(src)
    elif case.startswith("rolz"):
        version = int(case[-1])
        fwd = srolz.rolz2_forward if case.startswith("rolzx") else srolz.rolz1_forward
        enc = fwd(text, bs_version=version)
        ttype = T.ROLZX_TYPE if case.startswith("rolzx") else T.ROLZ_TYPE
        n = len(text)
    else:
        body = bytearray(np.random.default_rng(9).integers(0, 256, 4000, dtype=np.uint8).tobytes())
        for k in range(40):
            body[50 + k * 90] = 0xE8 if k % 2 else 0xE9
            body[51 + k * 90] = [0x00, 0x01, 0xF5, 0x77][k % 4]
        enc, ttype, version, n = bytes(body), T.EXE_TYPE, 2, 8000
    src = np.frombuffer(enc, np.uint8)
    want = jax_native.transform_inverse(ttype, src, {"bsVersion": version}, n)
    got = native.transform_inverse(ttype, src, {"bsVersion": version}, n)
    assert bytes(got) == bytes(want)


# -- truncations, trailing garbage, from/to, headerless, streaming ----------

_CODECS = {
    "level1": dict(level=1),
    "level2": dict(level=2),
    "level5": dict(level=5),
    "ANS1": dict(transform="NONE", entropy="ANS1"),
    "RANGE": dict(transform="LZ", entropy="RANGE"),
}


def _stream(codec, checksum, n=12 << 10, block=4 << 10, seed=5):
    """A small seeded stream of several blocks (the "cpu" route's plain
    loops stay short), made by kanzi_tpu."""
    data = _mixed(n, seed)
    return data, kanzi_tpu.compress(data, block_size=block, checksum=checksum,
                                    **_CODECS[codec])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("codec", sorted(_CODECS))
def test_truncations_match(codec, route):
    data, blob = _stream(codec, 32)
    for cut in (0, 3, 5, 16, len(blob) // 3, len(blob) // 2, len(blob) - 2,
                len(blob) - 1):
        for jobs in (1, 4):
            got = hold(blob[:cut], route, jobs)
            assert got[0] == "KanziError" or got[1] == hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("codec", ["level2", "level5", "RANGE"])
def test_trailing_garbage_ignored(codec, route):
    data, blob = _stream(codec, 32)
    rng = np.random.default_rng(7)
    for tail in (b"\x00\x00garbage", rng.integers(0, 256, 999, dtype=np.uint8).tobytes()):
        for jobs in (1, 4):
            assert hold(blob + tail, route, jobs) == ("bytes", hashlib.sha256(data).hexdigest())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("codec", ["level2", "level5", "ANS1"])
def test_from_to_ranges_match(codec, route):
    """Block ranges as kanzi_tpu reads them, and a corrupt block outside
    the range is never decoded."""
    data, blob = _stream(codec, 32)
    for ctx in ({"from": 2, "to": 3}, {"from": 2}, {"to": 3}, {"from": 4, "to": 9}):
        for jobs in (1, 4):
            assert hold(blob, route, jobs, ctx=dict(ctx))[0] == "bytes"
    # flip a byte in the last block: a range that skips it still decodes
    bad = bytearray(blob)
    bad[-8] ^= 0x5A
    assert hold(bytes(bad), route, 4, ctx={"to": 3}) == \
        ("bytes", hashlib.sha256(data[:2 * 4096]).hexdigest())
    hold(bytes(bad), route, 4, ctx={"from": 3})


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("codec", ["level2", "level5"])
def test_headerless_match(codec, route):
    data = _mixed(9000, 11)
    kw = _CODECS[codec]
    transform, entropy = kanzi_tpu.LEVEL_PRESETS[kw["level"]]
    blob = kanzi_tpu.compress(data, block_size=4096, headerless=True, **kw)
    ctx = {"transform": transform, "entropy": entropy, "blockSize": 4096,
           "checksum": 0}
    for jobs in (1, 4):
        assert hold(blob, route, jobs, headerless=True, ctx=dict(ctx)) == \
            ("bytes", hashlib.sha256(data).hexdigest())
    # a truncated headerless stream
    hold(blob[:len(blob) // 2], route, 1, headerless=True, ctx=dict(ctx))


class _Dribble:
    """A file-like source that hands out at most 777 bytes a read."""

    def __init__(self, b):
        self.b, self.i = b, 0

    def read(self, n):
        chunk = self.b[self.i:self.i + min(n, 777)]
        self.i += len(chunk)
        return chunk


def _read_in_pieces(reader) -> bytes:
    out = bytearray()
    while True:
        c = reader.read(5000)
        if not c:
            return bytes(out)
        out += c


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("codec", ["level2", "level5"])
def test_streaming_reader_matches(codec, route):
    """The constant-memory path (a file-like source read in pieces), on a
    good stream, a truncated one and a mutated one."""
    data, blob = _stream(codec, 32, n=24 << 10)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x21
    for b in (blob, blob[:len(blob) * 2 // 3], bytes(bad)):
        for jobs in (1, 4):
            want = outcome(lambda: _read_in_pieces(JaxReader(_Dribble(b), jobs=jobs)))
            got = outcome(lambda: _read_in_pieces(
                Reader(_Dribble(b), jobs=jobs, device=route)))
            assert got == want
    assert want == ("bytes", hashlib.sha256(data).hexdigest()) or b is not blob


# -- a failure of the card is not a corrupt stream --------------------------

def _accelerator_error(*_a, **_k):
    raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")


def _launch_failure(*_a, **_k):
    raise _kernels.DeviceFault("kz_decode: CUDA launch failed with error 700")


_KERNELS = {"HUFFMAN": (ops_huffman, "decode_lanes", dict(level=2)),
            "ANS0": (ops_ans, "decode_chunks", dict(level=5)),
            "ANS1": (ops_ans, "decode_chunks", dict(transform="NONE", entropy="ANS1")),
            "RANGE": (ops_range, "decode_chunks", dict(transform="LZ", entropy="RANGE"))}


@pytest.mark.parametrize("jobs", [1, 4])
@pytest.mark.parametrize("failure", [_accelerator_error, _launch_failure],
                         ids=["accelerator_error", "launch_failure"])
@pytest.mark.parametrize("codec", sorted(_KERNELS))
def test_device_fault_is_not_a_corrupt_block(codec, failure, jobs, monkeypatch):
    """A card's failure inside the "cpu" route's decode kernel leaves
    decompress and the Reader as DeviceFault under the first block's id,
    not as KanziError; the host decoder never runs instead."""
    module, name, kw = _KERNELS[codec]
    data = _mixed(9000, 2)
    blob = kt.compress(data, block_size=4096, checksum=32, device=None, **kw)
    monkeypatch.setattr(module, name, failure)
    monkeypatch.setattr(native, "entropy_decode", _launch_failure)
    with pytest.raises(_kernels.DeviceFault, match=r"^Block 1\b") as info:
        kt.decompress(blob, jobs=jobs, device="cpu")
    assert not isinstance(info.value, KanziError)
    assert "orrupt" not in str(info.value)
    with pytest.raises(_kernels.DeviceFault):
        Reader(io.BytesIO(blob), jobs=jobs, device="cpu").read(100)


@pytest.mark.parametrize("jobs", [1, 4])
def test_payload_rejection_keeps_its_code(jobs):
    """A corrupt payload on the "cpu" route raises KanziError under its
    block's id, with kanzi_tpu's code (the counterpart of the fault test
    above, on the same stream)."""
    data = _mixed(9000, 2)
    blob = bytearray(kt.compress(data, level=5, block_size=4096, checksum=32, device=None))
    blob[len(blob) // 2] ^= 0xFF
    want = outcome(lambda: kanzi_tpu.decompress(bytes(blob), jobs=jobs))
    with pytest.raises(KanziError, match=r"^Block \d+: ") as info:
        kt.decompress(bytes(blob), jobs=jobs, device="cpu")
    assert ("KanziError", info.value.code) == want
    assert info.value.code in (ERR_PROCESS_BLOCK, ERR_CRC_CHECK)


def test_writer_device_fault(monkeypatch):
    """The device Writer keeps the rule: a card's failure in its pack
    kernel leaves compress as DeviceFault."""
    monkeypatch.setattr(ops_huffman, "pack_lanes", _accelerator_error)
    with pytest.raises(_kernels.DeviceFault, match="illegal memory access"):
        kt.compress(_mixed(9000, 2), level=2, block_size=4096, jobs=2, device="cpu")


def test_launch_error_raises_device_fault(monkeypatch):
    """_kernels.launch: a launch API that returns an error raises
    DeviceFault and counts nothing."""
    import contextlib
    from types import SimpleNamespace

    monkeypatch.setattr(_kernels, "_fn", lambda name: (lambda *a: 700))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    _kernels.reset_counts()
    with pytest.raises(_kernels.DeviceFault, match="error 700"):
        _kernels.launch("decode_lanes", "kz_decode_lanes", torch.device("cpu"))
    assert _kernels.launches["decode_lanes"] == 0


def test_build_failure_raises_device_fault(monkeypatch, tmp_path):
    """A kernel build that fails (here: a compiler that exits 1) raises
    DeviceFault."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    with pytest.raises(_kernels.DeviceFault, match="nvcc failed"):
        _kernels.build()


def test_card_errors_classify():
    """card_errors turns the card's errors into DeviceFault and lets the
    data's pass unchanged; device_io.each keeps only the data's."""
    for e in (torch.AcceleratorError("CUDA error: misaligned address"),
              torch.OutOfMemoryError("CUDA out of memory")):
        with pytest.raises(_kernels.DeviceFault):
            with _kernels.card_errors("k"):
                raise e
    for e in (KanziError("bad", ERR_PROCESS_BLOCK), ValueError("v"),
              native.NativeError("n"), RuntimeError("other")):
        with pytest.raises(type(e)) as info:
            with _kernels.card_errors("k"):
                raise e
        assert not isinstance(info.value, _kernels.DeviceFault)

    def fn(x):
        if x == 1:
            raise native.NativeError("rejected")
        if x == 2:
            raise _kernels.DeviceFault("lost")
        return x

    got = device_io.each(map, fn, [0, 1])
    assert got[0] == 0 and isinstance(got[1], native.NativeError)
    with pytest.raises(_kernels.DeviceFault):
        device_io.each(map, fn, [0, 1, 2])


def test_cli_exit_codes_differ(monkeypatch, tmp_path, capsys):
    """The CLI: a card's failure prints the fault and exits ERR_UNKNOWN; a
    corrupt input raises kanzi_tpu's KanziError code (an uncaught
    exception: exit code 1), and the two never meet."""
    from kanzi_tpu import app as jax_app

    data = _mixed(9000, 4)
    good, bad = tmp_path / "good.knz", tmp_path / "bad.knz"
    good.write_bytes(kt.compress(data, level=2, block_size=4096, checksum=32, device=None))
    blob = bytearray(good.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    bad.write_bytes(bytes(blob))
    out = str(tmp_path / "out")
    with monkeypatch.context() as m:
        m.setattr(ops_huffman, "decode_lanes", _accelerator_error)
        rc = app.main(["-d", "-i", str(good), "-o", out, "-f", "-j", "2",
                       "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == ERR_UNKNOWN and "Device fault" in err and "Block 1" in err
    assert "orrupt" not in err
    with pytest.raises(JaxKanziError) as want:
        jax_app.main(["-d", "-i", str(bad), "-o", out, "-f", "-j", "2"])
    for device in ("cpu", "none"):
        with pytest.raises(KanziError) as got:
            app.main(["-d", "-i", str(bad), "-o", out, "-f", "-j", "2",
                      "--device", device])
        assert got.value.code == want.value.code != ERR_UNKNOWN
    assert app.main(["-d", "-i", str(good), "-o", out, "-f", "--device", "cpu"]) == 0
    with open(out, "rb") as fh:
        assert fh.read() == data
