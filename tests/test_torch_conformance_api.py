"""The port's C API and the golden digests against kanzi_tpu's, on the CPU.

The C API (kanzi_tpu_torch/native/src/api.cpp: kz_compress, kz_decompress,
kz_stream_info) is held to kanzi_tpu's (tests/test_c_api.py): the same
bytes for the same parameters, the same outcome on garbage, legacy and
mutated streams. The golden-corpus digests of tests/test_format_stability.py
are computed through the port: every configuration on the host route
(device=None), and those whose entropy stage runs on the card also on the
plain-version route (device="cpu"), decoded back on both.
"""

import hashlib
import io
import json

import numpy as np
import pytest

import kanzi_tpu
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import native
from torch_jax_native import jax_native
import test_format_stability as golden

CTX6 = {"bsVersion": 6, "jobs": 1}


def _mixed(n, seed=7):
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox jumps over the lazy dog. " * 64
    parts = [text * (n // (4 * len(text)) + 1),
             np.cumsum(rng.integers(-2, 3, n // 8, dtype=np.int32)).astype("<i4").tobytes(),
             np.zeros(n // 8, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()]
    return b"".join(parts)[:n]


def _params(level):
    from kanzi_tpu_torch import entropy as E, transforms as T
    tr, en = kt.LEVEL_PRESETS[level]
    return T.get_type(tr or "NONE"), E.get_type(en or "NONE"), en or "NONE"


def _c_outcome(fn):
    """("bytes", sha256), ("checksum",) or ("rejected",): a C API decode's
    outcome, whichever package's."""
    try:
        return "bytes", hashlib.sha256(fn()).hexdigest()
    except (native.ChecksumMismatch, jax_native.ChecksumMismatch):
        return ("checksum",)
    except RuntimeError:
        return ("rejected",)


@pytest.mark.parametrize("checksum", [0, 32])
@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5, 6, 7])
def test_c_compress_matches_reference(level, checksum):
    data = _mixed(200_000, seed=level * 10 + checksum)
    bs = 64 << 10
    chain, etype, en = _params(level)
    ctx = dict(CTX6, blockSize=bs, entropy=en)
    got = native.c_compress(data, bs, chain, etype, dict(ctx), checksum_bits=checksum)
    assert got == jax_native.c_compress(data, bs, chain, etype, dict(ctx),
                                        checksum_bits=checksum)
    assert got == kt.compress(data, level=level, block_size=bs, checksum=checksum,
                              device=None)
    assert native.c_decompress(got, len(data) + 1024, dict(CTX6)) == data
    assert native.c_stream_info(got) == jax_native.c_stream_info(got)


@pytest.mark.parametrize("level", [1, 5])
def test_c_headerless_matches_reference(level):
    data = _mixed(90_000, seed=level)
    bs = 32 << 10
    chain, etype, en = _params(level)
    ctx = dict(CTX6, blockSize=bs, entropy=en)
    got = native.c_compress(data, bs, chain, etype, dict(ctx), headerless=True)
    assert got == jax_native.c_compress(data, bs, chain, etype, dict(ctx), headerless=True)
    kw = dict(headerless=True, chain=chain, etype=etype, block_size=bs)
    assert native.c_decompress(got, len(data) + 1024, dict(CTX6), **kw) == data
    assert _c_outcome(lambda: native.c_decompress(got[:len(got) // 2], len(data) + 1024,
                                                  dict(CTX6), **kw)) == \
        _c_outcome(lambda: jax_native.c_decompress(got[:len(got) // 2], len(data) + 1024,
                                                   dict(CTX6), **kw))


@pytest.mark.parametrize("case", ["magic", "header_crc", "payload", "version", "truncated"])
def test_c_decompress_rejections_match(case):
    data = _mixed(50_000)
    blob = bytearray(kanzi_tpu.compress(data, level=1, checksum=32))
    if case == "magic":
        blob[0] = 0
    elif case == "header_crc":
        blob[8] ^= 0x40
    elif case == "payload":
        blob[len(blob) // 2] ^= 0x04
    elif case == "version":
        blob[4] = (blob[4] & 0x0F) | (5 << 4)
    else:
        blob = blob[:len(blob) * 2 // 3]
    blob = bytes(blob)
    got = _c_outcome(lambda: native.c_decompress(blob, len(data) + 1024, dict(CTX6)))
    assert got == _c_outcome(lambda: jax_native.c_decompress(blob, len(data) + 1024,
                                                             dict(CTX6)))
    assert got != ("bytes", hashlib.sha256(data).hexdigest())


@pytest.mark.parametrize("checksum", [32, 0])
@pytest.mark.parametrize("level", [2, 5])
def test_c_decompress_mutants_match(level, checksum):
    """The mutation recipe through both C APIs: the same outcome each."""
    data = _mixed(60_000, seed=3)
    blob = kanzi_tpu.compress(data, level=level, block_size=16 << 10, checksum=checksum)
    rng = np.random.default_rng(level + checksum)
    for _ in range(12):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        b = bytes(b)
        assert _c_outcome(lambda: native.c_decompress(b, len(data) + 1024, dict(CTX6))) == \
            _c_outcome(lambda: jax_native.c_decompress(b, len(data) + 1024, dict(CTX6)))


# -- the golden digests ------------------------------------------------------

_GOLDEN = json.load(open(golden.GOLDEN_PATH))
_CONFIGS = golden._configs()
_DEVICE_ENTROPY = ("HUFFMAN", "ANS0", "ANS1", "RANGE")


def _entropy(cfg):
    return kt.LEVEL_PRESETS[cfg["level"]][1] if "level" in cfg else cfg["entropy"]


def _golden_cases():
    for name, cfg in _CONFIGS.items():
        yield name, None
        if _entropy(cfg) in _DEVICE_ENTROPY:
            yield name, "cpu"


class _Noop:
    def process_event(self, evt):
        pass


@pytest.mark.parametrize("name,route", list(_golden_cases()),
                         ids=[f"{n}-{r}" for n, r in _golden_cases()])
def test_golden_digest_through_port(name, route):
    data = golden._corpus()
    cfg = dict(_CONFIGS[name])
    if cfg.pop("listener", False):
        transform, entropy = kt.LEVEL_PRESETS[cfg["level"]]
        out = io.BytesIO()
        w = kt.Writer(out, transform=transform, entropy=entropy,
                      block_size=cfg["block_size"], checksum=cfg["checksum"],
                      file_size=len(data), device=route)
        w.add_listener(_Noop())
        w.write(data)
        w.close()
        blob = out.getvalue()
    else:
        blob = kt.compress(data, device=route, **cfg)
    want = _GOLDEN[name]
    assert {"sha256": hashlib.sha256(blob).hexdigest(), "size": len(blob)} == want, name
    # decoded back on the same route, but for RANGE and ANS1, whose plain
    # loops take half a minute on the corpus: those decode on the host
    slow = _entropy(_CONFIGS[name]) in ("RANGE", "ANS1")
    assert kt.decompress(blob, jobs=4, device=None if slow else route) == data
