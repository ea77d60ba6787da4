"""rANS ops and the device ANS engine of the PyTorch port against the JAX
package: encode_chunks and decode_chunks equal kanzi_tpu.ops.ans exactly
on the same seeded inputs; the engine's payloads equal the host C++
encoder's and kanzi_tpu's device engine's and decode to the input; a
stream with a non-default logRange decodes on the device path with no
host retry; a corrupted block raises."""

import os

import numpy as np
import pytest
import torch

from torch_jax_native import jax_native
from kanzi_tpu.entropy import ans_device as jax_ans_device
from kanzi_tpu.ops import ans as jax_ans
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.core import ERR_CRC_CHECK, ERR_PROCESS_BLOCK, KanziError
from kanzi_tpu_torch.entropy import ans_device
from kanzi_tpu_torch.ops import ans as ops_ans
from kanzi_tpu_torch.ops.state import to_port_state
from specmodel import ans as spec_ans
from torch_edge_inputs import ans_u32_cases, encode_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()

ETYPE = {0: 5, 1: 8}


def _cases():
    rng = np.random.default_rng(4)
    return {
        "text": _TEXT[:40000],
        "random": rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
        "narrow": rng.integers(0, 8, 40000, dtype=np.uint8).tobytes(),
        "const": b"z" * 30000,
        "small": rng.integers(0, 256, 100, dtype=np.uint8).tobytes(),
        "chunk_edge": rng.integers(0, 256, 16384 + 33, dtype=np.uint8).tobytes(),
        "n31": rng.integers(0, 256, 31, dtype=np.uint8).tobytes(),
    }


def _encode_batch(data: np.ndarray, order: int, extra_rows: int = 1):
    """The engine's batch for one block, plus zero padded rows (ngroups 0),
    with kanzi_tpu's int32 symbol matrices beside the port's."""
    tables, _hdr, _bits, flags = native.ans_prepare(data, order)
    mats, dev_chunks = ans_device._block_rows(data, order, flags)
    chunk = native.ANS1_CHUNK if order else native.ANS0_CHUNK
    build = jax_ans.build_syms_order1 if order else jax_ans.build_syms_order0
    for m, c in zip(mats, dev_chunks):
        want = build(data[c * chunk:(c + 1) * chunk])
        assert m.dtype == (np.uint16 if order else np.uint8)
        assert np.array_equal(m.astype(np.int32), want)
    R = len(mats) + extra_rows
    G = max(len(m) for m in mats)
    syms = np.zeros((R, G, 4), mats[0].dtype)
    ngroups = np.zeros(R, np.int32)
    for r, m in enumerate(mats):
        syms[r, :len(m)] = m
        ngroups[r] = len(m)
    tabs = np.zeros((R,) + tables.shape[1:], np.int32)
    tabs[:len(mats)] = tables[dev_chunks]
    return syms, ngroups, tabs


@pytest.mark.parametrize("order,n", [(0, 40000), (0, 16384 + 7), (1, 30001)])
def test_encode_chunks_match_jax(order, n):
    data = np.frombuffer(_TEXT[:n], np.uint8)
    syms, ngroups, tables = _encode_batch(data, order)
    want = jax_ans.encode_chunks(syms.astype(np.int32), ngroups, tables)
    st = to_port_state({"ans_syms": syms, "ngroups": ngroups,
                        "ans_tables": tables}, "cpu")
    _kernels.reset_counts()
    pairs, npairs, states = ops_ans.encode_chunks(st["ans_syms"], st["ngroups"],
                                                  st["ans_tables"])
    assert _kernels.plain_calls["ans_encode"] == 1
    assert _kernels.launches["ans_encode"] == 0
    assert pairs.dtype == torch.int16 and pairs.shape == (len(syms), 4 * syms.shape[1])
    assert np.array_equal(pairs.numpy().view(np.uint16), np.asarray(want[0]))
    assert np.array_equal(npairs.numpy(), np.asarray(want[1]))
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(want[2]))
    assert npairs[-1] == 0 and (states[-1].numpy() == ops_ans.ANS_TOP).all()


@pytest.mark.parametrize("name", list(encode_cases()))
def test_encode_chunks_edge_rows_match_jax(name):
    # rows whose every step emits, ngroups 0 / partial / out of range with
    # symbols past it, mixed ngroups in one batch, u16 indices at S = 65536
    syms, ngroups, tables = encode_cases()[name]
    want = jax_ans.encode_chunks(syms.astype(np.int32), ngroups, tables)
    st = to_port_state({"ans_syms": syms, "ngroups": ngroups,
                        "ans_tables": tables}, "cpu")
    pairs, npairs, states = ops_ans.encode_chunks(st["ans_syms"], st["ngroups"],
                                                  st["ans_tables"])
    assert np.array_equal(pairs.numpy().view(np.uint16), np.asarray(want[0]))
    assert np.array_equal(npairs.numpy(), np.asarray(want[1]))
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(want[2]))
    if name.startswith("emit_all"):
        assert npairs[0] == 4 * syms.shape[1]


def _decode_inputs(payload: bytes, n: int, order: int):
    """The device rows of one payload, as ans_decode_device builds them."""
    batch, _ = ans_device.decode_batch(np.frombuffer(payload, np.uint8), n, order)
    return {k: np.array(v) for k, v in batch.items()}


def _decode_port(arrays, order, glen):
    st = to_port_state(arrays, "cpu")
    return ops_ans.decode_chunks(st["bufs"], st["nbytes"], st["states0"],
                                 st["f2s"], st["dtabs"], st["ngroups"],
                                 st["lr"], order, glen)


@pytest.mark.parametrize("order,n", [(0, 40000), (1, 20003)])
def test_decode_chunks_match_jax(order, n):
    data = np.frombuffer(_TEXT[:n], np.uint8)
    payload, _ = native.entropy_encode(ETYPE[order], data, {"bsVersion": 6})
    port = _decode_inputs(payload, n, order)
    # a zero padded row: no groups, no bytes
    pad = {k: np.zeros((1,) + v.shape[1:], v.dtype) for k, v in port.items()}
    pad["lr"][:] = port["lr"][0]
    arrays = {k: np.concatenate([v, pad[k]]) for k, v in port.items()}
    glen = int(arrays["ngroups"].max())
    jd, jf, js, jb, jflags, _jaux = jax_native.ans_dec_prepare(
        np.frombuffer(payload, np.uint8), n, order)
    jdev = np.nonzero(jflags == 0)[0]
    jrows = [np.concatenate([a[jdev], np.zeros((1,) + a.shape[1:], a.dtype)])
             for a in (jb, js, jf, jd)]
    want_syms, want_nread = jax_ans.decode_chunks(
        *jrows, arrays["ngroups"], order=order, lr=11 if order else 12, glen=glen)
    syms, nread = _decode_port(arrays, order, glen)
    assert syms.dtype == torch.uint8 and syms.shape == (len(jrows[0]), glen, 4)
    assert np.array_equal(syms.numpy(), np.asarray(want_syms))
    assert np.array_equal(nread.numpy(), np.asarray(want_nread))


def test_decode_chunks_error_flag():
    # a row whose stream is cut short reads past its byte count, and a row
    # whose logRange its f2s row cannot hold: both rows come back with -1;
    # the rows beside them decode as before
    data = np.frombuffer(_TEXT[:40000], np.uint8)
    payload, _ = native.entropy_encode(5, data, {"bsVersion": 6})
    arrays = _decode_inputs(payload, len(data), 0)
    glen = int(arrays["ngroups"].max())
    syms, nread = _decode_port(arrays, 0, glen)
    assert (nread.numpy() == arrays["nbytes"]).all()
    arrays["nbytes"][0] -= 2
    arrays["lr"][1] = 13          # a 13-bit map needs 8192 bytes a row
    bad_syms, bad = _decode_port(arrays, 0, glen)
    assert bad[0] == -1 and bad[1] == -1
    assert torch.equal(bad[2:], nread[2:])
    assert torch.equal(bad_syms[2:], syms[2:]) and not bad_syms[1].any()


@pytest.mark.parametrize("name", list(ans_u32_cases()))
def test_decode_chunks_u32_tables_match_jax(name):
    # freq and cumFreq are read as u32, as kanzi_tpu reads them: no bit of
    # a freq at or above 2^17 is dropped
    arrays, order = ans_u32_cases()[name]
    glen = int(arrays["ngroups"].max())
    want_syms, want_nread = jax_ans.decode_chunks(
        arrays["bufs"], arrays["states0"], arrays["f2s"], arrays["dtabs"],
        arrays["ngroups"], order=order, lr=12, glen=glen)
    syms, nread = _decode_port(arrays, order, glen)
    assert np.array_equal(syms.numpy(), np.asarray(want_syms))
    assert np.array_equal(nread.numpy(), np.asarray(want_nread))


def _jax_engine_encode(data, order):
    eng = jax_ans_device.DeviceANSEngine(order)
    handle = eng.dispatch(np.frombuffer(data, np.uint8))
    dst = np.zeros(2 * len(data) + (1 << 18), dtype=np.uint8)
    bits = eng.collect(handle, dst, 0)
    return dst[:(bits + 7) >> 3].tobytes(), bits


@pytest.mark.parametrize("order", [0, 1])
def test_engine_matches_host_and_jax(order):
    cases = _cases()
    posts = [np.frombuffer(d, np.uint8) for d in cases.values()]
    _kernels.reset_counts()
    engine = ans_device.DeviceANSEngine(order, "cpu")
    handles = engine.dispatch_many(posts)          # one batch, one plain call
    assert _kernels.plain_calls["ans_encode"] == 1
    for (name, data), post, handle in zip(cases.items(), posts, handles):
        host = native.entropy_encode(ETYPE[order], post, {"bsVersion": 6})
        dst = np.zeros(2 * len(data) + (1 << 18), dtype=np.uint8)
        bits = engine.collect(handle, dst, 0)
        got = (dst[:(bits + 7) >> 3].tobytes(), bits)
        assert got == host, name
        assert got == _jax_engine_encode(data, order), name
        assert ans_device.ans_encode_device(data, order, "cpu") == host, name
        assert ans_device.ans_decode_device(host[0], len(data), order, "cpu") == data, name
    assert _kernels.launches["ans_encode"] == _kernels.launches["ans_decode"] == 0


@pytest.mark.parametrize("order,log_range,n", [(0, 10, 20000), (0, 14, 9000),
                                               (1, 10, 5000)])
def test_non_default_log_range_decodes_on_device(monkeypatch, order, log_range, n):
    data = _TEXT[:n]
    enc = spec_ans.SpecANSEncoder(order=order, log_range=log_range)
    enc.write(data)
    payload, _bits = enc.finish()
    src = np.frombuffer(payload, np.uint8)
    lrs = native.ans_dec_prepare(src, n, order)[-1]
    assert (lrs == max(log_range - order, 8)).all()
    assert jax_native.entropy_decode(ETYPE[order], src, n, {"bsVersion": 6}) == data

    def no_host(*_a, **_k):
        raise AssertionError("the host ANS decoder ran on the device path")

    from kanzi_tpu_torch.entropy import ans as host_ans
    monkeypatch.setattr(host_ans, "ans_decode", no_host)
    monkeypatch.setattr(native, "entropy_decode", no_host)
    _kernels.reset_counts()
    assert ans_device.ans_decode_device(payload, n, order, "cpu") == data
    assert _kernels.plain_calls["ans_decode"] == 1


def test_decode_chunks_mixed_log_ranges():
    # rows of two streams with logRange 10 and 14 in one call: the f2s
    # rows take the larger map's width
    parts = []
    for lr, n in ((10, 6000), (14, 7000)):
        enc = spec_ans.SpecANSEncoder(order=0, log_range=lr)
        enc.write(_TEXT[:n])
        parts.append((_decode_inputs(enc.finish()[0], n, 0), n))
    for k in ("f2s", "bufs"):
        width = max(p[k].shape[1] for p, _ in parts)
        for p, _ in parts:
            p[k] = np.pad(p[k], ((0, 0), (0, width - p[k].shape[1])))
    arrays = {k: np.concatenate([p[k] for p, _ in parts]) for k in parts[0][0]}
    syms, nread = _decode_port(arrays, 0, 4096)
    assert (nread.numpy() == arrays["nbytes"]).all()
    r = 0
    for p, n in parts:
        for c in range(len(p["ngroups"])):
            g = int(p["ngroups"][c])
            want = np.frombuffer(_TEXT[c * 16384:c * 16384 + 4 * g], np.uint8)
            assert np.array_equal(syms[r, :g].numpy()[:, ::-1].reshape(-1), want)
            r += 1


def test_short_order1_chunk_takes_the_host_route():
    # an order-1 block of 4 MiB + 2: its last chunk has 2 bytes, which the
    # format cannot encode; the engine hands the block to the host encoder,
    # which raises as kanzi_tpu's engine and the host path do
    rng = np.random.default_rng(8)
    post = rng.integers(0, 256, native.ANS1_CHUNK + 2, dtype=np.uint8)
    before = ans_device.counts["host_route"]
    engine = ans_device.DeviceANSEngine(1, "cpu")
    handle = engine.dispatch(post)
    assert ans_device.counts["host_route"] == before + 1
    dst = np.zeros(2 * len(post) + (1 << 18), dtype=np.uint8)
    with pytest.raises(RuntimeError):
        engine.collect(handle, dst, 0)
    with pytest.raises(RuntimeError):
        jax_ans_device.DeviceANSEngine(1).collect(
            jax_ans_device.DeviceANSEngine(1).dispatch(post), dst, 0)
    with pytest.raises(native.ShortANS1Chunk):
        native.ans_prepare(post, 1)


def test_corrupted_ans_block_raises_without_host_fallback(monkeypatch):
    rng = np.random.default_rng(42)
    data = _TEXT[:50000] + rng.integers(0, 4, 50000, dtype=np.uint8).tobytes()
    blob = kt.compress(data, transform="NONE", entropy="ANS0", block_size=1 << 17,
                       checksum=32, device=None)
    from kanzi_tpu_torch.entropy import ans as host_ans

    def no_host(*_a, **_k):
        raise AssertionError("the host ANS decoder ran on the device path")

    monkeypatch.setattr(host_ans, "ans_decode", no_host)
    monkeypatch.setattr(native, "entropy_decode", no_host)
    assert kt.decompress(blob, device="cpu") == data
    # a header the prepare rejects; renorm reads that leave their chunk's
    # stream (the kernel's error flag), which the host decoder reads on
    # from its buffer: the block decodes again on that buffer (a second
    # launch) and fails the checksum, as on the host; a decode that fails
    # the checksum
    for pos, code, msg, launches in ((55, ERR_PROCESS_BLOCK, "prepare", 0),
                                     (len(blob) // 2, ERR_CRC_CHECK, "checksum", 2),
                                     (len(blob) - 48, ERR_CRC_CHECK, "checksum", 1)):
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        _kernels.reset_counts()
        with pytest.raises(KanziError, match=msg) as ei:
            kt.decompress(bytes(bad), device="cpu")
        assert ei.value.code == code, (pos, str(ei.value))
        assert _kernels.plain_calls["ans_decode"] == launches, pos
