"""Range-coder ops and the device range engine of the PyTorch port against
the JAX package: encode_chunks and decode_chunks equal kanzi_tpu.ops.range
exactly on the same seeded inputs; the engine's payloads equal the host
C++ encoder's and kanzi_tpu's device engine's, at 32 KiB chunk edges, with
reduced logRange on small final chunks and on degenerate chunks; the
sequential chunk walk decodes them; a corrupted block raises."""

import os

import numpy as np
import pytest
import torch

from torch_jax_native import jax_native
from kanzi_tpu.entropy import range_device as jax_range_device
from kanzi_tpu.ops import range as jax_range
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.core import ERR_CRC_CHECK, ERR_PROCESS_BLOCK, KanziError
from kanzi_tpu_torch.entropy import range_device
from kanzi_tpu_torch.ops import range as ops_range
from kanzi_tpu_torch.ops.state import to_port_state
from torch_edge_inputs import range_encode_cases, range_u32_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()

CHUNK = range_device._CHUNK


def _pieces():
    """Single chunks: text (logRange 12), random bytes (11: the chunk is
    shorter than 4096), and a small near-uniform chunk whose normalization
    needs the header repair (logRange 8)."""
    rng = np.random.default_rng(99)
    return [np.frombuffer(_TEXT[:6000], np.uint8),
            rng.integers(0, 256, 3000, dtype=np.uint8),
            rng.integers(0, 200, 500, dtype=np.uint8)]


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
        "chunk32k_edge": rng.integers(0, 256, CHUNK + 97, dtype=np.uint8).tobytes(),
        "two_chunks_text": (_TEXT * 3)[:(1 << 16) + 1234],
        "degenerate": rng.integers(0, 200, 500, dtype=np.uint8).tobytes(),
    }


def test_encode_chunks_match_jax():
    pieces = _pieces()
    N = max(len(p) for p in pieces)
    R = len(pieces) + 1                          # and one padded row
    syms = np.zeros((R, N), np.uint8)
    nvalid = np.zeros(R, np.int32)
    tables = np.zeros((R, 2, 256), np.int32)
    shifts = np.full(R, 12, np.int32)
    for r, p in enumerate(pieces):
        t, _hdr, _bits, flags, sh = native.range_prepare(p)
        assert flags[0] == 0
        syms[r, :len(p)] = p
        nvalid[r] = len(p)
        tables[r], shifts[r] = t[0], sh[0]
    assert shifts[:3].tolist() == [12, 11, 8]
    want = jax_range.encode_chunks(syms.astype(np.int32), nvalid, tables,
                                   shifts.astype(np.uint32))
    st = to_port_state({"rng_syms": syms, "nvalid": nvalid,
                        "rng_tables": tables, "shifts": shifts}, "cpu")
    _kernels.reset_counts()
    words, nwords, lows = ops_range.encode_chunks(
        st["rng_syms"], st["nvalid"], st["rng_tables"], st["shifts"])
    assert _kernels.plain_calls["range_encode"] == 1
    assert _kernels.launches["range_encode"] == 0
    assert words.dtype == torch.int32 and words.shape == (R, 2 * N)
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(nwords.numpy(), np.asarray(want[1]))
    assert np.array_equal(lows.numpy().view(np.uint32), np.asarray(want[2]))
    assert nwords[-1] == 0 and not lows[-1].any()


def _encode_both(syms, nvalid, tables, shifts):
    """encode_chunks of the port (plain) and of kanzi_tpu on the same rows,
    as u32 numpy arrays. kanzi_tpu reads a negative shift as a u32 above
    63; the port clamps it to 0, so kanzi_tpu takes 0 there."""
    want = jax_range.encode_chunks(syms.astype(np.int32), nvalid, tables,
                                   np.maximum(shifts, 0).astype(np.uint32))
    st = to_port_state({"rng_syms": syms, "nvalid": nvalid, "rng_tables": tables,
                        "shifts": shifts}, "cpu")
    got = ops_range.encode_chunks(st["rng_syms"], st["nvalid"], st["rng_tables"],
                                  st["shifts"])
    return ([g.numpy().view(np.uint32) if g.dtype == torch.int32 else g.numpy()
             for g in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("name", list(range_encode_cases()))
def test_encode_chunks_edge_rows_match_jax(name):
    # nvalid 0 / 1 / N / negative / past N, bytes past nvalid, mixed
    # lengths, logRange 8/11/12 and shifts outside [0, 63], two emissions
    # a byte, a single-symbol table, random u32 tables
    syms, nvalid, tables, shifts = range_encode_cases()[name]
    got, want = _encode_both(syms, nvalid, tables, shifts)
    for g, w in zip(got, want):
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))
    nv = np.clip(nvalid, 0, syms.shape[1])
    if name in ("shifts", "two_emissions"):
        assert (got[1] == 2 * nv).any()         # a row whose every byte emits twice


@pytest.mark.parametrize("name", list(range_u32_cases()))
def test_u32_tables_match_jax(name):
    # table planes read as u32, as kanzi_tpu reads them: entries in
    # [2^24, 2^31) and at or above 2^31, encode and decode
    (syms, nvalid, tables, shifts), dec = range_u32_cases()[name]
    got, want = _encode_both(syms, nvalid, tables, shifts)
    for g, w in zip(got, want):
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))
    assert got[1][0] > 0
    bufs, dtables, f2s, dshifts, dnvalid, glen = dec
    want_syms, want_nreads = jax_range.decode_chunks(
        bufs, dtables, f2s, dshifts.astype(np.uint32), dnvalid, glen=glen)
    st = to_port_state({"bufs": bufs, "nbytes": np.full(len(bufs), bufs.shape[1], np.int32),
                        "rng_tables": dtables, "f2s": f2s, "shifts": dshifts,
                        "nvalid": dnvalid}, "cpu")
    syms_d, nreads = ops_range.decode_chunks(st["bufs"], st["nbytes"], st["rng_tables"],
                                             st["f2s"], st["shifts"], st["nvalid"], glen)
    assert np.array_equal(syms_d.numpy(), np.asarray(want_syms))
    assert np.array_equal(nreads.numpy(), np.asarray(want_nreads))
    assert nreads.max() > 0


def _chunk_rows(payloads, buf_cap=2 * CHUNK + 8192):
    """The first chunk of each payload as one batch: the port's rows (with
    their byte counts) and kanzi_tpu's."""
    port = {k: [] for k in ("bufs", "nbytes", "rng_tables", "f2s", "shifts")}
    jrows = {k: [] for k in ("bufs", "tables", "f2s", "shifts")}
    for payload in payloads:
        src = np.frombuffer(payload, np.uint8)
        hdr_end, t, f2s, shift, flag, _aux, buf = native.range_dec_chunk(src, 0, buf_cap)
        assert flag == 0
        nb = (min(8 * len(src) - hdr_end, 8 * (buf_cap - 16)) + 7) >> 3
        port["bufs"].append(buf)
        port["nbytes"].append(nb)
        port["rng_tables"].append(t)
        port["f2s"].append(f2s)
        port["shifts"].append(shift)
        _e, jt, jf, jsh, _jfl, _ja, jbuf = jax_native.range_dec_chunk(src, 0, buf_cap)
        for k, v in zip(("bufs", "tables", "f2s", "shifts"), (jbuf, jt, jf, jsh)):
            jrows[k].append(v)
    port = {k: np.array(v, np.int32 if k in ("nbytes", "shifts") else None)
            for k, v in port.items()}
    jrows = {k: np.array(v, np.uint32 if k == "shifts" else None)
             for k, v in jrows.items()}
    return port, jrows


def test_decode_chunks_match_jax():
    pieces = _pieces()
    payloads = [native.entropy_encode(4, p, {"bsVersion": 6})[0] for p in pieces]
    port, jrows = _chunk_rows(payloads)
    nvalid = np.array([len(p) for p in pieces], np.int32)
    glen = int(nvalid.max())
    want_syms, want_nreads = jax_range.decode_chunks(
        jrows["bufs"], jrows["tables"], jrows["f2s"], jrows["shifts"], nvalid,
        glen=glen)
    port["nvalid"] = nvalid
    st = to_port_state(port, "cpu")
    syms, nreads = ops_range.decode_chunks(st["bufs"], st["nbytes"], st["rng_tables"],
                                           st["f2s"], st["shifts"], st["nvalid"], glen)
    assert syms.dtype == torch.uint8 and syms.shape == (len(pieces), glen)
    assert np.array_equal(syms.numpy(), np.asarray(want_syms))
    assert np.array_equal(nreads.numpy(), np.asarray(want_nreads))
    for r, p in enumerate(pieces):
        assert np.array_equal(syms[r, :len(p)].numpy(), p)
    # a row whose byte count ends before its last read sets the error flag;
    # the rows beside it decode as before
    port["nbytes"][0] = (60 + 28 * int(nreads[0]) - 1) >> 3
    st = to_port_state(port, "cpu")
    syms2, nreads2 = ops_range.decode_chunks(st["bufs"], st["nbytes"], st["rng_tables"],
                                             st["f2s"], st["shifts"], st["nvalid"], glen)
    assert nreads2[0] == -1
    assert torch.equal(nreads2[1:], nreads[1:]) and torch.equal(syms2[1:], syms[1:])


def _jax_engine_encode(data):
    eng = jax_range_device.DeviceRangeEngine()
    dst = np.zeros(2 * len(data) + 8192, np.uint8)
    bits = eng.collect(eng.dispatch(np.frombuffer(data, np.uint8)), dst, 0)
    return dst[:(bits + 7) >> 3].tobytes(), bits


def test_engine_matches_host_and_jax():
    cases = _cases()
    posts = [np.frombuffer(d, np.uint8) for d in cases.values()]
    _kernels.reset_counts()
    engine = range_device.DeviceRangeEngine("cpu")
    handles = engine.dispatch_many(posts)          # one batch, one plain call
    assert _kernels.plain_calls["range_encode"] == 1
    for (name, data), post, handle in zip(cases.items(), posts, handles):
        host = native.entropy_encode(4, post, {"bsVersion": 6})
        dst = np.zeros(2 * len(data) + 8192, np.uint8)
        bits = engine.collect(handle, dst, 0)
        got = (dst[:(bits + 7) >> 3].tobytes(), bits)
        assert got == host, name
        assert got == _jax_engine_encode(data), name
        if name == "small":   # the one-shot encode is one dispatch + collect
            assert range_device.range_encode_device(data, "cpu") == host
    assert _kernels.launches["range_encode"] == 0


@pytest.mark.parametrize("name", ["small", "n31", "const", "degenerate",
                                  "chunk32k_edge"])
def test_chunk_walk_decodes(name):
    data = _cases()[name]
    payload, _ = native.entropy_encode(4, np.frombuffer(data, np.uint8),
                                       {"bsVersion": 6})
    _kernels.reset_counts()
    assert range_device.range_decode_device(payload, len(data), "cpu") == data
    assert jax_range_device.range_decode_device(payload, len(data)) == data
    # one device decode per chunk that is not a single symbol
    nchunks = -(-len(data) // CHUNK)
    assert _kernels.plain_calls["range_decode"] == (0 if name == "const" else nchunks)


def test_corrupted_range_block_raises_without_host_fallback(monkeypatch):
    rng = np.random.default_rng(42)
    data = _TEXT[:20000] + rng.integers(0, 4, 20000, dtype=np.uint8).tobytes()
    blob = kt.compress(data, transform="NONE", entropy="RANGE", block_size=1 << 17,
                       checksum=32, device=None)
    from kanzi_tpu_torch.entropy import range_codec as host_range

    def no_host(*_a, **_k):
        raise AssertionError("the host range decoder ran on the device path")

    monkeypatch.setattr(host_range, "range_decode", no_host)
    monkeypatch.setattr(native, "entropy_decode", no_host)
    assert kt.decompress(blob, device="cpu") == data
    # a header the chunk parse rejects, renorm reads past the payload (the
    # kernel's error flag), and a decode that fails the checksum
    for pos, code, msg in ((40, ERR_PROCESS_BLOCK, "prepare"),
                           (len(blob) // 2, ERR_PROCESS_BLOCK, "renorm reads"),
                           (len(blob) - 40, ERR_CRC_CHECK, "checksum")):
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        with pytest.raises(KanziError, match=msg) as ei:
            kt.decompress(bytes(bad), device="cpu")
        assert ei.value.code == code, (pos, str(ei.value))


def _quotient_as_kernel(d, r2, ulp):
    """csrc/range.cu estimate() and correct() in numpy, with the kernel's
    arithmetic: float32 d * rcp(r2), capped at 4096 and truncated, then
    moved by one with a 64-bit multiply-compare. rcp.approx is within 1
    ulp of the rounded reciprocal: `ulp` (-1, 0, 1) picks which. Returns
    (the estimate, the result)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        rcp = np.float32(1) / r2.astype(np.float32)
        if ulp:
            toward = np.float32(np.inf if ulp > 0 else 0)
            rcp = np.where(r2 > 0, np.nextafter(rcp, toward), rcp)
        qf = d.astype(np.float32) * rcp
    est = np.fmin(qf, np.float32(4096)).astype(np.uint32).astype(np.uint64)
    p = est * r2                               # <= d + r2 < 2^61 (checked)
    over = p > d
    q = np.where(over, est - 1, est)
    up = ~over & ((d - np.where(over, 0, p)) >= r2)
    q = np.where(up, q + 1, q)
    return est.astype(np.int64), np.minimum(q, 4095).astype(np.int64)


@pytest.mark.parametrize("ulp", [-1, 0, 1])
def test_range_quotient_estimate_is_exact(ulp):
    # K8's float estimate and its correction against exact integer
    # division, on the state widths the coder has (d, r2 < 2^60)
    rng = np.random.default_rng(60)
    n = 10 ** 6
    bits = rng.integers(0, 61, n)
    r2 = rng.integers(0, 1 << 60, n, dtype=np.uint64) >> (60 - bits).astype(np.uint64)
    r2 = np.maximum(r2, 1)
    # half the pairs near a chosen quotient, half with any d
    q = rng.integers(0, 5000, n).astype(np.uint64)
    near = q * r2 + rng.integers(0, 1 << 62, n, dtype=np.uint64) % r2
    near = np.where(near < (1 << 60), near, (1 << 60) - 1)
    anyd = rng.integers(0, 1 << 60, n, dtype=np.uint64)
    d = np.where(np.arange(n) % 2 == 0, near, anyd).astype(np.uint64)
    # the edges: r2 of 0, 1, 2^48 - 1 and wider; d at and next to the
    # multiples of r2 around the cap, and past it
    er, ed = [], []
    for r in (0, 1, 2, 3, (1 << 48) - 1, 1 << 48, (1 << 52) + 7, (1 << 60) - 1):
        for k in (0, 1, 2, 4094, 4095, 4096, 4097, 1 << 20):
            for delta in (-1, 0, 1):
                v = k * r + delta
                if 0 <= v < 1 << 60:
                    er.append(r)
                    ed.append(v)
        er.append(r)
        ed.append((1 << 60) - 1)
    r2 = np.concatenate([r2, np.array(er, np.uint64)])
    d = np.concatenate([d, np.array(ed, np.uint64)])
    est, got = _quotient_as_kernel(d, r2, ulp)
    safe = np.maximum(r2, 1)
    exact = np.where(r2 == 0, 4095, np.minimum(d // safe, 4095)).astype(np.int64)
    assert np.array_equal(got, exact)
    # the estimate lies within 1 of the capped quotient, which keeps the
    # product est * r2 below 2^61; r2 == 0 estimates 4096
    pos = r2 > 0
    capped = np.minimum(d[pos] // r2[pos], 4096).astype(np.int64)
    assert np.abs(est[pos] - capped).max() <= 1
    assert (est[pos].astype(object) * r2[pos].astype(object) < (1 << 61)).all()
    assert (est[~pos] == 4096).all()
    assert (d // safe >= 4096).sum() > 1000 and (~pos).sum() >= 1
