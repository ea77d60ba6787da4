"""Range-coder ops and the device range engine of the PyTorch port against
the JAX package: encode_chunks and decode_chunks equal kanzi_tpu.ops.range
exactly on the same seeded inputs; the engine's payloads equal the host
C++ encoder's and kanzi_tpu's device engine's, at 32 KiB chunk edges, with
reduced logRange on small final chunks and on degenerate chunks; the
sequential chunk walk decodes them; a corrupted block raises."""

import functools
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
from torch_range_inputs import hostile_range_block

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


# --- the chunk walk's native step (kz_range_dec_step) ---------------------

def _kind(name, seed, n):
    """`n` bytes of one kind of the benchmark's mixed corpus."""
    rng = np.random.default_rng(seed)
    if name == "text":
        arr = np.frombuffer((_TEXT * (n // len(_TEXT) + 1))[:n], np.uint8).copy()
        idx = rng.integers(0, n, n // 64)
        arr[idx] = rng.integers(32, 127, len(idx), dtype=np.uint8)
        return arr.tobytes()
    if name == "int32_deltas":
        return np.cumsum(rng.integers(-3, 4, n // 4, dtype=np.int32)).astype("<i4").tobytes()
    if name == "dna":
        return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()
    if name == "sparse_zeros":
        z = np.zeros(n, np.uint8)
        idx = rng.integers(0, n, n // 50)
        z[idx] = rng.integers(1, 256, len(idx), dtype=np.uint8)
        return z.tobytes()
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _lz_range(data):
    """A block as the LZ+RANGE Writer stores it: its LZ output (the block
    itself where LZ declines) and that output's RANGE payload."""
    try:
        post, _ = native.transform_forward(3, data, {"bsVersion": 6, "blockSize": len(data),
                                                     "size": len(data)}, 2 * len(data))
    except native.NativeSkip:
        post = bytes(data)
    payload, _bits = native.entropy_encode(4, np.frombuffer(post, np.uint8), {"bsVersion": 6})
    return post, payload


def _chunk_reads(post):
    """Each chunk's renorm reads (None for a header-only chunk), from the
    chunk encoded alone: the range coder starts each chunk afresh."""
    reads = []
    for c in range(0, len(post), CHUNK):
        piece = np.frombuffer(post[c:c + CHUNK], np.uint8)
        _t, _h, hdr_bits, flags, _s = native.range_prepare(piece)
        bits = native.entropy_encode(4, piece, {"bsVersion": 6})[1]
        reads.append(None if flags[0] == 2 else (bits - int(hdr_bits[0]) - 60) // 28)
    return reads


def _write_bits(bits: np.ndarray, value: int, width: int) -> np.ndarray:
    return np.concatenate([bits, np.array([(value >> (width - 1 - i)) & 1
                                           for i in range(width)], np.uint8)])


def _slots32768_payload():
    """A block of two chunks: a text chunk (logRange 12), then a chunk
    whose header carries logRange 15 (32768 slots: ten symbols, nine of
    frequency 3000), with random coder bytes after it. Returns (payload,
    sizes, reads of its chunks: the second's are not needed)."""
    piece = np.frombuffer(_TEXT[:CHUNK], np.uint8)
    first, bits = native.entropy_encode(4, piece, {"bsVersion": 6})
    stream = np.unpackbits(np.frombuffer(first, np.uint8))[:bits]
    stream = _write_bits(stream, 1, 1)                   # a listed alphabet
    stream = _write_bits(stream, 1, 5)                   # two mask bytes
    stream = _write_bits(stream, 0xFF, 8)
    stream = _write_bits(stream, 0x03, 8)                # symbols 0-9
    stream = _write_bits(stream, 15 - 8, 3)              # logRange 15
    for i in range(1, 10, 6):                            # groups of 6, llr 4
        stream = _write_bits(stream, 12, 4)
        for _ in range(i, min(i + 6, 10)):
            stream = _write_bits(stream, 3000 - 1, 12)
    rng = np.random.default_rng(32768)
    stream = np.concatenate([stream, np.unpackbits(rng.integers(0, 256, 40000, dtype=np.uint8))])
    return np.packbits(stream).tobytes(), [CHUNK, CHUNK], [_chunk_reads(piece.tobytes())[0]]


def _walk_batch(case):
    """(payloads, out lengths, each block's chunk reads) of a batch."""
    if case == "slots_32768":
        payload, sizes, reads = _slots32768_payload()
        text_post, text_payload = _lz_range(_kind("text", 5, 90000))
        return ([payload, text_payload], [sum(sizes), len(text_post)],
                [reads + [0], _chunk_reads(text_post)])
    if case == "header_only":
        rng = np.random.default_rng(11)
        blocks = [b"q" * CHUNK + _TEXT[:20000] + b"\0" * (CHUNK + 500),
                  rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()]
        posts = blocks
        payloads = [native.entropy_encode(4, np.frombuffer(b, np.uint8), {"bsVersion": 6})[0]
                    for b in blocks]
    else:
        kinds = ([case] * 3 if case != "mixed" else
                 ["text", "int32_deltas", "dna", "sparse_zeros", "random"])
        made = [_lz_range(_kind(k, 100 + i, 60000 + 23000 * i)) for i, k in enumerate(kinds)]
        posts, payloads = [m[0] for m in made], [m[1] for m in made]
    return payloads, [len(p) for p in posts], [_chunk_reads(p) for p in posts]


WALK_CASES = ["text", "int32_deltas", "dna", "sparse_zeros", "random", "mixed",
              "header_only", "slots_32768"]


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_step_rows_equal_chunk_batch(case):
    # chunk by chunk and block by block, kz_range_dec_step's rows, header
    # ends, single symbols and held slot tables equal chunk_batch's, and
    # the launch's f2s rows equal the stacked rows'
    payloads, lens, reads = _walk_batch(case)
    srcs = [np.frombuffer(p, np.uint8) for p in payloads]
    walk = native.RangeWalk(payloads)
    flat = range_device._alloc_rows(len(srcs), range_device._BUF_CAP, False)
    held, single_seen, wide_seen = [None] * len(srcs), 0, 0
    live = np.arange(len(srcs), dtype=np.int32)
    start, index = 0, 0
    while len(live):
        sizes = np.minimum(CHUNK, np.array(lens)[live] - start).astype(np.int32)
        rows = range_device._rows(flat, len(live),
                                  range_device._width(walk, live, range_device._BUF_CAP))
        walk.step(live, sizes, range_device._BUF_CAP, rows)
        want_rows = []
        for k, b in enumerate(live):
            end, single, row, held[b] = range_device.chunk_batch(
                srcs[b], int(walk.pos[b]), int(sizes[k]), None, held[b])
            assert rows["hdr_end"][k] == end, (case, index, b)
            n = len(held[b])
            assert walk.held_len[b] == n
            assert np.array_equal(walk.held[b, :n], held[b]) and not walk.held[b, n:].any()
            if row is None:
                assert rows["single"][k] == single
                single_seen += 1
                walk.pos[b] = end
                continue
            assert rows["single"][k] == -1
            # the decode reads a row's first nbytes bytes, and no others
            nb = int(row["nbytes"][0])
            assert np.array_equal(rows["bufs"][k, :nb], row["bufs"][0, :nb])
            for name in ("nbytes", "nbits", "rng_tables", "shifts", "nvalid", "bound"):
                assert np.array_equal(rows[name][k], row[name][0]), (case, index, b, name)
            want_rows.append((k, row))
            walk.pos[b] = end + 60 + 28 * reads[b][index]
        if want_rows:
            todo = np.array([k for k, _ in want_rows])
            launch = {name: rows[name][todo] for name in ("bound",)}
            range_device._slots(walk, flat, launch, live[todo])
            want = range_device.device_io.stack([row for _, row in want_rows])["f2s"]
            assert np.array_equal(launch["f2s"], want)
            wide_seen += want.shape[1] == 32768
        start += CHUNK
        index += 1
        live = live[start < np.array(lens)[live]]
    assert index == max(-(-n // CHUNK) for n in lens)
    if case == "header_only":
        assert single_seen >= 2
    if case == "slots_32768":
        assert wide_seen == 1 and walk.held_len[0] == 32768


_DEEP = 60 << 20         # a header's byte in the 64 MiB payload


@functools.lru_cache(maxsize=1)
def _deep_payload():
    """64 MiB of random bytes and a text chunk's RANGE payload (header and
    coder stream) to place in them."""
    rng = np.random.default_rng(64)
    chunk, bits = native.entropy_encode(4, np.frombuffer(_TEXT[:CHUNK], np.uint8),
                                        {"bsVersion": 6})
    return rng.integers(0, 256, 64 << 20, dtype=np.uint8), chunk, bits


@pytest.mark.parametrize("offset", range(8))
def test_header_parse_deep_in_a_payload_equals_a_copy_from_its_byte(offset):
    # a chunk header at bit 8 * 60 MiB + offset of a 64 MiB payload parses
    # as the same header of a copy that starts at its byte: the reader
    # starts at the header's byte, whatever lies before it
    noise, chunk, bits = _deep_payload()
    big = noise.copy()
    window = np.unpackbits(big[_DEEP:_DEEP + len(chunk) + 1])
    window[offset:offset + bits] = np.unpackbits(np.frombuffer(chunk, np.uint8))[:bits]
    big[_DEEP:_DEEP + len(chunk) + 1] = np.packbits(window)
    pos = 8 * _DEEP + offset
    got = native.range_dec_chunk(big, pos, range_device._BUF_CAP)
    moved = native.range_dec_chunk(big[_DEEP:].copy(), offset, range_device._BUF_CAP)
    assert got[0] == moved[0] + 8 * _DEEP and got[4] == 0 and got[3] == 12
    for g, m in zip(got[1:], moved[1:]):
        assert np.array_equal(np.asarray(g), np.asarray(m))
    # the walk's step reads the same header there
    walk = native.RangeWalk([big])
    walk.pos[0] = pos
    rows = range_device._rows(range_device._alloc_rows(1, range_device._BUF_CAP, False), 1,
                              range_device._BUF_CAP - 16)
    walk.step(np.zeros(1, np.int32), np.full(1, CHUNK, np.int32), range_device._BUF_CAP, rows)
    assert rows["hdr_end"][0] == got[0] and rows["shifts"][0] == 12
    assert np.array_equal(rows["rng_tables"][0], got[1])
    assert np.array_equal(rows["bufs"][0], got[6][:range_device._BUF_CAP - 16])


@pytest.mark.parametrize("case", ["header_rejected", "held_slot", "cut_row"])
def test_hostile_walk_outcomes_equal_the_host(case):
    # beside a good block in one batch, a hostile block decodes to the
    # host decoder's bytes or is rejected as before the native step: a
    # header the host rejects as NativeError (the prepare's error code),
    # a decode the host fails as KanziError
    good = _TEXT[1000:2500]
    good_payload, _ = native.entropy_encode(4, np.frombuffer(good, np.uint8), {"bsVersion": 6})
    payload, n = hostile_range_block(case)
    try:
        host = native.entropy_decode(4, payload, n, {"bsVersion": 6})
    except native.NativeError:
        host = None
    _kernels.reset_counts()
    got_good, got = range_device.range_decode_many([good_payload, payload], [len(good), n],
                                                   "cpu")
    assert got_good.tobytes() == good
    if case == "held_slot":
        assert host is not None and got.tobytes() == host
        assert host[CHUNK:CHUNK + 4] == b"AAAA"
    elif case == "header_rejected":
        assert host is None and isinstance(got, native.NativeError)
        assert "prepare failed (err=-3)" in str(got)
    else:
        assert host is None and isinstance(got, KanziError)
        assert got.code == ERR_PROCESS_BLOCK
    assert _kernels.walk_counts == {"range_steps": -(-n // CHUNK),
                                    "range_reparsed": int(case == "cut_row")}


@pytest.mark.parametrize("case", ["lockstep", "one_block", "reparse"])
def test_walk_counts_steps_and_reparses(case):
    # one native step a chunk index of the batch, one re-parse a retried
    # row; one plain decode a chunk index with a chunk to decode, a
    # block alone included (range_decode_device)
    rng = np.random.default_rng(3)
    if case == "reparse":
        blocks = [hostile_range_block("cut_row"), hostile_range_block("cut_row")]
        want = {"range_steps": 1, "range_reparsed": 2}, 2
    else:
        datas = [b"a" * (2 * CHUNK) + _TEXT[:40],       # chunks 0, 1 header-only
                 _TEXT[:60],
                 b"b" * CHUNK + rng.integers(0, 9, 50, dtype=np.uint8).tobytes()]
        blocks = [(native.entropy_encode(4, np.frombuffer(d, np.uint8), {"bsVersion": 6})[0],
                   len(d)) for d in datas]
        # chunk index 0: one row (block 1); 1: one (block 2); 2: one (block 0)
        want = {"range_steps": 3, "range_reparsed": 0}, 3
    if case == "one_block":
        for (payload, n), data in zip(blocks, datas):
            _kernels.reset_counts()
            assert range_device.range_decode_device(payload, n, "cpu") == data
            assert _kernels.walk_counts == {"range_steps": -(-n // CHUNK), "range_reparsed": 0}
            assert _kernels.plain_calls["range_decode"] == 1
        return
    _kernels.reset_counts()
    got = range_device.range_decode_many([p for p, _ in blocks], [n for _, n in blocks], "cpu")
    assert _kernels.walk_counts == want[0]
    assert _kernels.plain_calls["range_decode"] == want[1]
    if case == "lockstep":
        assert [g.tobytes() for g in got] == datas
    else:
        assert all(isinstance(g, KanziError) for g in got)
