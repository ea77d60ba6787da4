"""Kernels of the PyTorch port against their plain versions on a CUDA card.

Marked `gpu`; each test skips without a card. This file imports neither
jax nor kanzi_tpu, so it runs where only PyTorch is installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels, native, parallel
from kanzi_tpu_torch.core import KanziError
from kanzi_tpu_torch.entropy import ans_device, range_device
from kanzi_tpu_torch.entropy.huffman_device import (DeviceHuffmanEngine,
                                                    huffman_decode_device,
                                                    huffman_encode_device)
from kanzi_tpu_torch.ops import ans as ops_ans, block_stats, huffman as ops_huffman
from kanzi_tpu_torch.ops import bwt_inverse as ops_bi, fpaq_batch as ops_fb
from kanzi_tpu_torch.ops import range as ops_range, suffix_sort as ops_ss
from kanzi_tpu_torch.ops.state import to_port_state
from specmodel import ans as spec_ans
from torch_edge_inputs import (ans_u32_cases, decode_cases, encode_cases, pack_cases,
                              range_encode_cases, range_u32_cases)

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(n):
    with open(os.path.join(ROOT, "SURVEY.md"), "rb") as fh:
        return fh.read()[:n]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_block_stats_kernels_match_plain(card):
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 256, (4, (1 << 20) + 7), dtype=np.uint8)  # any N
    blocks[1] %= 3
    h, e = block_stats.block_stats(torch.from_numpy(blocks).to(card))
    torch.cuda.synchronize()
    want = np.stack([np.bincount(b, minlength=256) for b in blocks])
    assert np.array_equal(h.cpu().numpy(), want)
    lengths = torch.full((4,), blocks.shape[1], dtype=torch.int32, device=card)
    assert (e - block_stats._entropy_plain(h, lengths)).abs().max().item() <= 1


def _hold_block_stats(x):
    """The fused kernel against _block_stats_plain on x: histograms exact,
    entropy within 1 (float32 sums in another order) and equal to the
    standalone K2 on the same histograms; histograms_u8 alone equal too."""
    B, N = x.shape
    h, e = block_stats.block_stats(x)
    hp, ep = block_stats._block_stats_plain(x)
    k2 = block_stats.entropy1024(h, torch.full((B,), N, dtype=torch.int32, device=x.device))
    h1 = block_stats.histograms_u8(x)
    torch.cuda.synchronize()
    assert torch.equal(h, hp)
    assert torch.equal(h1, hp)
    assert (e - ep).abs().max().item() <= 1
    assert torch.equal(e, k2)


def _corpus_rows(n):
    """A constant row, a DNA row and an int32-delta row of n bytes."""
    rng = np.random.default_rng(12)
    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    delta = np.cumsum(rng.integers(-3, 4, -(-n // 4), dtype=np.int32)).astype("<i4")
    return np.stack([np.full(n, 0, np.uint8), dna, delta.view(np.uint8)[:n]])


def test_block_stats_fused_corpus_rows(card):
    _hold_block_stats(torch.from_numpy(_corpus_rows(4 << 20)).to(card))


@pytest.mark.parametrize("n", [0, 1, 15, 17, 1024, (4 << 20) + 7])
def test_block_stats_fused_row_lengths(card, n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (3, n), dtype=np.uint8)
    x[1] %= 5
    _hold_block_stats(torch.from_numpy(x).to(card))


@pytest.mark.parametrize("shift", [1, 7, 15])
def test_block_stats_fused_misaligned_base(card, shift):
    B, N = 4, 65536 + 5
    rng = np.random.default_rng(shift)
    flat = torch.empty(B * N + shift, dtype=torch.uint8, device=card)
    x = flat[shift:].view(B, N)
    x.copy_(torch.from_numpy(rng.integers(0, 256, (B, N), dtype=np.uint8)))
    assert x.data_ptr() % 16 == shift % 16
    _hold_block_stats(x)


@pytest.mark.parametrize("B", [1, 16, 64])
def test_block_stats_fused_batch_sizes(card, B):
    rng = np.random.default_rng(B)
    _hold_block_stats(torch.from_numpy(rng.integers(0, 256, (B, 65536 + 3),
                                                    dtype=np.uint8)).to(card))
    # the cluster size: the c <= 8 whose waves of resident clusters cost
    # least, a wave costing 96 KiB plus a CTA's share of a row (ties to the
    # larger c)
    N = 65536 + 3
    resident = np.zeros(8, np.int64)
    c = _kernels.query("kz_block_stats_cluster", B, N, resident.ctypes.data)
    assert 1 <= c <= 8 and resident.min() > 0
    cost = [-(-B // resident[k - 1]) * (96 * 1024 + -(-N // k)) for k in range(1, 9)]
    assert cost[c - 1] == min(cost) and all(x > cost[c - 1] for x in cost[c:])


def test_block_stats_fused_two_streams(card):
    rng = np.random.default_rng(13)
    xs = [torch.from_numpy(rng.integers(0, hi, (16, 1 << 20), dtype=np.uint8)).to(card)
          for hi in (256, 3)]
    want = [block_stats._block_stats_plain(x) for x in xs]
    streams = [torch.cuda.Stream(card) for _ in xs]
    torch.cuda.synchronize()
    got = []
    for x, st in zip(xs, streams):
        with torch.cuda.stream(st):
            got.append(block_stats.block_stats(x))
    torch.cuda.synchronize()
    for (h, e), (hp, ep) in zip(got, want):
        assert torch.equal(h, hp)
        assert (e - ep).abs().max().item() <= 1


def test_block_stats_counts_one_fused_launch(card):
    x = torch.zeros(2, 4096, dtype=torch.uint8, device=card)
    _kernels.reset_counts()
    block_stats.block_stats(x)
    assert _kernels.launches["block_stats"] == 1
    assert _kernels.launches["histograms_u8"] == _kernels.launches["entropy1024"] == 1
    # a batch the kernel refuses raises; nothing runs on the CPU instead
    with pytest.raises(ValueError):
        block_stats.block_stats(torch.zeros(65536, 1, dtype=torch.uint8, device=card))
    assert sum(_kernels.plain_calls.values()) == 0


def test_pack_lanes_kernel_matches_plain(card):
    rng = np.random.default_rng(3)
    L = 64
    ln = rng.integers(1, 13, (4, 256))
    tables = ((ln << 12) | (rng.integers(0, 1 << 12, (4, 256)) & ((1 << ln) - 1)))
    for dtype, frag in ((np.uint8, ops_huffman.FRAG), (np.int32, 512)):
        arrays = {"syms": rng.integers(0, 256, (L, frag)).astype(dtype),
                  "lane_len": rng.integers(0, frag + 1, L).astype(np.int32),
                  "table_idx": rng.integers(0, 4, L).astype(np.int32),
                  "tables": tables.astype(np.int32)}
        keys = ("syms", "lane_len", "table_idx", "tables")
        cpu = to_port_state(arrays, "cpu")
        gpu = to_port_state(arrays, card)
        want = ops_huffman.pack_lanes(*(cpu[k] for k in keys))
        got = ops_huffman.pack_lanes(*(gpu[k] for k in keys))
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_decode_lanes_kernel_matches_plain(card):
    data = _text(40000)
    payload, _ = native.entropy_encode(1, np.frombuffer(data, np.uint8),
                                       {"bsVersion": 6})
    dtables, lanes, flags, _aux = native.huffman_dec_prepare(
        np.frombuffer(payload, np.uint8), len(data))
    arrays = {"lanes": lanes, "dtables": dtables,
              "table_idx": np.repeat(np.nonzero(flags == 0)[0].astype(np.int32), 4)}
    cpu = to_port_state(arrays, "cpu")
    gpu = to_port_state(arrays, card)
    keys = ("lanes", "table_idx", "dtables")
    want = ops_huffman.decode_lanes(*(cpu[k] for k in keys))
    got = _decode_lanes(*(gpu[k] for k in keys))[0]
    assert torch.equal(got.cpu(), want)
    assert huffman_decode_device(payload, len(data), card) == data


@pytest.mark.parametrize("level", [2, 3])
def test_slice_on_card(card, level):
    rng = np.random.default_rng(level)
    data = _text(300000) + rng.integers(0, 4, 300000, dtype=np.uint8).tobytes()
    _kernels.reset_counts()
    blob = kt.compress(data, level=level, checksum=32, block_size=1 << 18)
    assert blob == kt.compress(data, level=level, checksum=32,
                               block_size=1 << 18, device=None)
    assert kt.decompress(blob) == data
    assert _kernels.launches["pack_lanes"] > 0
    assert _kernels.launches["decode_lanes"] > 0
    assert sum(_kernels.plain_calls.values()) == 0


def _decode_lanes(lanes, table_idx, dtables):
    """decode_lanes with its table index flags, which must all be 0."""
    bad = torch.ones(len(lanes), dtype=torch.int32, device=lanes.device)
    out = ops_huffman.decode_lanes(lanes, table_idx, dtables, bad)
    assert not bad.any()
    return (out,)


def _both(fn, arrays, keys, card, *extra):
    """fn on the plain route (CPU tensors) and the kernel route (card)."""
    cpu = to_port_state(arrays, "cpu")
    gpu = to_port_state(arrays, card)
    want = fn(*(cpu[k] for k in keys), *extra)
    got = fn(*(gpu[k] for k in keys), *extra)
    torch.cuda.synchronize()
    return [g.cpu() for g in got], list(want)


@pytest.mark.parametrize("order", [0, 1])
def test_ans_kernels_match_plain(card, order):
    data = np.frombuffer(_text(40000), np.uint8)
    _preps, arrays = ans_device.DeviceANSEngine(order, "cpu").encode_batch([data])
    got, want = _both(ops_ans.encode_chunks, arrays,
                      ("ans_syms", "ngroups", "ans_tables"), card)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    payload, _ = ans_device.ans_encode_device(data, order, card)
    assert payload == native.entropy_encode(5 if order == 0 else 8, data,
                                            {"bsVersion": 6})[0]
    _kernels.reset_counts()
    assert ans_device.ans_decode_device(payload, len(data), order, card) == data.tobytes()
    assert _kernels.launches["ans_decode"] == 1


def test_range_kernels_match_plain(card):
    data = np.frombuffer(_text(70000), np.uint8)
    _preps, arrays = range_device.DeviceRangeEngine("cpu").encode_batch([data])
    C = range_device._CHUNK
    got, want = _both(ops_range.encode_chunks, arrays,
                      ("rng_syms", "nvalid", "rng_tables", "shifts"), card)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    payload, _ = range_device.range_encode_device(data, card)
    assert payload == native.entropy_encode(4, data, {"bsVersion": 6})[0]
    # the first chunk's coder stream, kernel against plain
    src = np.frombuffer(payload, np.uint8)
    hdr_end, t, f2s, shift, _flag, _aux, buf = native.range_dec_chunk(
        src, 0, 2 * C + 8192)
    nb = (8 * len(src) - hdr_end + 7) >> 3
    arrays = {"bufs": buf[None, :nb], "nbytes": np.array([nb], np.int32),
              "rng_tables": t[None], "f2s": f2s[None],
              "shifts": np.array([shift], np.int32),
              "nvalid": np.array([C], np.int32)}
    got, want = _both(ops_range.decode_chunks, arrays,
                      ("bufs", "nbytes", "rng_tables", "f2s", "shifts", "nvalid"),
                      card, C)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert range_device.range_decode_device(payload, len(data), card) == data.tobytes()


@pytest.mark.parametrize("kw", [dict(level=5),
                                dict(entropy="ANS1", transform="NONE"),
                                dict(entropy="RANGE", transform="LZ")])
def test_ans_range_slice_on_card(card, kw):
    rng = np.random.default_rng(5)
    data = _text(300000) + rng.integers(0, 4, 300000, dtype=np.uint8).tobytes()
    _kernels.reset_counts()
    blob = kt.compress(data, checksum=32, block_size=1 << 18, jobs=2, **kw)
    assert blob == kt.compress(data, checksum=32, block_size=1 << 18, jobs=2,
                               device=None, **kw)
    assert kt.decompress(blob) == data
    name = "range" if kw.get("entropy") == "RANGE" else "ans"
    assert _kernels.launches[f"{name}_encode"] > 0
    assert _kernels.launches[f"{name}_decode"] > 0
    assert sum(_kernels.plain_calls.values()) == 0


_ANS_KEYS = ("bufs", "nbytes", "states0", "f2s", "dtabs", "ngroups", "lr")
_RANGE_KEYS = ("bufs", "nbytes", "rng_tables", "f2s", "shifts", "nvalid")


def _spec_ans_rows(order, log_range, n):
    """The device rows of a spec-model stream with a chosen logRange."""
    enc = spec_ans.SpecANSEncoder(order=order, log_range=log_range)
    enc.write(_text(n))
    batch, _ = ans_device.decode_batch(np.frombuffer(enc.finish()[0], np.uint8),
                                       n, order)
    return {k: np.array(v) for k, v in batch.items()}


def _stack_rows(parts):
    """Rows of several batches as one: bufs and f2s zero-padded to the
    widest."""
    for k in ("f2s", "bufs"):
        width = max(p[k].shape[1] for p in parts)
        for p in parts:
            p[k] = np.pad(p[k], ((0, 0), (0, width - p[k].shape[1])))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _hold_ans_decode(arrays, order, card):
    """K6 against its plain version on the same rows; returns (syms, nread)."""
    glen = int(arrays["ngroups"].max())
    got, want = _both(ops_ans.decode_chunks, arrays, _ANS_KEYS, card, order, glen)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    return got


def test_ans_decode_kernel_mixed_log_ranges(card):
    # order 0, one call: rows at logRange 10 and 14 decode from shared
    # memory, rows at 15 and a synthetic row at 16 from the scratch tables
    parts = [_spec_ans_rows(0, lr, n)
             for lr, n in ((10, 6000), (14, 7000), (15, 20000))]
    rng = np.random.default_rng(16)
    parts.append({   # 256 symbols of frequency 256, random states and bytes
        "bufs": rng.integers(0, 256, (1, 30000), dtype=np.uint8),
        "nbytes": np.array([30000], np.int32),
        "states0": rng.integers(1 << 15, 1 << 32, (1, 4)).astype(np.uint32),
        "f2s": np.repeat(np.arange(256, dtype=np.uint8), 256)[None],
        "dtabs": np.stack([np.full(256, 256), 256 * np.arange(256)])[None].astype(np.int32),
        "ngroups": np.array([4096], np.int32), "lr": np.array([16], np.int32)})
    arrays = _stack_rows(parts)
    assert sorted(set(arrays["lr"].tolist())) == [10, 14, 15, 16]
    _kernels.reset_counts()
    syms, nread = _hold_ans_decode(arrays, 0, card)
    assert _kernels.launches["ans_decode"] == 1
    real = len(arrays["lr"]) - 1
    assert (nread[:real].numpy() == arrays["nbytes"][:real]).all()


def test_ans_decode_kernel_order1_log_ranges(card):
    # order 1 at logRange 10 and 14 (the spec encoder takes log_range - 1)
    arrays = _stack_rows([_spec_ans_rows(1, 11, 5000), _spec_ans_rows(1, 15, 6000)])
    assert arrays["lr"].tolist() == [10, 14]
    syms, nread = _hold_ans_decode(arrays, 1, card)
    assert (nread.numpy() == arrays["nbytes"]).all()
    for r, n in enumerate((5000, 6000)):
        g = int(arrays["ngroups"][r])
        want = np.frombuffer(_text(n), np.uint8)[:4 * g].reshape(4, g).T
        assert np.array_equal(syms[r, :g].numpy(), want)


def test_ans_decode_kernel_error_flag(card):
    # a row cut short and a row whose logRange its f2s row cannot hold
    data = np.frombuffer(_text(40000), np.uint8)
    payload, _ = native.entropy_encode(5, data, {"bsVersion": 6})
    batch, _ = ans_device.decode_batch(np.frombuffer(payload, np.uint8), len(data), 0)
    arrays = {k: np.array(v) for k, v in batch.items()}
    arrays["nbytes"][0] -= 2
    arrays["lr"][1] = 13
    _syms, nread = _hold_ans_decode(arrays, 0, card)
    assert nread[0] == -1 and nread[1] == -1
    assert (nread[2:].numpy() == arrays["nbytes"][2:]).all()


def _range_cases():
    """The cases of tests/test_torch_range.py that launch K8, drawn in the
    same order from the same seed."""
    rng = np.random.default_rng(4)
    draws = {}
    for name, hi, n in (("random", 256, 20000), ("narrow", 8, 40000),
                        ("small", 256, 100), ("chunk_edge", 256, 16384 + 33),
                        ("n31", 256, 31), ("chunk32k_edge", 256, range_device._CHUNK + 97),
                        ("degenerate", 200, 500)):
        draws[name] = rng.integers(0, hi, n, dtype=np.uint8).tobytes()
    return {k: draws[k] for k in ("degenerate", "n31", "narrow", "chunk32k_edge")}


def test_range_decode_kernel_matches_plain(card):
    # every chunk of the four cases as one batch, plus a copy of one row
    # whose byte count ends inside its last read
    rows, sizes = [], []
    for name, data in _range_cases().items():
        payload, _ = native.entropy_encode(4, np.frombuffer(data, np.uint8),
                                           {"bsVersion": 6})
        src = np.frombuffer(payload, np.uint8)
        bit_pos = 0
        for start in range(0, len(data), range_device._CHUNK):
            size = min(range_device._CHUNK, len(data) - start)
            hdr_end, single, batch, _held = range_device.chunk_batch(src, bit_pos, size)
            assert batch is not None, name
            st = to_port_state(batch, card)
            _s, nr = ops_range.decode_chunks(*(st[k] for k in _RANGE_KEYS), size)
            nr = int(nr.cpu()[0])
            assert nr >= 0, name
            rows.append({k: np.array(v) for k, v in batch.items()})
            sizes.append((nr, size))
            bit_pos = hdr_end + 60 + 28 * nr
        assert range_device.range_decode_device(payload, len(data), card) == data
    cut = {k: v.copy() for k, v in rows[-1].items()}
    cut["nbytes"][0] = (60 + 28 * sizes[-1][0] - 1) >> 3
    rows.append(cut)
    width = max(r["bufs"].shape[1] for r in rows)
    for r in rows:
        r["bufs"] = np.pad(r["bufs"], ((0, 0), (0, width - r["bufs"].shape[1])))
    arrays = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    glen = max(s for _, s in sizes)
    got, want = _both(ops_range.decode_chunks, arrays, _RANGE_KEYS, card, glen)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[1][:-1].tolist() == [nr for nr, _ in sizes]
    assert got[1][-1] == -1


@pytest.mark.parametrize("name", list(encode_cases()))
def test_ans_encode_kernel_edge_rows(card, name):
    # every step emits (the in-place move at npairs = 4G), ngroups 0 /
    # partial / out of range, mixed ngroups, u16 indices at S = 65536
    syms, ngroups, tables = encode_cases()[name]
    arrays = {"ans_syms": syms, "ngroups": ngroups, "ans_tables": tables}
    got, want = _both(ops_ans.encode_chunks, arrays,
                      ("ans_syms", "ngroups", "ans_tables"), card)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(decode_cases()))
def test_decode_lanes_kernel_edge_inputs(card, name):
    # four lanes a staged table, tables in no order (read from device
    # memory), bit positions past odd strides, any u16 entry
    lanes, table_idx, dtables = decode_cases()[name]
    arrays = {"lanes": lanes, "table_idx": table_idx, "dtables": dtables}
    got, want = _both(_decode_lanes, arrays,
                      ("lanes", "table_idx", "dtables"), card)
    assert torch.equal(got[0], want[0])


def test_decode_lanes_kernel_many_lanes(card):
    # more lanes than the card's SMs hold at eight a CTA
    lanes, table_idx, dtables = decode_cases()["shared_quads"]
    reps = -(-8 * torch.cuda.get_device_properties(card).multi_processor_count // len(lanes)) + 1
    arrays = {"lanes": np.tile(lanes, (reps, 1)), "dtables": dtables,
              "table_idx": np.tile(table_idx, reps)}
    got, want = _both(_decode_lanes, arrays,
                      ("lanes", "table_idx", "dtables"), card)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("name", list(range_encode_cases()))
def test_range_encode_kernel_edge_rows(card, name):
    # nvalid edges, bytes past nvalid, mixed lengths, shifts in and outside
    # [0, 63], two emissions a byte, a single symbol, random u32 tables
    syms, nvalid, tables, shifts = range_encode_cases()[name]
    arrays = {"rng_syms": syms, "nvalid": nvalid, "rng_tables": tables, "shifts": shifts}
    got, want = _both(ops_range.encode_chunks, arrays,
                      ("rng_syms", "nvalid", "rng_tables", "shifts"), card)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(range_u32_cases()))
def test_range_kernels_u32_tables(card, name):
    # K7 and K8 read the table planes as u32, as their plain versions do
    (syms, nvalid, tables, shifts), dec = range_u32_cases()[name]
    arrays = {"rng_syms": syms, "nvalid": nvalid, "rng_tables": tables, "shifts": shifts}
    got, want = _both(ops_range.encode_chunks, arrays,
                      ("rng_syms", "nvalid", "rng_tables", "shifts"), card)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bufs, dtables, f2s, dshifts, dnvalid, glen = dec
    arrays = {"bufs": bufs, "nbytes": np.full(len(bufs), bufs.shape[1], np.int32),
              "rng_tables": dtables, "f2s": f2s, "shifts": dshifts, "nvalid": dnvalid}
    got, want = _both(ops_range.decode_chunks, arrays, _RANGE_KEYS, card, glen)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want[1].max() > 0


@pytest.mark.parametrize("name", list(pack_cases()))
def test_pack_lanes_kernel_edge_inputs(card, name):
    # frag 4096 / 512 / 37, lane_len edges, symbols above 255, wide codes,
    # lengths 0 and 13-40, full words; a negative entry flags its lane
    syms, lane_len, table_idx, tables = pack_cases()[name]
    arrays = {"syms": syms, "lane_len": lane_len, "table_idx": table_idx,
              "tables": tables}
    keys = ("syms", "lane_len", "table_idx", "tables")
    if name != "negative_entry":
        got, want = _both(ops_huffman.pack_lanes, arrays, keys, card)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        return
    gpu = to_port_state(arrays, card)
    words, nbits = ops_huffman.pack_lanes(*(gpu[k] for k in keys))
    torch.cuda.synchronize()
    keep = [0, 1, 3]
    want = ops_huffman.pack_lanes(*(to_port_state(
        {**arrays, "syms": syms[keep], "lane_len": lane_len[keep],
         "table_idx": table_idx[keep]}, "cpu")[k] for k in keys))
    assert nbits[2].item() == -1 and not words[2].any()
    assert torch.equal(words[keep].cpu(), want[0]) and torch.equal(nbits[keep].cpu(), want[1])


def test_table_index_flag_on_card(card, monkeypatch):
    # K3 and K4 flag a table_idx outside [0, C) inside the kernel: no table
    # is read for the lane, the wrappers do not check before the launch
    lanes, table_idx, dtables = decode_cases()["shared_quads"]
    st = to_port_state({"lanes": lanes, "table_idx": table_idx,
                        "dtables": dtables}, card)
    good = _decode_lanes(st["lanes"], st["table_idx"], st["dtables"])[0]
    idx = st["table_idx"].clone()
    idx[5], idx[17] = len(dtables), -1
    with pytest.raises(ValueError, match="bad"):   # the flags have nowhere to go
        ops_huffman.decode_lanes(st["lanes"], idx, st["dtables"])
    bad = torch.empty(len(lanes), dtype=torch.int32, device=card)
    out = ops_huffman.decode_lanes(st["lanes"], idx, st["dtables"], bad)
    assert bad.nonzero().flatten().tolist() == [5, 17]
    keep = bad == 0
    assert torch.equal(out[keep], good[keep]) and not out[~keep].any()
    rng = np.random.default_rng(9)
    arrays = {"syms": rng.integers(0, 256, (8, 512)).astype(np.uint8),
              "lane_len": np.full(8, 512, np.int32),
              "table_idx": np.array([0, 1, 2, 3, 1, 0, 2, 3], np.int32),
              "tables": rng.integers(0, 1 << 15, (4, 256)).astype(np.int32)}
    p = to_port_state(arrays, card)
    keys = ("syms", "lane_len", "table_idx", "tables")
    w0, n0 = ops_huffman.pack_lanes(*(p[k] for k in keys))
    p["table_idx"][2], p["table_idx"][6] = 4, -2
    w1, n1 = ops_huffman.pack_lanes(*(p[k] for k in keys))
    assert n1.tolist() == [n if i not in (2, 6) else -1 for i, n in enumerate(n0.tolist())]
    assert not w1[[2, 6]].any() and torch.equal(w1[[0, 1, 3, 4, 5, 7]], w0[[0, 1, 3, 4, 5, 7]])
    # compress_step raises on the flag, as it does on the CPU
    blocks = rng.integers(0, 256, (2, 4096), dtype=np.uint8)
    for device in (card, "cpu"):
        with pytest.raises(ValueError, match=r"table_idx: values .*\[0, 4\)"):
            parallel.compress_step(blocks, *(p[k].to(device) for k in keys), device=device)
    # the engines raise KanziError on the flag read back with the result
    data = np.frombuffer(_text(40000), np.uint8)
    payload, _ = native.entropy_encode(1, data, {"bsVersion": 6})
    prepare = native.huffman_dec_prepare
    monkeypatch.setattr(native, "huffman_dec_prepare",
                        lambda *a: (lambda r: (r[0][:1],) + tuple(r[1:]))(prepare(*a)))
    with pytest.raises(KanziError, match="table index"):
        huffman_decode_device(payload, len(data), card)
    enc_prepare = native.huffman_prepare
    monkeypatch.setattr(native, "huffman_prepare",
                        lambda *a: (lambda r: (r[0][:0],) + tuple(r[1:]))(enc_prepare(*a)))
    with pytest.raises(KanziError, match="table index"):
        huffman_encode_device(data, card)


@pytest.mark.parametrize("name", list(ans_u32_cases()))
def test_ans_decode_kernel_u32_tables(card, name):
    # K6 reads freq and cumFreq as u32, as the plain version does
    arrays, order = ans_u32_cases()[name]
    _hold_ans_decode(arrays, order, card)


def _suffix_inputs():
    """name -> (padded (size,) int32, n_true)."""
    rng = np.random.default_rng(21)
    text = np.frombuffer(_text(1 << 20), np.uint8)
    mixed = np.concatenate([text, rng.integers(0, 256, 1 << 19, dtype=np.uint8),
                            np.zeros(1 << 18, np.uint8)])
    cases = {"pads_700_of_1024": ((rng.integers(0, 3, 1024)), 700),
             "all_pads": (rng.integers(0, 256, 1024), 0),
             "random_5000": (rng.integers(0, 256, 5000), 5000),
             "period2_65536": (np.tile([7, 9], 32768), 65536),
             "const_20000": (np.full(20000, 255), 20000),
             "text_random_zeros": (mixed, len(mixed)),
             # K9's active set: every group closes at once, slowly, or never
             "const_65536": (np.full(65536, 3), 65536),
             "period3_100000": (np.tile([5, 1, 9], 33334)[:100000], 100000),
             "n_true_1": (rng.integers(0, 256, 1024), 1),
             "n_true_2": (rng.integers(0, 2, 1024), 2),
             "n_true_1023": (rng.integers(0, 2, 1024), 1023),
             "size_minus_1": (mixed[:(1 << 21) - 1], (1 << 21) - 1),
             "dna_2^24": (rng.integers(0, 4, 1 << 24), 1 << 24),
             # many small groups beside one large one (a long zero run)
             "small_groups_one_large": (np.concatenate([
                 rng.integers(0, 256, 1 << 18), np.zeros(1 << 16, np.int64),
                 rng.integers(0, 8, 1 << 18)]), (1 << 19) + (1 << 16))}
    out = {}
    for name, (sym, n) in cases.items():
        padded = np.zeros(ops_ss._bucket(max(n, len(sym))), np.int32)
        padded[:len(sym)] = sym
        out[name] = (padded, n)
    return out


@pytest.mark.parametrize("name", list(_suffix_inputs()))
def test_prefix_double_kernel_matches_plain(card, name):
    padded, n = _suffix_inputs()[name]
    _kernels.reset_counts()
    order, rounds = ops_ss.prefix_double(torch.from_numpy(padded).to(card), n)
    torch.cuda.synchronize()
    assert _kernels.launches["prefix_double"] == 1
    want, want_rounds = ops_ss.prefix_double(torch.from_numpy(padded), n)
    assert torch.equal(order.cpu(), want) and rounds == want_rounds


def test_bwt_forward_on_card_matches_host(card):
    rng = np.random.default_rng(8)
    for data in (_text(200000), b"ab" * 30000, b"q" * 5000,
                 rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(), b"ba"):
        want, _ = native.transform_forward(1, np.frombuffer(data, np.uint8),
                                           {"blockSize": len(data)}, 2 * len(data) + 64)
        assert ops_ss.bwt_forward_device(data, card) == bytes(want), len(data)


def _textbook(blocks):
    """Textbook BWTs (last columns, primary rows) of the blocks with their
    zero bytes mapped to 1 and one 0 appended: the unique minimum makes the
    sorted rotations the sorted suffixes."""
    texts, lasts, prims = [], [], []
    for b in blocks:
        t = np.concatenate([np.where(b == 0, 1, b), [0]]).astype(np.uint8)
        sa = np.concatenate([[len(t) - 1], ops_ss.suffix_array_device(t[:-1], "cpu")])
        texts.append(t)
        lasts.append(t[(sa - 1) % len(t)])
        prims.append(int(np.nonzero(sa == 0)[0][0]))
    return np.stack(texts), np.stack(lasts), np.array(prims, np.int32)


def test_lf_walk_kernel_matches_plain(card):
    rng = np.random.default_rng(10)
    blocks = [np.frombuffer(_text(9000), np.uint8), rng.integers(0, 256, 9000, dtype=np.uint8),
              rng.integers(0, 3, 9000, dtype=np.uint8), np.tile(np.uint8([4, 0]), 4500)]
    texts, last, prim = _textbook(blocks)
    lf = ops_bi.build_lf(torch.from_numpy(last))[0].numpy()
    gpu = [torch.from_numpy(x).to(card) for x in (last, lf, prim)]
    cpu = [torch.from_numpy(x) for x in (last, lf, prim)]
    N = last.shape[1]
    for nsteps in (N, 1, 15, 16, N - 5, N + 37):
        _kernels.reset_counts()
        got = ops_bi.lf_walk(*gpu, nsteps)
        assert _kernels.launches["lf_walk"] == 1
        assert torch.equal(got.cpu(), ops_bi.lf_walk(*cpu, nsteps)), nsteps
    assert np.array_equal(ops_bi.bwt_inverse_device(last, prim, card), texts)
    # the LF table built on the card equals the host's
    tlf, tcounts = ops_bi.build_lf(gpu[0])
    assert np.array_equal(tlf.cpu().numpy(), lf)
    # an LF entry outside [0, N) is flagged by the kernel, a start by the wrapper
    bad_lf = gpu[1].clone()
    bad_lf[1, 77] = N
    bad_lf[3, 0] = -4
    with pytest.raises(ValueError, match=r"rows \[1, 3\]"):
        ops_bi.lf_walk(gpu[0], bad_lf, gpu[2], N)
    starts = gpu[2].clone()
    starts[0] = N
    with pytest.raises(ValueError, match="starts"):
        ops_bi.lf_walk(gpu[0], gpu[1], starts, N)


def test_lf_walk_kernel_wide_table(card):
    # N > 2^24: the packed table holds u64 entries; with the rule's jump
    # rounds and with none
    N = (1 << 24) + 3
    rng = np.random.default_rng(12)
    last = rng.integers(0, 256, (1, N), dtype=np.uint8)
    lf = rng.permutation(N).astype(np.int32)[None]
    starts = np.array([N - 1], np.int32)
    want = ops_bi.lf_walk(*(torch.from_numpy(x) for x in (last, lf, starts)), 40000)
    for jump in (None, 0):
        got = ops_bi.lf_walk(*(torch.from_numpy(x).to(card) for x in (last, lf, starts)),
                             40000, jump=jump)
        assert torch.equal(got.cpu(), want), jump


def _lf_inputs(seed, B, N):
    """Random last columns; lf random in range (no permutation), one row
    a cycle of three positions."""
    rng = np.random.default_rng(seed)
    last = rng.integers(0, 256, (B, N), dtype=np.uint8)
    lf = rng.integers(0, N, (B, N)).astype(np.int32)
    lf[-1] = (np.arange(N) + 1) % 3
    starts = rng.integers(0, N, B).astype(np.int32)
    return last, lf, starts


def test_lf_walk_kernel_jump_rounds(card):
    # nsteps around multiples of L = 2^k and below it, on a permutation
    # (textbook BWTs) and on a non-permutation lf with a short cycle
    rng = np.random.default_rng(14)
    blocks = [np.frombuffer(_text(5000), np.uint8), rng.integers(0, 256, 5000, dtype=np.uint8),
              rng.integers(0, 2, 5000, dtype=np.uint8)]
    _, last, prim = _textbook(blocks)
    lf = ops_bi.build_lf(torch.from_numpy(last))[0].numpy()
    N = last.shape[1]
    for inputs in ((last, lf, prim), _lf_inputs(15, 4, N)):
        gpu = [torch.from_numpy(x).to(card) for x in inputs]
        cpu = [torch.from_numpy(x) for x in inputs]
        for k in (0, 1, 3, 5, 8, 13):
            L = 1 << k
            for nsteps in sorted({0, 1, L - 1, L, L + 1, 3 * L + 5, N, N + 37}):
                _kernels.reset_counts()
                got = ops_bi.lf_walk(*gpu, nsteps, jump=k)
                assert _kernels.launches["lf_walk"] == 1
                assert torch.equal(got.cpu(), ops_bi.lf_walk(*cpu, nsteps)), (k, nsteps)


def test_lf_walk_kernel_bad_rows_with_jumps(card):
    # a row flagged bad is skipped by the doubling rounds, the checkpoints
    # and the segments: the call raises, and the context stays usable
    last, lf, starts = _lf_inputs(16, 4, 3000)
    gpu = [torch.from_numpy(x).to(card) for x in (last, lf, starts)]
    bad_lf = gpu[1].clone()
    bad_lf[0, 2999] = 1 << 30
    bad_lf[2, 10] = -1
    for k in (2, 6, 11):
        with pytest.raises(ValueError, match=r"rows \[0, 2\]"):
            ops_bi.lf_walk(gpu[0], bad_lf, gpu[2], 5000, jump=k)
    torch.cuda.synchronize()
    got = ops_bi.lf_walk(*gpu, 5000, jump=6)
    want = ops_bi.lf_walk(*(torch.from_numpy(x) for x in (last, lf, starts)), 5000)
    assert torch.equal(got.cpu(), want)


def test_fpaq_kernel_matches_plain(card):
    rng = np.random.default_rng(13)
    text = np.frombuffer(_text(1027), np.uint8)
    data = np.stack([text, rng.integers(0, 4, 1027, dtype=np.uint8),
                     rng.integers(0, 256, 1027, dtype=np.uint8), np.full(1027, 0x55, np.uint8)])
    nbytes = np.array([1027, 600, 1, 0], np.int32)
    _kernels.reset_counts()
    got = ops_fb.encode_blocks(torch.from_numpy(data).to(card), torch.from_numpy(nbytes).to(card))
    torch.cuda.synchronize()
    assert _kernels.launches["fpaq_encode"] == 1
    want = ops_fb.encode_blocks(torch.from_numpy(data), torch.from_numpy(nbytes))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    blocks = [_text(300000), rng.integers(0, 256, 70001, dtype=np.uint8).tobytes(),
              b"\x00" * 5000, b"z"]
    for b, (payload, bits) in zip(blocks, ops_fb.fpaq_encode_device_batch(blocks, card)):
        host, hbits = native.entropy_encode(2, np.frombuffer(b, np.uint8), {"bsVersion": 6})
        assert payload == host and bits == hbits, len(b)


def test_fpaq_kernel_ring_halves(card):
    # K11's producer and consumer meet at 256-byte ring halves: rows of
    # different lengths in one launch, nbytes 0 and 1, rows ending at, just
    # past and several halves beyond a half's end
    rng = np.random.default_rng(17)
    lengths = np.array([0, 1, 255, 256, 257, 1300, 513, 769], np.int32)
    T = int(lengths.max())
    text = np.frombuffer(_text(T), np.uint8)
    data = np.stack([text, rng.integers(0, 256, T, dtype=np.uint8)] * 4)
    data[2::2] = rng.integers(0, 3, (3, T), dtype=np.uint8)
    _kernels.reset_counts()
    got = ops_fb.encode_blocks(torch.from_numpy(data).to(card),
                               torch.from_numpy(lengths).to(card))
    torch.cuda.synchronize()
    assert _kernels.launches["fpaq_encode"] == 1
    want = ops_fb.encode_blocks(torch.from_numpy(data), torch.from_numpy(lengths))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_cli_on_card_with_block_lines(card, tmp_path, capsys):
    """The CLI at -l 2 -j 4 -v 4 --device cuda: the stream equals --device
    none's, one block line a block, and the listener keeps the launches at
    one a batch of four blocks (K3 on encode, K4 on decode)."""
    from kanzi_tpu_torch.app import main

    rng = np.random.default_rng(21)
    src = tmp_path / "in.bin"
    text = _text(1 << 16) * ((1 << 19) // len(_text(1 << 16)) + 1)
    src.write_bytes(text[:1 << 19] + rng.integers(0, 4, 1 << 19, dtype=np.uint8).tobytes())
    outs = {}
    for device in ("cuda", "none"):
        knz, back = tmp_path / f"{device}.knz", tmp_path / f"{device}.out"
        _kernels.reset_counts()
        assert main(["-c", "-i", str(src), "-o", str(knz), "-l", "2", "-j", "4",
                     "-b", "256k", "-v", "4", "-f", f"--device={device}"]) == 0
        enc = dict(_kernels.launches)
        assert main(["-d", "-i", str(knz), "-o", str(back), "-j", "4", "-v", "4",
                     "-f", f"--device={device}"]) == 0
        dec = {k: _kernels.launches[k] - enc[k] for k in enc}
        err = capsys.readouterr().err
        lines = [ln for ln in err.splitlines() if ln.startswith("Block ") and "=>" in ln]
        assert [ln.split(":")[0] for ln in lines] == [f"Block {i}" for i in (1, 2, 3, 4)] * 2
        assert back.read_bytes() == src.read_bytes()
        outs[device] = knz.read_bytes()
        if device == "cuda":
            assert enc["pack_lanes"] == 1 and dec["decode_lanes"] == 1, (enc, dec)
    assert outs["cuda"] == outs["none"]
    assert sum(_kernels.plain_calls.values()) == 0


@pytest.mark.parametrize("entropy", ["HUFFMAN", "ANS0", "ANS1", "RANGE"])
def test_device_events_on_card_match_cpu(card, entropy):
    """The device Writer's and Reader's events on the card equal the
    device="cpu" events (type, block id, size, hash; times excluded)."""
    from kanzi_tpu_torch.kio import Reader, Writer

    class Recorder:
        def __init__(self):
            self.events = []

        def process_event(self, evt):
            self.events.append((int(evt.type), evt.block_id, evt.size, evt.hash,
                                int(evt.hash_type), evt.msg))

    rng = np.random.default_rng(22)
    text = _text(1 << 16) * 3   # the text is shorter than two blocks
    data = (text[:2 << 16] + rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
            + _text(5000))
    got = {}
    for device in ("cuda", "cpu"):
        rec, drec = Recorder(), Recorder()
        w = Writer(None, transform="LZ", entropy=entropy, block_size=1 << 16, jobs=4,
                   checksum=32, file_size=len(data), ctx={"skipBlocks": True},
                   device=device)
        w.add_listener(rec)
        w.write(data)
        w.close()
        r = Reader(w.getvalue(), jobs=4, device=device)
        r.add_listener(drec)
        assert r.read_all() == data
        key = lambda e: e[1]  # noqa: E731 (per block, in order)
        got[device] = (w.getvalue(), sorted(rec.events, key=key), drec.events)
    assert got["cuda"] == got["cpu"]


def _mesh(name):
    """The mesh of every card, or four shards of card 0."""
    if name == "world":
        return parallel.device_mesh()
    return parallel.Mesh([torch.device("cuda", 0)] * 4)


@pytest.mark.parametrize("name", ["world", "split"])
@pytest.mark.parametrize("kw", [dict(transform="DNA+LZ", entropy="HUFFMAN"),
                                dict(transform="TEXT+UTF+BWT+RANK+ZRLT", entropy="ANS0"),
                                dict(transform="NONE", entropy="ANS1"),
                                dict(transform="LZ", entropy="RANGE")],
                         ids=["level2", "level5", "ANS1", "RANGE"])
def test_mesh_on_card(card, name, kw, monkeypatch):
    """compress_multichip and decompress_multichip on the card's mesh:
    the host C++ stream, decoded to the input, one launch a shard with
    rows a batch, no plain version."""
    mesh = _mesh(name)
    rows = []
    real = parallel._launch_rows

    def spy(m, streams, row_arrays, tables, kernel):
        rows.append(len(next(iter(row_arrays.values()))))
        return real(m, streams, row_arrays, tables, kernel)

    monkeypatch.setattr(parallel, "_launch_rows", spy)
    rng = np.random.default_rng(23)
    data = _text(300000) + rng.integers(0, 4, 300000, dtype=np.uint8).tobytes()
    cfg = dict(block_size=1 << 17, checksum=32, **kw)
    _kernels.reset_counts()
    blob = parallel.compress_multichip(data, mesh, **cfg)
    enc, enc_rows = dict(_kernels.launches), list(rows)
    assert blob == kt.compress(data, device=None, **cfg)
    rows.clear()
    _kernels.reset_counts()
    assert parallel.decompress_multichip(blob, mesh) == data
    nonempty = lambda r: sum(hi > lo for lo, hi in mesh.shares(r))  # noqa: E731
    kernel = {"HUFFMAN": ("pack_lanes", "decode_lanes"), "ANS0": ("ans_encode", "ans_decode"),
              "ANS1": ("ans_encode", "ans_decode"),
              "RANGE": ("range_encode", "range_decode")}[kw["entropy"]]
    assert enc_rows and enc[kernel[0]] == sum(nonempty(r) for r in enc_rows)
    if kw["entropy"] == "RANGE":       # on the mesh's first card
        assert rows == [] and _kernels.launches["range_decode"] > 0
    else:
        assert rows and _kernels.launches[kernel[1]] == sum(nonempty(r) for r in rows)
    assert sum(_kernels.plain_calls.values()) == 0


@pytest.mark.parametrize("name", ["world", "split"])
def test_compress_step_on_card_mesh(card, name):
    rng = np.random.default_rng(24)
    blocks = rng.integers(0, 64, (8, 1 << 16), dtype=np.uint8)
    blocks[2] = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    _, (syms, lens, tidx, tables) = DeviceHuffmanEngine("cpu").lane_batch(list(blocks))
    mesh = _mesh(name)
    _kernels.reset_counts()
    got = parallel.compress_step(blocks, syms, lens, tidx, tables, mesh=mesh)
    torch.cuda.synchronize()
    nonempty = lambda r: sum(hi > lo for lo, hi in mesh.shares(r))  # noqa: E731
    assert _kernels.launches["block_stats"] == nonempty(len(blocks))
    assert _kernels.launches["pack_lanes"] == nonempty(len(syms))
    want = parallel.compress_step(blocks, syms, lens, tidx, tables, device="cuda")
    for a, b in zip(got, want):
        assert a.device == mesh.devices[0]
        assert torch.equal(a.cpu(), b.cpu())
    assert int(got[4]) == int(got[3].sum())
    assert sum(_kernels.plain_calls.values()) == 0


def test_dryrun_multichip_on_card(card):
    _kernels.reset_counts()
    parallel.dryrun_multichip(torch.cuda.device_count())
    assert sum(_kernels.plain_calls.values()) == 0
    for k in ("pack_lanes", "decode_lanes", "ans_encode", "ans_decode", "range_encode",
              "range_decode", "block_stats"):
        assert _kernels.launches[k] > 0, k


# -- the decode contract on hostile and legacy streams, on the card ---------
# Each stream's outcome on a device="cuda" Reader must equal the host C++
# route's (device=None) on the same bytes: the same bytes, or KanziError
# with the same code; never a DeviceFault. After every rejection a good
# stream still decodes exactly and torch.cuda.synchronize() raises nothing.

_HOSTILE = {"level2": dict(level=2), "level3": dict(level=3), "level5": dict(level=5),
            "ANS1": dict(transform="NONE", entropy="ANS1"),
            "RANGE": dict(transform="LZ", entropy="RANGE")}
_ENTROPY = {"level2": "HUFFMAN", "level3": "HUFFMAN", "level5": "ANS0", "ANS1": "ANS1",
            "RANGE": "RANGE"}


def _after_rejection(card, good, data, jobs):
    assert kt.decompress(good, jobs=jobs, device="cuda") == data
    torch.cuda.synchronize()


@pytest.mark.parametrize("jobs", [1, 4])
@pytest.mark.parametrize("codec", sorted(_HOSTILE))
def test_hostile_streams_match_host_on_card(card, codec, jobs):
    from kanzi_tpu_torch import robustness
    from kanzi_tpu_torch.bench import synth_corpus
    data = synth_corpus(1 << 20, 11)[:256 << 10]
    rng = np.random.default_rng(jobs * 7 + sorted(_HOSTILE).index(codec))
    for checksum in (32, 0):
        good = kt.compress(data, block_size=64 << 10, checksum=checksum, jobs=4,
                           device=None, **_HOSTILE[codec])
        for kind in ("xor",) * 5 + ("payload",) * 3 + ("trunc",) * 3 + ("header",) * 3 \
                + ("size",) * 2 + ("logrange", "chunksize"):
            bad = robustness.mutate(good, kind, _ENTROPY[codec], rng)
            if bad is None:
                continue
            got = robustness.outcome(lambda: kt.decompress(bad, jobs=jobs, device="cuda"))
            want = robustness.outcome(lambda: kt.decompress(bad, jobs=jobs, device=None))
            assert got == want, (kind, checksum)
            if checksum:
                assert got[0] == "KanziError" or got == robustness.outcome(lambda: data)
            if got[0] == "KanziError":
                _after_rejection(card, good, data, jobs)


@pytest.mark.parametrize("jobs", [1, 4])
def test_legacy_streams_match_host_on_card(card, jobs):
    """Legacy streams (bitstream versions 1-5, the spec-model writers)
    decode natively on a device Reader too, as on the host route; their
    truncations and byte flips give the host route's outcome."""
    from kanzi_tpu_torch import robustness
    from specmodel import legacy_v14 as l14, legacy_v5 as l5
    data = _text(40000) + np.random.default_rng(3).integers(0, 40, 20000,
                                                           dtype=np.uint8).tobytes()
    blobs = [l14.compress_legacy(data, v, 5, lambda b: spec_ans.ans_encode(b, 0), 65536)
             for v in (2, 4)]
    blobs.append(l14.compress_legacy(data, 1, 8, lambda b: l14.ans_encode_v1(b, 1), 65536))
    blobs.append(l5.compress_v5_huffman(data, 16384))
    rng = np.random.default_rng(5)
    for blob in blobs:
        variants = [blob, blob[:len(blob) // 2], blob[:-1]]
        for _ in range(3):
            b = bytearray(blob)
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            variants.append(bytes(b))
        for v in variants:
            got = robustness.outcome(lambda: kt.decompress(v, jobs=jobs, device="cuda"))
            assert got == robustness.outcome(lambda: kt.decompress(v, jobs=jobs, device=None))
        torch.cuda.synchronize()


def test_robustness_streams_on_card(card):
    """A short run of chip_smoke.py's robustness phase: every outcome
    equal, K4, K6 and K8 launched on the hostile streams, no plain
    version."""
    from kanzi_tpu_torch import robustness
    cases = list(robustness.streams(48))
    _kernels.reset_counts()
    res = robustness.check(cases, lambda b, j: kt.decompress(b, jobs=j, device="cuda"),
                           lambda b, j: kt.decompress(b, jobs=j, device=None), jobs=(1, 4))
    torch.cuda.synchronize()
    assert res["streams"] == 48 and not res["disagree"] and res["wrong_bytes"] == 0
    for k in ("decode_lanes", "ans_decode", "range_decode"):
        assert _kernels.launches[k] > 0, k
    assert sum(_kernels.plain_calls.values()) == 0


def test_range_wide_and_strict_rows_match_plain(card):
    """K8 on the engine's rows (the host decoder's rules: bit counts, slot
    table bounds, a u64 state) at logRange 12 and 15 (the wide slot table)
    against its plain version, valid and mutated coder streams."""
    from kanzi_tpu_torch.ops.state import to_port_state
    rng = np.random.default_rng(15)
    for rows in (range_device._BUF_CAP, range_device._BUF_FULL):
        batch = []
        for k in range(6):
            piece = rng.integers(0, 64 if k % 2 else 256, 32768, dtype=np.uint8)
            payload, _ = native.entropy_encode(4, piece, {"bsVersion": 6})
            src = np.frombuffer(payload, np.uint8).copy()
            if k >= 3:
                src[100 + 37 * k] ^= 0x5A            # a mutated coder stream
            _end, _s, row, _held = range_device.chunk_batch(src, 0, 32768, None, None, rows)
            if k == 5:   # a row as after a chunk with logRange 15
                row["f2s"] = np.concatenate([row["f2s"], rng.integers(
                    0, 256, (1, 32768 - 4096), dtype=np.uint8)], 1)
                row["bound"][:] = 32768
            batch.append(row)
        batch = device_io_stack(batch)
        for dev in (card, torch.device("cpu")):
            st = to_port_state(batch, dev)
            got = ops_range.decode_chunks(
                st["bufs"], st["nbytes"], st["rng_tables"], st["f2s"], st["shifts"],
                st["nvalid"], 32768, st["nbits"], st["bound"])
            if dev == card:
                k_syms, k_nr = (g.cpu() for g in got)
            else:
                assert torch.equal(k_nr, got[1]) and torch.equal(k_syms, got[0])
        assert (k_nr[:3] > 0).all()
    torch.cuda.synchronize()


def device_io_stack(rows):
    from kanzi_tpu_torch.entropy import device_io
    return device_io.stack(rows)


@pytest.mark.parametrize("case", ["blocks", "hostile"])
def test_range_walk_on_card_equals_host(card, case):
    """The device RANGE decode's native walk on the card (pinned rows and
    read-back): per block the host decoder's bytes, or a rejection where
    the host rejects; one native step a chunk index, one re-parse a row
    cut at _BUF_CAP that failed."""
    from torch_range_inputs import hostile_range_block
    rng = np.random.default_rng(19)
    if case == "blocks":
        text = _text(1 << 20)
        datas = [text * 3, rng.integers(0, 256, 300000, dtype=np.uint8).tobytes(),
                 b"z" * 70000 + text[:5000], rng.integers(0, 4, 200000, dtype=np.uint8).tobytes()]
        blocks = [(native.entropy_encode(4, np.frombuffer(d, np.uint8), {"bsVersion": 6})[0],
                   len(d)) for d in datas]
    else:
        blocks = [hostile_range_block(c) for c in ("header_rejected", "held_slot", "cut_row")]
    _kernels.reset_counts()
    got = range_device.range_decode_many([p for p, _ in blocks], [n for _, n in blocks], card)
    for (payload, n), g in zip(blocks, got):
        try:
            host = native.entropy_decode(4, payload, n, {"bsVersion": 6})
        except native.NativeError:
            assert isinstance(g, (native.NativeError, KanziError))
            continue
        assert not isinstance(g, Exception) and g.tobytes() == host
    assert _kernels.walk_counts == {"range_steps": max(-(-n // 32768) for _, n in blocks),
                                    "range_reparsed": int(case == "hostile")}
    assert _kernels.launches["range_decode"] > 0 and _kernels.plain_calls["range_decode"] == 0
