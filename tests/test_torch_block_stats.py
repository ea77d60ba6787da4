"""Block stats of the PyTorch port against the JAX package: histograms are
exact against the Pallas kernel (interpret mode) and the XLA version;
entropy x1024 comes within 1 of them (float32 sums in another order) and
within 8 of the integer reference, with the same >= 973 gate."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu import internal
from kanzi_tpu.ops import histogram as jax_histogram
from kanzi_tpu.ops.pallas_kernels import (block_stats_pallas, entropy1024_pallas,
                                         histograms_pallas)
from kanzi_tpu_torch import _kernels, parallel
from kanzi_tpu_torch.entropy.huffman_device import DeviceHuffmanEngine
from kanzi_tpu_torch.ops import block_stats


def _blocks(seed, shape, hi=256):
    return np.random.default_rng(seed).integers(0, hi, shape, dtype=np.uint8)


def _bincount(blocks):
    return np.stack([np.bincount(b, minlength=256) for b in blocks])


@pytest.mark.parametrize("seed,shape,hi", [
    (5, (4, 4096), 256),     # tests/test_pallas_kernels.py parity case
    (8, (2, 8192), 4),       # narrow alphabet
    (9, (1, 1024), 256),     # one tile
])
def test_histograms_match_pallas(seed, shape, hi):
    blocks = _blocks(seed, shape, hi)
    want = np.asarray(histograms_pallas(jnp.asarray(blocks), interpret=True))
    got = block_stats.histograms_u8(torch.from_numpy(blocks))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), _bincount(blocks))


@pytest.mark.parametrize("n", [1000, 4097, 12345])
def test_histograms_any_length_match_xla(n):
    # the Pallas kernel takes only multiples of 1024; the port takes any N
    blocks = _blocks(n, (3, n))
    want = np.asarray(jax_histogram.histograms_u8(jnp.asarray(blocks)))
    got = block_stats.histograms_u8(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _bincount(blocks))


def _gate_cases():
    rng = np.random.default_rng(6)
    return np.stack([
        rng.integers(0, 256, 8192, dtype=np.uint8),      # random: >= 973
        np.zeros(8192, dtype=np.uint8),                  # constant: 0
        rng.integers(0, 4, 8192, dtype=np.uint8),        # 2-bit alphabet
    ])


def test_entropy_matches_pallas_and_integer_reference():
    blocks = _gate_cases()
    h = _bincount(blocks).astype(np.int32)
    lengths = np.full(len(blocks), blocks.shape[1], np.int32)
    pallas = np.asarray(entropy1024_pallas(jnp.asarray(h), jnp.asarray(lengths),
                                           interpret=True))
    got = block_stats.entropy1024(torch.from_numpy(h),
                                  torch.from_numpy(lengths)).numpy()
    assert np.abs(got.astype(np.int64) - pallas).max() <= 1
    for i, b in enumerate(blocks):
        want = internal.first_order_entropy_1024(
            len(b), internal.compute_histogram_order0(b))
        assert abs(int(got[i]) - want) <= 8, (i, got[i], want)
        assert (got[i] >= 973) == (want >= 973)


@pytest.mark.parametrize("n", [65536, 3000])
def test_entropy_matches_xla(n):
    blocks = _blocks(7 + n, (2, n))
    blocks[1] %= 16
    h = _bincount(blocks).astype(np.int32)
    lengths = np.full(2, n, np.int32)
    want = np.asarray(jax_histogram.entropy1024(jnp.asarray(h), jnp.asarray(lengths)))
    got = block_stats.entropy1024(torch.from_numpy(h), torch.from_numpy(lengths))
    assert np.abs(got.numpy().astype(np.int64) - want).max() <= 1
    if n == 65536:
        assert 1000 <= int(got[0]) <= 1024   # the reference's [0..1024] scale


def test_entropy_guards_zero_length():
    h = torch.zeros(1, 256, dtype=torch.int32)
    e = block_stats.entropy1024(h, torch.zeros(1, dtype=torch.int32))
    assert int(e[0]) == 0


def test_block_stats_composes_both():
    blocks = _gate_cases()
    _kernels.reset_counts()
    h, e = block_stats.block_stats(torch.from_numpy(blocks))
    assert np.array_equal(h.numpy(), _bincount(blocks))
    assert e.shape == (3,) and e.dtype == torch.int32
    assert _kernels.plain_calls["histograms_u8"] == 1
    assert _kernels.plain_calls["entropy1024"] == 1
    assert _kernels.launches["histograms_u8"] == 0


@pytest.mark.parametrize("bad,err", [
    (lambda: block_stats.histograms_u8(torch.zeros(2, 8, dtype=torch.int32)), TypeError),
    (lambda: block_stats.histograms_u8(torch.zeros(8, dtype=torch.uint8)), ValueError),
    (lambda: block_stats.histograms_u8(torch.zeros(8, 4, dtype=torch.uint8).t()), ValueError),
    (lambda: block_stats.histograms_u8(np.zeros((2, 8), np.uint8)), TypeError),
    (lambda: block_stats.entropy1024(torch.zeros(2, 255, dtype=torch.int32),
                                     torch.zeros(2, dtype=torch.int32)), ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        bad()



def _stat_rows(n):
    """Rows of length n: random, constant, a 2-bit alphabet and sparse zeros
    (98 % zero bytes)."""
    rng = np.random.default_rng(20 + n)
    sparse = np.zeros(n, np.uint8)
    idx = rng.integers(0, max(n, 1), n // 50)
    sparse[idx] = rng.integers(1, 256, len(idx), dtype=np.uint8)
    return np.stack([rng.integers(0, 256, n, dtype=np.uint8), np.full(n, 77, np.uint8),
                     rng.integers(0, 4, n, dtype=np.uint8), sparse])


@pytest.mark.parametrize("n", [0, 1, 4097, 8192])
def test_block_stats_matches_pallas_and_xla(n):
    # histograms exact; entropy within 1 of the Pallas program and of XLA
    # (float32 sums in another order), within 8 of the integer reference
    # with the same >= 973 gate
    blocks = _stat_rows(n)
    _kernels.reset_counts()
    h, e = block_stats.block_stats(torch.from_numpy(blocks))
    assert _kernels.plain_calls["block_stats"] == 1
    assert h.dtype == e.dtype == torch.int32 and e.shape == (4,)
    assert np.array_equal(h.numpy(), _bincount(blocks))
    lengths = jnp.full(4, n, jnp.int32)
    xla_h = jax_histogram.histograms_u8(jnp.asarray(blocks))
    assert np.array_equal(h.numpy(), np.asarray(xla_h))
    xla_e = np.asarray(jax_histogram.entropy1024(xla_h, lengths))
    assert np.abs(e.numpy().astype(np.int64) - xla_e).max() <= 1
    if n and n % 1024 == 0:   # the Pallas kernel takes multiples of 1024
        ph, pe = block_stats_pallas(jnp.asarray(blocks), interpret=True)
        assert np.array_equal(h.numpy(), np.asarray(ph))
        assert np.abs(e.numpy().astype(np.int64) - np.asarray(pe)).max() <= 1
    for i, b in enumerate(blocks):
        want = internal.first_order_entropy_1024(len(b), internal.compute_histogram_order0(b))
        assert abs(int(e[i]) - want) <= 8, (i, int(e[i]), want)
        assert (int(e[i]) >= 973) == (want >= 973)


def test_compress_step_makes_one_block_stats_call():
    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, (2, 4096), dtype=np.uint8)
    _preps, (syms, lens, tidx, tables) = DeviceHuffmanEngine("cpu").lane_batch(list(blocks))
    _kernels.reset_counts()
    parallel.compress_step(blocks, syms, lens, tidx, tables, device="cpu")
    assert _kernels.plain_calls["block_stats"] == 1
    assert _kernels.plain_calls["histograms_u8"] == _kernels.plain_calls["entropy1024"] == 1
    assert sum(_kernels.launches.values()) == 0


# -- a plain model of the kernel's counting (csrc/block_stats.cu) ----------
#
# Each row is a cluster of c CTAs of 64 * PAIRS threads; CTA `rank` counts
# the vectors [nv * rank // c, nv * (rank + 1) // c) of the row's
# 16-byte-aligned body, thread t of it the vectors t, t + threads, ...;
# rank 0 counts the unaligned head (thread i its byte i), the last rank
# the tail. Thread t's counter of bin v is the u32 at byte offset
# byte_perm(word, lb, 0x76k4) = pair << 16 | v << 8 | (warp & 1) << 7 | lane << 2.

_CU = os.path.join(os.path.dirname(block_stats.__file__), "..", "csrc", "block_stats.cu")
PAIRS, MAX_CLUSTER, WAVE_BYTES = 3, 8, 96 * 1024


def _cu_constant(name):
    """A constant `constexpr int[64_t] name = a [* b];` of the kernel's source."""
    with open(_CU) as fh:
        m = re.search(rf"constexpr int(?:64_t)? {name} = (\d+)(?: \* (\d+))?;", fh.read())
    return int(m.group(1)) * int(m.group(2) or 1)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: result byte i is byte s[4i+3:4i] of (y << 32 | x)."""
    src = (np.uint64(y) << np.uint64(32)) | np.uint64(x)
    out = 0
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= int((src >> np.uint64(8 * sel)) & np.uint64(0xFF)) << (8 * i)
    return out


def _lane_base(t):
    warp, lane = t >> 5, t & 31
    return (warp >> 1) << 16 | (warp & 1) << 7 | lane << 2


def _count_model(row, base_mod16, c, pairs=PAIRS):
    """(counters, totals): counters[rank, t, v] is thread t of CTA rank's
    count of bin v (u32), totals the row's histogram from them."""
    threads = 64 * pairs
    n = len(row)
    head = min((16 - base_mod16) % 16, n)
    nv = (n - head) // 16
    tail = head + 16 * nv
    pos = np.arange(n)
    rank = np.zeros(n, np.int64)
    thread = np.zeros(n, np.int64)
    body = (pos >= head) & (pos < tail)
    v = (pos[body] - head) // 16
    rank[body] = np.searchsorted(nv * np.arange(1, c + 1) // c, v, side="right")
    thread[body] = (v - nv * rank[body] // c) % threads
    thread[:head] = pos[:head]
    rank[tail:] = c - 1
    thread[tail:] = pos[tail:] - tail
    key = (rank * threads + thread) * 256 + row.astype(np.int64)
    counters = np.bincount(key, minlength=c * threads * 256).astype(np.uint32)
    counters = counters.reshape(c, threads, 256)
    totals = counters.astype(np.uint64).sum(axis=(0, 1))
    return counters, totals


def test_model_constants_match_the_kernel():
    assert _cu_constant("kPairs") == PAIRS
    assert _cu_constant("kMaxCluster") == MAX_CLUSTER
    assert _cu_constant("kWaveBytes") == WAVE_BYTES


def test_counter_offsets_are_lane_private_and_conflict_free():
    # every (thread, bin) has its own u32; lane l's all sit in bank l, so a
    # warp's 32 updates never collide, whatever the bytes are
    seen = set()
    for t in range(64 * PAIRS):
        lb = _lane_base(t)
        for v in (0, 1, 77, 128, 255):
            for k in range(4):
                word = (v << (8 * k)) | (0xA5A5A5A5 & ~(0xFF << (8 * k)))
                off = _byte_perm(word, lb, 0x7604 | k << 4)
                assert off == (t >> 6) << 16 | v << 8 | ((t >> 5) & 1) << 7 | (t & 31) << 2
                assert (off >> 2) % 32 == t % 32
            seen.add(off)
    assert len(seen) == 64 * PAIRS * 5
    assert max(seen) + 4 <= PAIRS * 256 * 64 * 4      # inside the counters


@pytest.mark.parametrize("n,base_mod16,c", [
    (0, 0, 8), (1, 3, 8), (15, 1, 6), (17, 15, 6), (1024, 0, 7), (4097, 9, 8),
    (65536 + 7, 5, 6), (12345, 0, 1)])
def test_count_model_matches_bincount(n, base_mod16, c):
    row = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    _, totals = _count_model(row, base_mod16, c)
    assert np.array_equal(totals, np.bincount(row, minlength=256))


@pytest.mark.parametrize("drop,want", [(1, 65535), (0, 65536)])
def test_count_model_lane_passes_the_u16_limit(drop, want):
    # one CTA of one warp pair: each thread takes 4096 vectors of a zero
    # row of 4 MiB, so lane 0 counts 65,536 zeros (65,535 with one byte
    # changed); u32 counters need no flush at the u16 limit
    row = np.zeros(64 * 4096 * 16, np.uint8)
    row[:drop] = 1
    counters, totals = _count_model(row, 0, 1, pairs=1)
    assert int(counters[0, 0, 0]) == want
    assert np.array_equal(totals, np.bincount(row, minlength=256))


def _pick_cluster(B, n, resident):
    """csrc/block_stats.cu pick_cluster: the c <= 8 whose waves of resident
    clusters, ceil(B / resident[c - 1]), cost least, a wave costing
    WAVE_BYTES plus a CTA's ceil(n / c) bytes; ties go to the larger c."""
    best = None
    for c in range(MAX_CLUSTER, 0, -1):
        r = resident[c - 1]
        if r <= 0:
            continue
        cost = -(-B // r) * (WAVE_BYTES + -(-n // c))
        if best is None or cost < best[1]:
            best = (c, cost)
    return best[0]


# clusters of 1..8 CTAs an H100 80GB HBM3 holds at once (PERF.md, PR 9)
H100_RESIDENT = [132, 66, 39, 30, 22, 17, 15, 15]


@pytest.mark.parametrize("B,n,c", [
    (1, 4 << 20, 8), (15, 4 << 20, 8), (16, 4 << 20, 6), (17, 4 << 20, 6),
    (64, 1 << 20, 2), (66, 1 << 20, 2), (1000, 4 << 20, 1), (256, 4096, 1), (16, 4096, 6)])
def test_pick_cluster_on_the_h100_table(B, n, c):
    assert _pick_cluster(B, n, H100_RESIDENT) == c
