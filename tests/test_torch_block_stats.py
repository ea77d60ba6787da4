"""Block stats of the PyTorch port against the JAX package: histograms are
exact against the Pallas kernel (interpret mode) and the XLA version;
entropy x1024 comes within 1 of them (float32 sums in another order) and
within 8 of the integer reference, with the same >= 973 gate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanzi_tpu import internal
from kanzi_tpu.ops import histogram as jax_histogram
from kanzi_tpu.ops.pallas_kernels import entropy1024_pallas, histograms_pallas
from kanzi_tpu_torch import _kernels
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

