"""The port's batched BWT inverse (ops/bwt_inverse.py, plain PyTorch version
on the CPU) against kanzi_tpu.ops.bwt_inverse on seeded inputs. Exact
equality: integer functions."""

import numpy as np
import pytest
import torch

from kanzi_tpu.ops import bwt_inverse as jax_bi
from kanzi_tpu_torch import _kernels
from kanzi_tpu_torch.ops import bwt_inverse as bi


def _bwt_textbook(data: bytes):
    """Definitional forward: sorted rotations (no sentinel), last column and
    primary row. O(n^2 log n): small inputs only."""
    n = len(data)
    doubled = data + data
    rows = sorted(range(n), key=lambda i: doubled[i:i + n])
    last = bytes(data[(i + n - 1) % n] for i in rows)
    return np.frombuffer(last, np.uint8), rows.index(0)


def _batch():
    rng = np.random.default_rng(3)
    texts = [b"banana_band_banana_band!" * 40,
             rng.integers(0, 256, 960, dtype=np.uint8).tobytes(),
             np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 960)].tobytes(),
             b"aaaabbbb" * 120]
    n = min(len(t) for t in texts)
    pairs = [_bwt_textbook(t[:n]) for t in texts]
    return ([t[:n] for t in texts], np.stack([p[0] for p in pairs]),
            np.array([p[1] for p in pairs]))


def test_bwt_inverse_matches_jax_and_text():
    texts, last, primary = _batch()
    _kernels.reset_counts()
    out = bi.bwt_inverse_device(last, primary, device="cpu")
    assert _kernels.plain_calls["lf_walk"] == 1
    assert np.array_equal(out, jax_bi.bwt_inverse_device(last, primary))
    for b, t in enumerate(texts):
        assert out[b].tobytes() == t


def test_build_lf_matches_jax():
    _texts, last, _primary = _batch()
    want_lf, want_counts = jax_bi.build_lf(last)
    lf, counts = bi.build_lf(torch.from_numpy(last))
    assert lf.dtype == counts.dtype == torch.int32
    assert np.array_equal(lf.numpy(), want_lf) and np.array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("nsteps", [0, 1, 17, 500, 2000])
def test_lf_walk_steps_other_than_n(nsteps):
    # fewer steps than N stop early; more go round the LF cycle again
    _texts, last, primary = _batch()
    lf, _ = jax_bi.build_lf(last)
    starts = primary.astype(np.int32)
    want = np.asarray(jax_bi.lf_walk(last, lf, starts, nsteps))
    got = bi.lf_walk(torch.from_numpy(last), torch.from_numpy(lf),
                     torch.from_numpy(starts), nsteps)
    assert got.dtype == torch.uint8 and got.shape == (4, nsteps)
    assert np.array_equal(got.numpy(), want)


def test_lf_walk_refuses_out_of_range_indices():
    # kanzi_tpu's gather clamps such an index; the port raises
    _texts, last, primary = _batch()
    N = last.shape[1]
    args = [torch.from_numpy(last), bi.build_lf(torch.from_numpy(last))[0],
            torch.from_numpy(primary.astype(np.int32))]
    for bad_start in (N, -1):
        starts = args[2].clone()
        starts[1] = bad_start
        with pytest.raises(ValueError, match="starts"):
            bi.lf_walk(args[0], args[1], starts, 10)
    bad_lf = args[1].clone()
    bad_lf[2, 5] = N
    with pytest.raises(ValueError, match="lf"):
        bi.lf_walk(args[0], bad_lf, args[2], 10)
    with pytest.raises(ValueError, match="no host route"):
        bi.bwt_inverse_device(last, primary, device=None)


# K10's decomposition (jump table, checkpoints, segments) in plain PyTorch,
# against kanzi_tpu's walk: (k, nsteps) around multiples of L = 2^k and
# below it; N = 960
@pytest.mark.parametrize("k,nsteps", [(3, 0), (3, 1), (3, 7), (3, 8), (3, 9), (3, 960),
                                      (3, 997), (5, 31), (5, 32), (5, 33), (5, 64),
                                      (10, 960), (10, 2000), (0, 500), (1, 2)])
def test_segmented_walk_matches_jax(k, nsteps):
    _texts, last, primary = _batch()
    lf, _ = jax_bi.build_lf(last)
    starts = primary.astype(np.int32)
    want = np.asarray(jax_bi.lf_walk(last, lf, starts, nsteps))
    got = bi._lf_walk_segmented_plain(torch.from_numpy(last), torch.from_numpy(lf),
                                      torch.from_numpy(starts), nsteps, k)
    assert got.dtype == torch.uint8 and got.shape == (4, nsteps)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_segmented_walk_non_permutation_lf(k):
    # lf need not be a permutation: random in-range entries, and a row
    # whose walk falls into a cycle of three positions
    rng = np.random.default_rng(20 + k)
    B, N = 3, 300
    last = rng.integers(0, 256, (B, N), dtype=np.uint8)
    lf = rng.integers(0, N, (B, N)).astype(np.int32)
    lf[2] = (np.arange(N) + 1) % 3
    starts = np.array([0, N - 1, 150], np.int32)
    for nsteps in (1, 2 ** k - 1, 2 ** k + 1, N + 37):
        want = np.asarray(jax_bi.lf_walk(last, lf, starts, nsteps))
        got = bi._lf_walk_segmented_plain(torch.from_numpy(last), torch.from_numpy(lf),
                                          torch.from_numpy(starts), nsteps, k)
        assert np.array_equal(got.numpy(), want), nsteps


def test_jump_table_and_checkpoints():
    # J = lf^(2^k) by doubling equals lf applied 2^k times; the checkpoints
    # are the walk's cursors at multiples of 2^k
    _texts, last, primary = _batch()
    lf = torch.from_numpy(jax_bi.build_lf(last)[0])
    for k in (0, 1, 3, 6):
        J = bi._lf_jump_plain(lf, k)
        want = lf.long()
        for _ in range(2 ** k - 1):
            want = torch.gather(lf.long(), 1, want)
        assert torch.equal(J, want), k
        ck = bi._lf_checkpoints_plain(J, torch.from_numpy(primary.astype(np.int32)), 5)
        cur = torch.from_numpy(primary.astype(np.int64))[:, None]
        for m in range(5):
            assert torch.equal(ck[:, m:m + 1], cur), (k, m)
            for _ in range(2 ** k):
                cur = torch.gather(lf.long(), 1, cur)


def test_jump_rounds_rule():
    assert [bi.jump_rounds(n) for n in (0, 1, 3, 16, 65536, (4 << 20) + 1, 1 << 40)] == \
        [0, 0, 1, 2, 8, 11, 12]
    _texts, last, primary = _batch()
    args = [torch.from_numpy(last), bi.build_lf(torch.from_numpy(last))[0],
            torch.from_numpy(primary.astype(np.int32))]
    # the plain route ignores jump, and refuses one outside [0, 30]
    assert torch.equal(bi.lf_walk(*args, 50, jump=4), bi.lf_walk(*args, 50))
    with pytest.raises(ValueError, match="jump"):
        bi.lf_walk(*args, 50, jump=-1)
