"""The port's prefix-doubling suffix sort and BWT payload (ops/suffix_sort.py,
plain PyTorch version on the CPU) against kanzi_tpu.ops.suffix_sort and the
host BWT transform, on seeded inputs. Exact equality: integer functions."""

import numpy as np
import pytest
import torch

from kanzi_tpu.ops import suffix_sort as jax_ss
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.ops import suffix_sort as ss


def _cases():
    rng = np.random.default_rng(3)
    pick = lambda alphabet, n: np.frombuffer(alphabet, np.uint8)[  # noqa: E731
        rng.integers(0, len(alphabet), n)].tobytes()
    return {
        "ab_40": pick(b"ab", 40),
        "abracadabra_255": pick(b"abracadabra", 255),
        "river_5000": pick(b"mississippi river basin", 5000),
        "runs_6000": b"aaaaabbbbb" * 600,
        "random_6000": rng.integers(0, 256, 6000, dtype=np.uint8).tobytes(),
        "period2_3000": b"ab" * 1500,
    }


def _host_bwt(data: bytes) -> bytes:
    out, _ = native.transform_forward(1, np.frombuffer(data, np.uint8),
                                      {"blockSize": len(data)}, 2 * len(data) + 64)
    return bytes(out)


@pytest.mark.parametrize("name", list(_cases()))
def test_bwt_forward_matches_jax_and_host(name):
    data = _cases()[name]
    sa = ss.suffix_array_device(data, device="cpu")
    assert sa.dtype == np.int32
    assert np.array_equal(sa, jax_ss.suffix_array_device(data))
    payload = ss.bwt_forward_device(data, device="cpu")
    assert payload == jax_ss.bwt_forward_device(data) == _host_bwt(data)


def test_period2_block_takes_many_rounds():
    # every prefix of a period-2 block repeats: the ranks split one bit of
    # length a round, so the loop runs until 2k covers the block
    data = b"xy" * 4096
    padded = np.frombuffer(data, np.uint8).astype(np.int32)
    order, rounds = ss.prefix_double(torch.from_numpy(padded), len(data))
    assert np.array_equal(order.numpy(), jax_ss._prefix_double(padded, 8192, np.int32(8192)))
    assert rounds == 13       # 2k covers the block after the round with k = 4096
    assert np.array_equal(ss.suffix_array_device(data, device="cpu"),
                          jax_ss.suffix_array_device(data))
    assert ss.bwt_forward_device(data, device="cpu") == _host_bwt(data)


def test_suffix_sort_edges():
    assert list(ss.suffix_array_device(b"banana", device="cpu")) == [5, 3, 1, 0, 4, 2]
    assert len(ss.suffix_array_device(b"", device="cpu")) == 0
    assert list(ss.suffix_array_device(b"z", device="cpu")) == [0]
    with pytest.raises(ValueError):
        ss.bwt_forward_device(b"x", device="cpu")      # native skips n < 2 too
    for n in (2, 255, 256, 257):                       # the 1- and 8-chunk headers
        data = (b"abcab" * 80)[:n]
        assert ss.bwt_forward_device(data, device="cpu") == _host_bwt(data)
        assert ss.bwt_forward_device(data, device="cpu") == jax_ss.bwt_forward_device(data)


@pytest.mark.parametrize("n_true", [0, 1, 700, 1024])
def test_prefix_double_matches_jax_with_pads(n_true):
    # the whole order, pads at the tail, as kanzi_tpu's _prefix_double
    rng = np.random.default_rng(n_true)
    padded = rng.integers(0, 256, 1024).astype(np.int32)
    padded[:n_true] %= 3
    _kernels.reset_counts()
    order, rounds = ss.prefix_double(torch.from_numpy(padded), n_true)
    assert _kernels.plain_calls["prefix_double"] == 1
    want = np.asarray(jax_ss._prefix_double(padded, 1024, np.int32(n_true)))
    assert order.dtype == torch.int32 and np.array_equal(order.numpy(), want)
    assert rounds >= 1


def test_prefix_double_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ss.prefix_double(torch.zeros(1536, dtype=torch.int32), 10)   # not a power of two
    with pytest.raises(ValueError):
        ss.prefix_double(torch.zeros(1024, dtype=torch.int32), 1025)
    with pytest.raises(TypeError):
        ss.prefix_double(torch.zeros(1024, dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="no host route"):
        ss.suffix_array_device(b"banana", device=None)


def test_prefix_double_small_groups_beside_a_large_one():
    # many small groups (random bytes) that close in the first rounds beside
    # one large group (a zero run) that closes last: the shapes of the
    # card's active-set design, held here on the plain version
    rng = np.random.default_rng(12)
    sym = np.concatenate([rng.integers(0, 256, 1500), np.zeros(300, np.int64),
                          rng.integers(0, 4, 248)]).astype(np.int32)
    order, rounds = ss.prefix_double(torch.from_numpy(sym), len(sym))
    want = np.asarray(jax_ss._prefix_double(sym, 2048, np.int32(len(sym))))
    assert np.array_equal(order.numpy(), want)
    # two suffixes of the run differ within their first 301 symbols: 2^9
    # covers that and 2^8 does not
    assert rounds == 9
