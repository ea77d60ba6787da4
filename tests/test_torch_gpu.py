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
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.entropy.huffman_device import huffman_decode_device
from kanzi_tpu_torch.ops import block_stats, huffman as ops_huffman
from kanzi_tpu_torch.ops.state import to_port_state

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
    got = ops_huffman.decode_lanes(*(gpu[k] for k in keys))
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
