"""The port's batched FPAQ encode (ops/fpaq_batch.py, plain PyTorch version
on the CPU) against kanzi_tpu.ops.fpaq_batch.encode_blocks and the host
FPAQ encoder, on seeded inputs. Exact equality: integer functions."""

import os

import numpy as np
import pytest
import torch

from kanzi_tpu.ops import fpaq_batch as jax_fb
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.ops import fpaq_batch as fb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(T, seed):
    """(3, T) bytes: text, narrow random, random; ragged lengths."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(ROOT, "SURVEY.md"), "rb") as fh:
        text = np.frombuffer(fh.read()[:T], np.uint8)
    data = np.stack([text, rng.integers(0, 4, T, dtype=np.uint8),
                     rng.integers(0, 256, T, dtype=np.uint8)])
    return data, np.array([T, T // 2 + 3, 7], np.int32)


@pytest.mark.parametrize("T", [256, 1024])
def test_encode_blocks_matches_jax(T):
    data, nbytes = _rows(T, T)
    want = [np.asarray(x) for x in jax_fb.encode_blocks(data, nbytes)]
    _kernels.reset_counts()
    words, nwords, low = fb.encode_blocks(torch.from_numpy(data), torch.from_numpy(nbytes))
    assert _kernels.plain_calls["fpaq_encode"] == 1
    assert words.dtype == nwords.dtype == low.dtype == torch.int32
    assert np.array_equal(words.numpy().view(np.uint32), want[0])
    assert np.array_equal(nwords.numpy(), want[1])
    assert np.array_equal(low.numpy(), want[2].astype(np.int32))
    assert (nwords.numpy() > 0).all()


def test_batch_payloads_match_host_encoder():
    rng = np.random.default_rng(2)
    with open(os.path.join(ROOT, "SURVEY.md"), "rb") as fh:
        text = fh.read()[:700]
    blocks = [text, rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
              rng.integers(0, 8, 500, dtype=np.uint8).tobytes(), b"\x55" * 200,
              rng.integers(0, 256, 64, dtype=np.uint8).tobytes()]
    outs = fb.fpaq_encode_device_batch(blocks, device="cpu")
    for b, (payload, bits) in zip(blocks, outs):
        host, hbits = native.entropy_encode(2, np.frombuffer(b, np.uint8),
                                            {"bsVersion": 6})
        assert payload == host and bits == hbits, len(b)


def test_encode_blocks_rejects_bad_inputs():
    with pytest.raises(TypeError):
        fb.encode_blocks(torch.zeros(2, 8, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        fb.encode_blocks(torch.zeros(2, 8, dtype=torch.uint8),
                         torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="no host route"):
        fb.fpaq_encode_device_batch([b"abc"], device=None)


def _scalar_model(row: bytes) -> np.ndarray:
    """The probability each bit of `row` is coded with, one Python int at
    a time: (len(row), 8)."""
    probs = [[1 << 15] * 256 for _ in range(4)]
    out = np.zeros((len(row), 8), np.int64)
    tbl = 0
    for t, val in enumerate(row):
        ctx = 1
        for k in range(8):
            p = probs[tbl][ctx]
            out[t, k] = p
            bit = (val >> (7 - k)) & 1
            probs[tbl][ctx] = p - ((p - 65472) // 64) if bit else p - (p >> 6)
            ctx = 2 * ctx + bit
        tbl = val >> 6
    return out


def test_model_probabilities_match_scalar_model():
    data, nbytes = _rows(300, 5)
    got = fb._fpaq_model_plain(torch.from_numpy(data), torch.from_numpy(nbytes))
    assert got.shape == (3, 300, 8)
    for b in range(3):
        n = int(nbytes[b])
        assert np.array_equal(got[b, :n].numpy(), _scalar_model(data[b, :n].tobytes())), b


# K11's ring halves hold 256 bytes: rows of different lengths in one batch,
# nbytes 0 and 1, rows ending at, just past and several halves beyond a
# half's end; the model's probabilities through the coder, against
# kanzi_tpu's encode_blocks
@pytest.mark.parametrize("lengths", [(0, 1, 2, 255), (256, 257, 0, 1), (1100, 513, 769, 3)])
def test_model_then_coder_match_jax(lengths):
    T = max(lengths)
    rng = np.random.default_rng(T)
    with open(os.path.join(ROOT, "SURVEY.md"), "rb") as fh:
        text = np.frombuffer(fh.read()[:T], np.uint8)
    data = np.stack([text, rng.integers(0, 256, T, dtype=np.uint8),
                     rng.integers(0, 3, T, dtype=np.uint8), text[::-1]])
    nbytes = np.array(lengths, np.int32)
    want = [np.asarray(x) for x in jax_fb.encode_blocks(data, nbytes)]
    d, nb = torch.from_numpy(data), torch.from_numpy(nbytes)
    words, nwords, low = fb._fpaq_coder_plain(d, nb, fb._fpaq_model_plain(d, nb))
    assert np.array_equal(words.numpy().view(np.uint32), want[0])
    assert np.array_equal(nwords.numpy(), want[1])
    assert np.array_equal(low.numpy(), want[2].astype(np.int32))
