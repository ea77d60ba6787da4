"""Huffman lane ops of the PyTorch port against the JAX package: pack_lanes
and decode_lanes equal kanzi_tpu.ops.huffman exactly, on random and real
tables carried across by to_port_state; the one-shot device encode and
decode equal the host C++ engine."""

import os

import numpy as np
import pytest
import torch

from kanzi_tpu import native as jax_native
from kanzi_tpu.ops import huffman as jax_huffman
from kanzi_tpu_torch import _kernels, native
from kanzi_tpu_torch.entropy.huffman_device import (DeviceHuffmanEngine,
                                                    huffman_decode_device,
                                                    huffman_encode_device)
from kanzi_tpu_torch.ops import huffman as ops_huffman
from kanzi_tpu_torch.ops.state import to_port_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()


def _random_tables(rng, C):
    """(len<<12)|code entries whose codes fit their lengths, as the host's
    canonical tables do; some symbols absent (entry 0)."""
    ln = rng.integers(1, 13, (C, 256))
    code = rng.integers(0, 1 << 12, (C, 256)) & ((1 << ln) - 1)
    tab = (ln << 12) | code
    tab[rng.random((C, 256)) < 0.1] = 0
    return tab.astype(np.int32)


def _pack_both(syms, lane_len, table_idx, tables):
    want_w, want_n = jax_huffman.pack_lanes(syms, lane_len, table_idx,
                                            tables.astype(np.int32))
    st = to_port_state({"syms": syms, "lane_len": lane_len,
                        "table_idx": table_idx, "tables": tables}, "cpu")
    got_w, got_n = ops_huffman.pack_lanes(st["syms"], st["lane_len"],
                                          st["table_idx"], st["tables"])
    assert got_w.dtype == torch.int32 and got_n.dtype == torch.int32
    assert got_w.shape == (len(syms), ops_huffman._nwords(syms.shape[1]))
    assert np.array_equal(got_w.numpy().view(np.uint32), np.asarray(want_w))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    return got_w, got_n


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("frag", [ops_huffman.FRAG, 512])
def test_pack_lanes_random_tables(dtype, frag):
    rng = np.random.default_rng(frag + np.dtype(dtype).itemsize)
    L, C = 10, 3
    syms = rng.integers(0, 256, (L, frag)).astype(dtype)
    lane_len = rng.integers(0, frag + 1, L).astype(np.int32)
    lane_len[:3] = [frag, 0, 1]           # full lane, zero row, one symbol
    syms[1] = 0
    table_idx = rng.integers(0, C, L).astype(np.int32)
    _pack_both(syms, lane_len, table_idx, _random_tables(rng, C))


def test_pack_lanes_identity_tables():
    # the inputs of entry(): 8-bit identity table, full lanes
    rng = np.random.default_rng(7)
    L, C = 8, 2
    syms = rng.integers(0, 256, (L, ops_huffman.FRAG), dtype=np.int32)
    tables = ((8 << 12) | np.arange(256, dtype=np.int32))[None, :].repeat(C, 0)
    w, n = _pack_both(syms, np.full(L, ops_huffman.FRAG, np.int32),
                      rng.integers(0, C, L, dtype=np.int32), tables)
    assert (n.numpy() == 8 * ops_huffman.FRAG).all()
    # identity codes: the packed bytes are the symbols themselves
    assert ops_huffman.words_to_bytes(w[0])[:ops_huffman.FRAG] == \
        syms[0].astype(np.uint8).tobytes()


@pytest.mark.parametrize("n", [16384 * 3, 16384 + 33 * 4 + 8, 5000])
def test_pack_lanes_real_tables(n):
    # real host tables (uint16 from huffman_prepare) and real lane rows,
    # partial last chunk included
    data = np.frombuffer(_TEXT[:n], dtype=np.uint8)
    tables, _hdr, _bits, flags = native.huffman_prepare(data)
    jtables, *_ = jax_native.huffman_prepare(data)
    assert np.array_equal(tables, jtables)
    _preps, (syms, lens, tidx, tabs) = DeviceHuffmanEngine("cpu").lane_batch([data])
    assert syms.dtype == np.uint8 and len(syms) % 64 == 0 and len(tabs) % 16 == 0
    _pack_both(syms, lens, tidx, tabs)


def _decode_cases():
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


@pytest.mark.parametrize("name", list(_decode_cases()))
def test_decode_lanes_and_device_codec(name):
    data = _decode_cases()[name]
    buf = np.frombuffer(data, np.uint8)
    payload, bits = jax_native.entropy_encode(1, buf, {"bsVersion": 6})
    # the one-shot device encode equals the host engine
    dev_payload, dev_bits = huffman_encode_device(data, "cpu")
    assert (dev_payload, dev_bits) == (payload, bits)
    dtables, lanes, flags, _aux = jax_native.huffman_dec_prepare(
        np.frombuffer(payload, np.uint8), len(data))
    if len(lanes):
        table_idx = np.repeat(np.nonzero(flags == 0)[0].astype(np.int32), 4)
        want = np.asarray(jax_huffman.decode_lanes(lanes, table_idx, dtables))
        st = to_port_state({"lanes": lanes, "table_idx": table_idx,
                            "dtables": dtables}, "cpu")
        got = ops_huffman.decode_lanes(st["lanes"], st["table_idx"], st["dtables"])
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want)
    _kernels.reset_counts()
    assert huffman_decode_device(payload, len(data), "cpu") == data
    assert _kernels.plain_calls["decode_lanes"] == (1 if len(lanes) else 0)
    assert _kernels.launches["decode_lanes"] == 0


def test_to_port_state_dtypes_and_copies():
    rng = np.random.default_rng(1)
    arrays = {
        "tables": rng.integers(0, 1 << 16, (2, 256)).astype(np.uint16),
        "dtables": rng.integers(0, 1 << 16, (2, 4096)).astype(np.uint16),
        "syms": rng.integers(0, 256, (4, 64)).astype(np.uint8),
        "lanes": rng.integers(0, 256, (4, 6160)).astype(np.uint8),
        "lane_len": np.full(4, 64, np.int32),
        "table_idx": np.zeros(4, np.int32),
    }
    st = to_port_state(arrays, "cpu")
    assert st["tables"].dtype == torch.int32
    assert np.array_equal(st["tables"].numpy(), arrays["tables"].astype(np.int32))
    assert st["dtables"].dtype == torch.int16
    assert np.array_equal(st["dtables"].numpy().view(np.uint16), arrays["dtables"])
    assert st["syms"].dtype == torch.uint8 and st["lanes"].dtype == torch.uint8
    arrays["lanes"][:] = 0   # the state is a copy, not a view
    assert st["lanes"].numpy().any()
    with pytest.raises(KeyError):
        to_port_state({"weights": arrays["syms"]}, "cpu")
    with pytest.raises(TypeError):
        to_port_state({"dtables": arrays["dtables"].astype(np.int32)}, "cpu")


@pytest.mark.parametrize("bad,err", [
    (lambda z: ops_huffman.pack_lanes(z["syms"].long(), z["lane_len"],
                                      z["table_idx"], z["tables"]), TypeError),
    (lambda z: ops_huffman.pack_lanes(z["syms"], z["lane_len"][:2],
                                      z["table_idx"], z["tables"]), ValueError),
    (lambda z: ops_huffman.decode_lanes(z["lanes"], z["table_idx"],
                                        z["dtables"].int()), TypeError),
    (lambda z: ops_huffman.decode_lanes(z["lanes"][:, ::2], z["table_idx"],
                                        z["dtables"]), ValueError),
    # a table index out of range would read past the tables in the kernels
    (lambda z: ops_huffman.pack_lanes(z["syms"], z["lane_len"],
                                      z["table_idx"] + 1, z["tables"]), ValueError),
    (lambda z: ops_huffman.pack_lanes(z["syms"], z["lane_len"],
                                      z["table_idx"] - 1, z["tables"]), ValueError),
    (lambda z: ops_huffman.decode_lanes(z["lanes"], z["table_idx"] + 1,
                                        z["dtables"]), ValueError),
    (lambda z: ops_huffman.decode_lanes(z["lanes"], z["table_idx"] - 1,
                                        z["dtables"]), ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    z = {"syms": torch.zeros(4, 64, dtype=torch.uint8),
         "lane_len": torch.zeros(4, dtype=torch.int32),
         "table_idx": torch.zeros(4, dtype=torch.int32),
         "tables": torch.zeros(1, 256, dtype=torch.int32),
         "lanes": torch.zeros(4, 6160, dtype=torch.uint8),
         "dtables": torch.zeros(1, 4096, dtype=torch.int16)}
    with pytest.raises(err):
        bad(z)

