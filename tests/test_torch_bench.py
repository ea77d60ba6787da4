"""The port's bench (kanzi_tpu_torch.bench) against kanzi_tpu's bench.py.

- its corpora equal bench.py's byte for byte;
- the inputs of its device rows (K3, K5, K6, block_stats), built at a
  reduced size, give through the port's wrappers (their plain versions on
  the CPU) what kanzi_tpu.ops gives on the same numpy arrays;
- main() at a tiny size without a card: host rows measured, every device
  row "unavailable", no plain version run, the caller's launch counts
  left as they were; with the probe saying "card" where there is none,
  the device call raises and nothing is printed;
- `gpu`-marked twins run the same tiny main() on a card (every device row
  measured) and with a wrapper that raises.

kanzi_tpu is imported inside the tests that compare with it, so that the
`gpu` tests run where only PyTorch is installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_bench.py
"""

import builtins
import json
import os

import numpy as np
import pytest
import torch

from kanzi_tpu_torch import _kernels
from kanzi_tpu_torch import bench as port_bench
from kanzi_tpu_torch.ops import huffman as ops_huffman
from kanzi_tpu_torch.ops.state import to_port_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DEVICE_ROWS = ("device", "device_over_host")


def _jax_bench(monkeypatch):
    """kanzi_tpu's bench.py, reading SURVEY.md from this checkout."""
    monkeypatch.syspath_prepend(ROOT)
    import bench

    real_open = builtins.open

    def survey_here(path, *a, **k):
        if os.path.basename(str(path)) == "SURVEY.md":
            path = os.path.join(ROOT, "SURVEY.md")
        return real_open(path, *a, **k)

    monkeypatch.setattr(bench, "open", survey_here, raising=False)
    return bench


@pytest.mark.parametrize("name,size", [("synth_corpus", 1 << 20),
                                       ("synth_corpus", (3 << 20) + 12345),
                                       ("synth_hard_corpus", 1 << 18),
                                       ("synth_hard_corpus", 1 << 20)])
def test_corpora_equal_jax_bench(monkeypatch, name, size):
    bench = _jax_bench(monkeypatch)
    want = getattr(bench, name)(size)
    got = getattr(port_bench, name)(size)
    assert len(got) == len(want) and got == want


def test_corpus_without_survey_raises(monkeypatch):
    monkeypatch.setattr(port_bench.os.path, "isfile", lambda p: False)
    with pytest.raises(FileNotFoundError, match="SURVEY.md"):
        port_bench.synth_corpus(1 << 16)


def _device_inputs(name):
    """(bench row, numpy inputs) at a reduced size."""
    data = np.random.default_rng(2).integers(0, 64, 2 * port_bench.ANS_CHUNK,
                                             dtype=np.uint8)
    if name == "huffman_pack":
        return name, port_bench.pack_inputs(8)
    if name == "huffman_pack_tables":
        curve = np.random.default_rng(42).integers(0, 64, port_bench.CURVE_BLOCK,
                                                   dtype=np.uint8)
        return "huffman_pack", port_bench.pack_table_inputs(curve)
    if name == "ans_encode":
        return name, port_bench.ans_encode_inputs(data)
    if name == "ans_decode":
        return name, port_bench.ans_decode_inputs(data)
    return name, port_bench.stats_inputs(2, 16384)


def _jax_call(name, a):
    import jax.numpy as jnp
    from kanzi_tpu.ops import ans as jax_ans, huffman as jax_huffman
    from kanzi_tpu.ops.pallas_kernels import block_stats_pallas

    if name == "huffman_pack":
        out = jax_huffman.pack_lanes(a["syms"], a["lane_len"], a["table_idx"], a["tables"])
    elif name == "ans_encode":
        out = jax_ans.encode_chunks(a["ans_syms"].astype(np.int32), a["ngroups"],
                                    a["ans_tables"])
    elif name == "ans_decode":
        assert (a["lr"] == 12).all()
        out = jax_ans.decode_chunks(a["bufs"], a["states0"], a["f2s"], a["dtabs"],
                                    a["ngroups"], order=0, lr=12,
                                    glen=int(a["ngroups"].max()))
    else:
        out = block_stats_pallas(jnp.asarray(a["blocks"]), interpret=True)
    return [np.asarray(x) for x in out]


def _bits(x):
    """The array's bits as unsigned integers (the port carries u16 and u32
    in int16 and int32)."""
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


@pytest.mark.parametrize("case", ["huffman_pack", "huffman_pack_tables", "ans_encode",
                                  "ans_decode", "block_stats"])
def test_device_row_inputs_match_jax(case):
    name, arrays = _device_inputs(case)
    kernel, call = port_bench.device_calls(name, to_port_state(arrays, CPU))
    _kernels.reset_counts()
    got = [t.numpy() for t in call()]
    assert _kernels.plain_calls[kernel] == 1 and _kernels.launches[kernel] == 0
    want = _jax_call(name, arrays)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if name == "block_stats" and i == 1:      # the entropy: float sums in
            assert np.abs(g.astype(np.int64) - w).max() <= 1    # another order
        else:
            assert g.shape == w.shape and np.array_equal(_bits(g), _bits(w)), (case, i)


def _run_main(capsys, argv):
    assert port_bench.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def _rows(result):
    for sec in ("levels", "levels_hard"):
        yield from ((sec, k, r) for k, r in result[sec].items())


def test_main_without_card(monkeypatch, capsys):
    monkeypatch.setattr(port_bench, "device_available", lambda: False)
    _kernels.reset_counts()
    _kernels.launches["pack_lanes"] = 5          # a caller's counts
    try:
        result = _run_main(capsys, ["--size", "1m", "--runs", "1"])
        assert _kernels.launches["pack_lanes"] == 5
        assert sum(_kernels.plain_calls.values()) == 0
    finally:
        _kernels.reset_counts()
    assert list(result)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert "device=None" in result["metric"] and result["value"] > 0
    assert result["card"] == "unavailable" and result["build_s"] == "unavailable"
    assert "codecs" not in result and result["launches"] == {}
    assert set(result["levels"]) == set(port_bench.ROWS)
    assert set(result["levels_hard"]) == {"8", "9"}
    for sec, key, row in _rows(result):
        for d in ("encode_mbs", "decode_mbs"):
            s = row["host"][d]
            assert s["n"] == 1 and 0 < s["min"] <= s["q1"] <= s["median"] <= s["q3"] <= s["max"]
        assert all(row[k] == "unavailable" for k in DEVICE_ROWS), (sec, key)
        assert row["kernel"] == (key in port_bench.KERNEL_ROWS) and 0 < row["ratio"] < 1.1
    assert result["levels"]["1"]["bytes"] == 1 << 20
    assert set(result["kernels"]) == set(_kernels.KERNELS)
    for sec in ("device_kernels", "batch_curve", "kernels"):
        assert all(v == "unavailable" for v in result[sec].values()), sec
    assert result["corpus"]["bytes"] == 1 << 20 and result["corpus"]["seed"] == port_bench.SEED
    assert result["host_cores"] == len(os.sched_getaffinity(0))


def test_codecs_without_card(monkeypatch, capsys):
    monkeypatch.setattr(port_bench, "device_available", lambda: False)
    result = _run_main(capsys, ["--codecs", "--size", "256k", "--runs", "1",
                                "--levels", "2,ans1"])
    assert set(result["levels"]) == {"2", "ANS1"} and result["levels_hard"] == {}
    assert result["value"] is None                 # level 1 was not selected
    codecs = result["codecs"]
    assert codecs["bytes"] == 256 << 10
    assert set(codecs["entropy"]) == set(port_bench.ENTROPY_CODECS)
    for name, row in codecs["entropy"].items():
        assert row["host"]["encode_mbs"]["median"] > 0
        assert row.get("device") == ("unavailable" if name in port_bench.DEVICE_CODECS
                                     else None), name
    assert set(codecs["transforms"]) == set(port_bench.TRANSFORMS)
    for name, row in codecs["transforms"].items():
        assert row["forward_mbs"]["median"] > 0
        assert row["skipped"] or row["inverse_mbs"]["median"] > 0, name


def test_rows_flag_rejects_unknown_rows():
    assert port_bench.parse_args(["--levels", "2, 3,range"]).levels == ["2", "3", "RANGE"]
    with pytest.raises(SystemExit):
        port_bench.parse_args(["--levels", "2,ANS2"])


def test_device_failure_fails_the_run(monkeypatch, capsys):
    # the probe says "card" where there is none: the first device call
    # raises, and the bench neither catches it nor prints a result
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    monkeypatch.setattr(port_bench, "device_available", lambda: True)
    monkeypatch.setattr(port_bench.K, "build", lambda: 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_bench.main(["--size", "256k", "--runs", "1", "--levels", "2"])
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_main_on_card(card, capsys):
    _kernels.reset_counts()
    result = _run_main(capsys, ["--size", "1m", "--runs", "1"])
    assert sum(_kernels.plain_calls.values()) == 0
    assert "device='cuda'" in result["metric"] and result["value"] > 0
    assert result["card"].startswith(torch.cuda.get_device_name(0))
    assert result["build_s"] >= 0
    for sec, key, row in _rows(result):
        for d in ("encode_mbs", "decode_mbs"):
            assert row["device"][d]["median"] > 0 and row["host"][d]["median"] > 0
        assert row["device_over_host"]["encode"] > 0
        assert bool(row["device"]["launches"]) == (key in port_bench.KERNEL_ROWS)
    assert list(result["kernels"]) == list(_kernels.KERNELS)
    for name, row in result["kernels"].items():
        assert row["ms"]["median"] > 0 and row["launches"] > 0, name
        assert row["bound_by"] in ("bytes", "operations") and 0 < row["bound_share"], name
        # short calls: device time apart, but for wrappers that wait on it
        if row["ms"]["median"] < 1 and name not in port_bench.WAITING_WRAPPERS:
            assert row["device_ms"]["median"] > 0, name
    for row in result["device_kernels"].values():
        assert row["ms"]["median"] > 0 and row["readback"]["ms"]["median"] > 0
    for point in result["batch_curve"].values():
        assert all(r["gbps"] > 0 for r in point.values())


@pytest.mark.gpu
def test_failing_wrapper_fails_the_run_on_card(card, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("pack_lanes broken on purpose")

    monkeypatch.setattr(ops_huffman, "pack_lanes", broken)
    with pytest.raises(Exception, match="broken on purpose"):
        port_bench.main(["--size", "1m", "--runs", "1", "--levels", "2"])
    assert capsys.readouterr().out == ""
