"""The PyTorch port stands alone: no module of kanzi_tpu_torch, and not
chip_smoke.py, imports jax or kanzi_tpu, and the port imports and
round-trips with both blocked: the library, the CLI (`python -m
kanzi_tpu_torch`) and the multi-process striping."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kanzi_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "kanzi_tpu")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    sources = list(_port_sources())
    assert len(sources) > 20
    bad = []
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        bad += [(os.path.relpath(path, ROOT), r) for r in _imported_roots(tree)
                if r in FORBIDDEN]
    assert not bad, bad


_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

for k in list(sys.modules):
    if k.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu"):
        del sys.modules[k]
sys.meta_path.insert(0, Block())

import numpy as np
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import _kernels
from kanzi_tpu_torch import parallel  # noqa: F401

rng = np.random.default_rng(9)
text = b"the port imports without jax or the reference package. " * 900
data = text + rng.integers(0, 4, 20000, dtype=np.uint8).tobytes()
for level in (2, 3):
    blob = kt.compress(data, level=level, block_size=1 << 16, checksum=32,
                       device="cpu")
    assert blob == kt.compress(data, level=level, block_size=1 << 16,
                               checksum=32, device=None)
    assert kt.decompress(blob, device="cpu") == data
assert _kernels.plain_calls["pack_lanes"] > 0
assert _kernels.plain_calls["decode_lanes"] > 0

# the CLI, as `python -m kanzi_tpu_torch`, on the host C++ path
import os, runpy, tempfile
from unittest import mock
with tempfile.TemporaryDirectory() as tmp:
    src = os.path.join(tmp, "in.bin")
    with open(src, "wb") as fh:
        fh.write(data)
    for argv in (["-c", "-i", src, "-o", src + ".knz", "-l", "2", "-j", "2"],
                 ["-d", "-i", src + ".knz", "-o", src + ".out", "-j", "2"]):
        with mock.patch.object(sys, "argv", ["kanzi_tpu_torch", *argv, "--device", "none"]):
            try:
                runpy.run_module("kanzi_tpu_torch", run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, e.code
    with open(src + ".out", "rb") as fh:
        assert fh.read() == data
    with open(src + ".knz", "rb") as fh:
        assert fh.read() == kt.compress(data, level=2, device=None)

# the host multi-process striping (spawned workers import the port alone)
from kanzi_tpu_torch.parallel import compress_multiproc
assert compress_multiproc(data, transform="LZ", entropy="HUFFMAN", block_size=1 << 14,
                          procs=2) == kt.compress(data, transform="LZ", entropy="HUFFMAN",
                                                  block_size=1 << 14, device=None)
leaked = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "kanzi_tpu")]
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED-OK" in res.stdout
