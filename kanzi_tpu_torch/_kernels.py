"""Build and bind the port's CUDA kernels, and count their launches.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain ``extern "C"`` launch API, loaded with
ctypes. The build runs at first use, into ``kanzi_tpu_torch/build/``, under
an exclusive file lock, and is redone only when a source is newer than its
library. Nothing is compiled when the package is imported, so the package
imports on hosts without ``nvcc`` or a card; there the wrappers in ``ops/``
take their plain PyTorch versions for CPU tensors and raise for anything
else.

Every launch API returns ``cudaGetLastError()``; ``launch`` raises when it
is not 0 and counts the launch. ``launches`` holds one plain integer per
kernel, ``plain_calls`` one per plain version; both are counted under a
lock, since Writers and Readers on several threads launch at once;
``walk_counts`` counts the host's steps of the device RANGE decode's chunk
walk beside them.

A failure of the card, and not of the data, raises ``DeviceFault``: a
refused launch, a failed build, and an error that the CUDA context reports
(``torch.AcceleratorError``, a device allocation that fails), which
``card_errors`` converts where the engines launch and read back. The
engines keep a rejected payload as its block's result; a ``DeviceFault``
is never one.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
# source -> {C function: argtypes}
_API = {
    "block_stats.cu": {
        "kz_block_stats": [_P, _I, _I, _P, _P, _P],
        "kz_histograms_u8": [_P, _I, _I, _P, _P],
        "kz_entropy1024": [_P, _P, _I, _P, _P],
        "kz_block_stats_cluster": [_I, _I, _P],
        "kz_empty_launch": [_P],
    },
    "huffman.cu": {
        "kz_pack_lanes_u8": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
        "kz_pack_lanes_i32": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
        "kz_decode_lanes": [_P, _I, _I, _P, _P, _I, _P, _P, _P],
    },
    "ans.cu": {
        "kz_ans_encode_u8": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "kz_ans_encode_u16": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "kz_ans_decode": [_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                          _P, _P, _P, _I, _I, _P],
        "kz_ans_decode_scratch": [_I, _I, _I, _I],
    },
    "range.cu": {
        "kz_range_encode": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
        "kz_range_decode": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                            _P],
    },
    "suffix_sort.cu": {
        "kz_prefix_double": [_P, _I, _I, _P, _P, _P, _I, _P],
        "kz_prefix_double_scratch": [_I],
        "kz_prefix_double_active": [_P, _I],
    },
    "bwt_inverse.cu": {
        "kz_lf_walk": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    },
    "fpaq_batch.cu": {
        "kz_fpaq_encode": [_P, _P, _I, _I, _P, _P, _P, _P],
    },
}

# functions that return a value, not cudaGetLastError()
_RESTYPE = {"kz_block_stats_cluster": ctypes.c_int64,
            "kz_ans_decode_scratch": ctypes.c_int64,
            "kz_prefix_double_scratch": ctypes.c_int64,
            "kz_prefix_double_active": ctypes.c_int64}

KERNELS = ("block_stats", "histograms_u8", "entropy1024", "pack_lanes",
           "decode_lanes", "ans_encode", "ans_decode", "range_encode",
           "range_decode", "prefix_double", "lf_walk", "fpaq_encode")
launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}
# the host's native steps of the device RANGE decode's chunk walk: one a
# chunk index of a batch (range_steps), and the rows it parsed again with
# room for all that a chunk can read (range_reparsed)
walk_counts = {"range_steps": 0, "range_reparsed": 0}

_fns: dict = {}
_lock = threading.Lock()
build_log: dict = {}      # source -> nvcc's output (ptxas register report)
build_seconds = 0.0


class DeviceFault(RuntimeError):
    """The card failed, not the data: a launch the CUDA runtime refused, a kernel
    build that failed, or an error read back from the CUDA context. Never
    a payload's rejection: the Reader raises it as it is, under the block's
    id, and never as a corrupt block (KanziError)."""


# torch's own types for an error of the CUDA context and for a device
# allocation that failed
_CARD_ERRORS = (torch.AcceleratorError, torch.OutOfMemoryError)


@contextlib.contextmanager
def card_errors(where: str):
    """Raise an error of the card inside the block as DeviceFault, named
    by `where`; every other exception passes unchanged."""
    try:
        yield
    except DeviceFault:
        raise
    except _CARD_ERRORS as e:
        raise DeviceFault(f"{where}: {e}") from e


def reset_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
        plain_calls[k] = 0
    for k in walk_counts:
        walk_counts[k] = 0


def resolve_device(device) -> torch.device | None:
    """None stays None (the host C++ path); "cuda" needs a card and raises
    without one — no request for the card ever runs on the CPU instead."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is available; "
            "pass device='cpu' for the plain PyTorch versions or device=None "
            "for the host C++ path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {device!r}")
    return dev


def resolve_scan_device(device) -> torch.device:
    """resolve_device for the device scans (BWT, FPAQ), which have no host
    route: None raises ValueError."""
    dev = resolve_device(device)
    if dev is None:
        raise ValueError("the device scans have no host route: pass device='cuda' "
                         "or device='cpu'")
    return dev


# the plain versions' stand-in for a card's SM count (chains_a_wave)
PLAIN_SMS = 16


def chains_a_wave(device: torch.device) -> int:
    """Rows that one wave of the one-CTA-a-row decode kernels (K6, K8) runs
    on `device`: the card's SM count, or PLAIN_SMS for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return PLAIN_SMS


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceFault("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(src: str) -> str:
    return os.path.join(BUILD_DIR, "lib" + src.replace(".cu", ".so"))


def _stale(src: str) -> bool:
    lib = _lib_path(src)
    return (not os.path.exists(lib)
            or os.path.getmtime(os.path.join(_CSRC, src)) >= os.path.getmtime(lib))


def build() -> float:
    """Compile every stale source, one nvcc per source, all started
    together. Returns the seconds spent (0.0 when nothing was stale)."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [s for s in _API if _stale(s)]
            if not todo:
                return 0.0
            t0 = time.perf_counter()
            nvcc = _nvcc()
            procs = []
            for src in todo:
                tmp = _lib_path(src) + f".{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, tmp, p in procs:
                out, _ = p.communicate()
                build_log[src] = out
                if p.returncode != 0:
                    failed.append(f"{src}:\n{out}")
                else:
                    os.replace(tmp, _lib_path(src))
            if failed:
                raise DeviceFault("nvcc failed:\n" + "\n".join(failed))
            build_seconds = time.perf_counter() - t0
            return build_seconds
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _fn(name: str):
    f = _fns.get(name)
    if f is not None:
        return f
    with _lock:
        if not _fns:
            build()
            for src, api in _API.items():
                try:
                    lib = ctypes.CDLL(_lib_path(src))
                except OSError as e:
                    raise DeviceFault(f"cannot load the kernels of {src}: {e}") from e
                for fname, argtypes in api.items():
                    fn = getattr(lib, fname)
                    fn.argtypes = argtypes
                    fn.restype = _RESTYPE.get(fname, ctypes.c_int)
                    _fns[fname] = fn
    return _fns[name]


def launch(kernel: str | tuple, cfunc: str, device: torch.device, *args) -> None:
    """Call one launch API on `device`'s current stream; raise DeviceFault
    on a launch error, count the launch otherwise: once for each kernel
    named, where a fused launch runs the bodies of several."""
    fn = _fn(cfunc)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise DeviceFault(f"{cfunc}: CUDA launch failed with error {rc}")
    with _lock:  # device Writers and Readers on several threads launch at once
        for k in (kernel,) if isinstance(kernel, str) else kernel:
            launches[k] += 1


def count_plain(kernel: str) -> None:
    """Count one call of `kernel`'s plain version."""
    with _lock:
        plain_calls[kernel] += 1


def count_walk(name: str, n: int = 1) -> None:
    """Count `n` of walk_counts[name]."""
    with _lock:
        walk_counts[name] += n


def query(cfunc: str, *args):
    """Call a host function of a kernel library (no launch, no count)."""
    return _fn(cfunc)(*args)


def check(t: torch.Tensor, name: str, dtypes, ndim: int,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of one of `dtypes` with
    `ndim` dimensions on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dimensions, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_index(idx: torch.Tensor, name: str, bound: int) -> None:
    """Raise unless every value of `idx` lies in [0, bound), for the plain
    versions (the kernels flag such an index themselves). One reduction,
    read on the host."""
    if idx.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo < 0 or hi >= bound:
        raise ValueError(f"{name}: values in [{lo}, {hi}], expected [0, {bound})")


def route(t: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA tensor; raise otherwise."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"unsupported device {t.device}")
