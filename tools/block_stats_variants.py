#!/usr/bin/env python3
"""Time variants of the fused block-stats kernel on one CUDA card.

    python3 tools/block_stats_variants.py [--out FILE]

Each variant is kanzi_tpu_torch/csrc/block_stats.cu with some of its
constants changed (warp pairs a CTA, 16-byte loads a group, groups
prefetched into L2) or with its cluster size forced, built by nvcc into
kanzi_tpu_torch/build/variants/ and called through its own kz_block_stats.
Every variant is held against the plain version (histograms exact, entropy
within 1) and timed with chip_smoke.device_ms (launches back to back behind
a spin kernel) on chip_smoke's 16 corpus blocks of 4 MiB, as many random
and all-zero bytes, one block, the corpus as 64 rows of 1 MiB and its first
MiB as 256 rows of 4 KiB. Prints one line a variant and shape, then one
JSON line (also written to --out) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# name -> edits: a constant's new value, or "cluster" to force c
VARIANTS = {
    "shipped": {},
    "cluster 8 (two waves at 16 rows)": {"cluster": 8},
    "kPairs 2 (4 warps)": {"kPairs": 2},
    "kPrefetch 0 (no L2 prefetch)": {"kPrefetch": 0},
    "kPrefetch 4": {"kPrefetch": 4},
    "kUnroll 4": {"kUnroll": 4},
}
PICK = "const int rc0 = pick_cluster(B, n, &c);"


def variant_source(src: str, edits: dict) -> str:
    for name, value in edits.items():
        if name == "cluster":
            cs.check(PICK in src, "block_stats.cu: pick_cluster call not found")
            src = src.replace(PICK, f"{PICK} c = {value};")
        else:
            src, k = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
            cs.check(k == 1, f"block_stats.cu: constant {name} not found")
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("block_stats_variants: no CUDA device", file=sys.stderr)
        return 2
    from kanzi_tpu_torch import _kernels as K
    from kanzi_tpu_torch.ops import block_stats as bs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    out_dir = os.path.join(K.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "kanzi_tpu_torch", "csrc", "block_stats.cu")) as fh:
        src = fh.read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as fh:
            fh.write(variant_source(src, edits))
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        cs.check(p.returncode == 0, f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(so)
        lib.kz_block_stats.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        libs[name] = lib

    cuda = torch.device("cuda")
    raw = np.frombuffer(cs.synth_corpus(cs.CORPUS), np.uint8).reshape(-1, cs.BLOCK)
    corpus = torch.from_numpy(raw.copy()).to(cuda)
    rng = np.random.default_rng(cs.SEED)
    shapes = {"(16, 4 MiB)": corpus,
              "random (16, 4 MiB)": torch.from_numpy(
                  rng.integers(0, 256, raw.shape, np.uint8)).to(cuda),
              "zeros (16, 4 MiB)": torch.zeros_like(corpus), "(1, 4 MiB)": corpus[:1],
              "(64, 1 MiB)": corpus.view(64, -1),
              "(256, 4 KiB)": corpus.view(-1)[:1 << 20].view(256, 4096)}
    result = {"device": smi, "times_ms": {}}
    for label, x in shapes.items():
        B, N = x.shape
        hp, ep = bs._block_stats_plain(x)
        h = torch.empty(B, 256, dtype=torch.int32, device=cuda)
        e = torch.empty(B, dtype=torch.int32, device=cuda)
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.kz_block_stats(x.data_ptr(), B, N, h.data_ptr(), e.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"{name}: launch failed with error {rc}")
            h.fill_(-1)
            call()
            torch.cuda.synchronize()
            cs.check(torch.equal(h, hp) and int((e - ep).abs().max().item()) <= 1,
                     f"{name} at {label}: kernel != plain")
            ms = [cs.device_ms(torch, call) for _ in range(2)]
            result["times_ms"][f"{name} {label}"] = ms
            print(f"{label} {name}: device {ms[0]:.5f}, {ms[1]:.5f} ms", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
