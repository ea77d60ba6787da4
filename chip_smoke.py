#!/usr/bin/env python3
"""Drive kanzi_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each failing hard (no exception is caught):

1. the card's name and power limit, and the time to build the kernels
   (nvcc, one process per source under kanzi_tpu_torch/csrc/);
2. kernels: each of the four kernels against its plain PyTorch version on
   the card, at the shapes of the main path, with its median time from
   CUDA events, its roofline bound and (where one exists) the time of one
   PyTorch library call computing the same function;
3. the slice: a 64 MiB seeded corpus through compress/decompress at levels
   2 and 3 on the card, byte-identical to the host C++ path;
4. compress_step on the real blocks and lanes, checked against numpy and
   the integer entropy reference;
5. a profile of the level 2 device path: the device's busy share
   (torch.profiler) and the host functions that take the time (cProfile).

It then prints one JSON line with every kernel's numbers and, last, the
result line {"ok": true, "device": {...}}. Without a card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
BLOCK = 4 * MIB
CORPUS = 64 * MIB
SEED = 0x4B414E5A
SLICE_REPS = 3

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and
# the non-tensor-core rate, taken for the integer and float32 work here
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synth_corpus(size: int, seed: int = SEED) -> bytes:
    """Deterministic mixed corpus (text/binary/dna/zeros/random), the port's
    copy of the JAX package's bench corpus. The text is SURVEY.md beside
    this script, with per-copy perturbations."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(HERE, "SURVEY.md"), "rb") as fh:
        text = fh.read()
    parts = []
    tpart = []
    while sum(map(len, tpart)) < int(size * 0.45):
        arr = np.frombuffer(text, dtype=np.uint8).copy()
        idx = rng.integers(0, len(arr), len(arr) // 64)
        arr[idx] = rng.integers(32, 127, len(idx), dtype=np.uint8)
        tpart.append(arr.tobytes())
    parts.append(b"".join(tpart))
    n = int(size * 0.20) // 4
    vals = np.cumsum(rng.integers(-3, 4, n, dtype=np.int32)).astype("<i4")
    parts.append(vals.tobytes())
    dna = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, int(size * 0.10))]
    parts.append(dna.tobytes())
    z = np.zeros(int(size * 0.10), dtype=np.uint8)
    idx = rng.integers(0, len(z), len(z) // 50)
    z[idx] = rng.integers(1, 256, len(idx), dtype=np.uint8)
    parts.append(z.tobytes())
    parts.append(rng.integers(0, 256, int(size * 0.15), dtype=np.uint8).tobytes())
    blob = b"".join(parts)[:size]
    arr = np.frombuffer(blob, dtype=np.uint8)
    m = (len(arr) >> 20) << 20
    strided = arr[:m].reshape(-1, MIB)
    order = rng.permutation(len(strided))
    return strided[order].tobytes() + arr[m:].tobytes()


def median_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median of per-call device times from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_level2(torch, kt, corpus: bytes) -> None:
    """One level 2 device compress and decompress under torch.profiler (the
    device's busy time against the wall time) and one of each under
    cProfile (the host functions that take the time). Runs after the
    measured phases: both profilers slow the host."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    def encode():
        return kt.compress(corpus, level=2, jobs=4, checksum=32, device="cuda")

    blob = encode()
    for label, fn in (("encode", encode),
                      ("decode", lambda: kt.decompress(blob, device="cuda"))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        dev = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.self_device_time_total > 0}
        if dev:
            busy = sum(dev.values())
            top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
            print(f"level 2 {label} under torch.profiler: wall {wall_ms} ms, "
                  f"device busy {busy} ms (sum of device self times), idle "
                  f"share {1 - busy / wall_ms}; top device: {top}", flush=True)
        else:
            print(f"level 2 {label} under torch.profiler: wall {wall_ms} ms, "
                  "no device time recorded: busy share not measured", flush=True)
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(8)
        lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
        print(f"level 2 {label} under cProfile, top host functions by own time:")
        print("\n".join(lines[-9:]), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kanzi_tpu_torch")):
        print("chip_smoke: kanzi_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    import kanzi_tpu_torch as kt
    from kanzi_tpu_torch import _kernels as K, internal, native, parallel
    from kanzi_tpu_torch.entropy.huffman_device import DeviceHuffmanEngine
    from kanzi_tpu_torch.ops import block_stats, huffman as ops_huffman
    from kanzi_tpu_torch.ops.state import to_port_state

    t0 = time.perf_counter()
    K.build()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc, {len(K.build_log)} sources in parallel)", flush=True)
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    corpus = synth_corpus(CORPUS)
    raw = np.frombuffer(corpus, dtype=np.uint8).reshape(-1, BLOCK)   # (16, 4 MiB)
    results = {}

    # -- 2. kernels against their plain versions, at main-path shapes -----
    print("== kernels", flush=True)
    blocks = torch.from_numpy(raw.copy()).to(cuda)
    B, N = blocks.shape
    h_k = block_stats.histograms_u8(blocks)
    h_p = block_stats._histograms_plain(blocks)
    check(torch.equal(h_k, h_p), "histograms_u8 kernel != plain")
    idx64 = blocks.long()
    ones64 = torch.ones_like(idx64)
    lib_out = torch.zeros(B, 256, dtype=torch.int64, device=cuda)
    ms = median_ms(torch, lambda: block_stats.histograms_u8(blocks), 20)
    plain_ms = median_ms(torch, lambda: block_stats._histograms_plain(blocks), 5)
    lib_ms = median_ms(torch, lambda: lib_out.zero_().scatter_add_(1, idx64, ones64), 5)
    del idx64, ones64, lib_out
    bms, bby = bound(B * N + B * 256 * 4, B * N)
    results["histograms_u8"] = dict(
        source="kanzi_tpu_torch/csrc/block_stats.cu",
        replaces="kanzi_tpu/ops/pallas_kernels.py:27", shape=[B, N],
        max_abs_err=float((h_k - h_p).abs().max().item()), ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=lib_ms)

    lengths = torch.full((B,), N, dtype=torch.int32, device=cuda)
    e_k = block_stats.entropy1024(h_k, lengths)
    e_p = block_stats._entropy_plain(h_k, lengths)
    err = int((e_k - e_p).abs().max().item())
    check(err <= 1, f"entropy1024 kernel vs plain differ by {err} > 1")
    ms = median_ms(torch, lambda: block_stats.entropy1024(h_k, lengths), 50)
    plain_ms = median_ms(torch, lambda: block_stats._entropy_plain(h_k, lengths), 20)
    bms, bby = bound(B * 256 * 4 + 2 * B * 4, 4 * B * 256)
    results["entropy1024"] = dict(
        source="kanzi_tpu_torch/csrc/block_stats.cu",
        replaces="kanzi_tpu/ops/pallas_kernels.py:67", shape=[B, 256],
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=bby, library_ms=None)

    # K3 on the lane batch of four raw blocks, real tables
    engine = DeviceHuffmanEngine(cuda)
    posts4 = [raw[i] for i in range(4)]
    _, batch = engine.lane_batch(posts4)
    syms_np, lens_np, tidx_np, tables_np = batch
    st = to_port_state({"syms": syms_np, "lane_len": lens_np,
                        "table_idx": tidx_np, "tables": tables_np}, cuda)
    args = (st["syms"], st["lane_len"], st["table_idx"], st["tables"])
    w_k, n_k = ops_huffman.pack_lanes(*args)
    w_p, n_p = ops_huffman._pack_lanes_plain(*args)
    check(torch.equal(w_k, w_p) and torch.equal(n_k, n_p),
          "pack_lanes kernel != plain")
    L, frag = st["syms"].shape
    ms = median_ms(torch, lambda: ops_huffman.pack_lanes(*args), 20)
    plain_ms = median_ms(torch, lambda: ops_huffman._pack_lanes_plain(*args), 3)
    nsym = int(lens_np.sum())
    bms, bby = bound(L * frag + 2 * L * 4 + tables_np.shape[0] * 256 * 4
                     + L * ops_huffman.WORDS * 4 + L * 4, 5 * nsym)
    results["pack_lanes"] = dict(
        source="kanzi_tpu_torch/csrc/huffman.cu",
        replaces="kanzi_tpu/ops/huffman.py:28", shape=[L, frag],
        max_abs_err=float(max((w_k.long() - w_p.long()).abs().max().item(),
                              (n_k - n_p).abs().max().item())),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None)
    del w_p, n_p

    # K4 on the real lanes of the same four blocks' host Huffman payloads
    lanes_l, tidx_l, dt_l, base = [], [], [], 0
    for post in posts4:
        payload, _ = native.entropy_encode(1, post, {"bsVersion": 6})
        dt, lanes, flags, _ = native.huffman_dec_prepare(
            np.frombuffer(payload, np.uint8), len(post))
        lanes_l.append(lanes.copy())
        tidx_l.append(np.repeat(np.nonzero(flags == 0)[0].astype(np.int32), 4) + base)
        dt_l.append(dt.copy())
        base += len(dt)
    st = to_port_state({"lanes": np.concatenate(lanes_l),
                        "table_idx": np.concatenate(tidx_l),
                        "dtables": np.concatenate(dt_l)}, cuda)
    dargs = (st["lanes"], st["table_idx"], st["dtables"])
    s_k = ops_huffman.decode_lanes(*dargs)
    s_p = ops_huffman._decode_lanes_plain(*dargs)
    check(torch.equal(s_k, s_p), "decode_lanes kernel != plain")
    L, S = st["lanes"].shape
    ms = median_ms(torch, lambda: ops_huffman.decode_lanes(*dargs), 10)
    plain_ms = median_ms(torch, lambda: ops_huffman._decode_lanes_plain(*dargs), 1, 0)
    bms, bby = bound(L * S + L * 4 + st["dtables"].numel() * 2 + L * ops_huffman.FRAG,
                     10 * L * ops_huffman.FRAG)
    results["decode_lanes"] = dict(
        source="kanzi_tpu_torch/csrc/huffman.cu",
        replaces="kanzi_tpu/ops/huffman.py:85", shape=[L, S],
        max_abs_err=float((s_k.int() - s_p.int()).abs().max().item()),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None)
    del s_p
    for name, r in results.items():
        print(f"{name}: shape {r['shape']} kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library {r['library_ms']}, "
              f"max_abs_err {r['max_abs_err']}", flush=True)

    # -- 3. the slice: Writer/Reader on the card --------------------------
    # SLICE_REPS runs of each path, device and host C++ in turns, so that
    # the spread shows beside the medians
    print("== slice", flush=True)
    K.reset_counts()
    for level, jobs in ((2, 4), (3, 1)):
        before = dict(K.launches)
        runs = {k: [] for k in ("device encode", "device decode",
                                "host C++ encode", "host C++ decode")}
        for _ in range(SLICE_REPS):
            for device, name in (("cuda", "device"), (None, "host C++")):
                t = time.perf_counter()
                blob = kt.compress(corpus, level=level, jobs=jobs, checksum=32,
                                   device=device)
                torch.cuda.synchronize()
                runs[f"{name} encode"].append(len(corpus) / (time.perf_counter() - t) / 1e6)
                t = time.perf_counter()
                back = kt.decompress(blob, device=device)
                torch.cuda.synchronize()
                runs[f"{name} decode"].append(len(corpus) / (time.perf_counter() - t) / 1e6)
                check(back == corpus, f"level {level}: {name} decode != input")
                if device is None:
                    check(blob == dev_blob,
                          f"level {level}: device stream != host C++ stream")
                else:
                    dev_blob = blob
        d = {k: K.launches[k] - before[k] for k in K.KERNELS}
        print(f"level {level} jobs {jobs}: {len(corpus)} -> {len(dev_blob)} bytes, "
              f"launches {d}", flush=True)
        for k, v in runs.items():
            print(f"  {k}: median {statistics.median(v)} MB/s, runs {v}", flush=True)
    slice_launches = dict(K.launches)
    check(slice_launches["pack_lanes"] > 0, "slice: pack_lanes never launched")
    check(slice_launches["decode_lanes"] > 0, "slice: decode_lanes never launched")
    check(sum(K.plain_calls.values()) == 0, "slice: a plain version ran")

    # -- 4. compress_step on the real blocks and lanes ---------------------
    print("== compress_step", flush=True)
    handles = engine.dispatch_many(posts4)
    writer_words, writer_nbits = handles[0][4].get()
    K.reset_counts()
    histos, ent, words, nbits, total = parallel.compress_step(
        raw, syms_np, lens_np, tidx_np, tables_np, device="cuda")
    torch.cuda.synchronize()
    step_launches = dict(K.launches)
    for k in ("histograms_u8", "entropy1024", "pack_lanes"):
        check(step_launches[k] > 0, f"compress_step: {k} never launched")
    want = np.stack([np.bincount(r, minlength=256) for r in raw])
    check(np.array_equal(histos.cpu().numpy(), want), "histograms != np.bincount")
    ent = ent.cpu().numpy()
    for i, r in enumerate(raw):
        ref = internal.first_order_entropy_1024(
            len(r), internal.compute_histogram_order0(r))
        check(abs(int(ent[i]) - ref) <= 8, f"block {i}: entropy {ent[i]} vs {ref}")
        check((ent[i] >= 973) == (ref >= 973), f"block {i}: gate disagrees")
    check(int(total.item()) == int(nbits.sum().item()), "total_bits != sum(nbits)")
    check(np.array_equal(words.cpu().numpy(), writer_words)
          and np.array_equal(nbits.cpu().numpy(), writer_nbits),
          "compress_step words != the Writer engine's")
    print(f"compress_step: {B} blocks, {len(nbits)} lanes, total_bits "
          f"{int(total.item())}, entropy1024 {ent.tolist()}, launches "
          f"{step_launches}", flush=True)

    # -- 5. where the time of the level 2 device path goes ----------------
    print("== profile", flush=True)
    profile_level2(torch, kt, corpus)

    kernels = []
    for name in K.KERNELS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": slice_launches[name] + step_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        check(kernels[-1]["launches"] > 0, f"{name}: no launch on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
