#!/usr/bin/env python3
"""Time an earlier checkout's kernels against this one's on one CUDA card,
on the same inputs, in turns.

    python3 tools/torch_kernel_ab.py OLD_ROOT [CASE ...] [--out FILE]

OLD_ROOT is the root of an earlier checkout of this repository (for
example a `git archive` of the parent commit, unpacked). Its
kanzi_tpu_torch/_kernels.py and ops/ are imported as a package of their
own (kanzi_tpu_torch_old; its __init__ does not run), so its kernels build
from its own csrc/ into its own build/ directory. Both versions are called
through their public wrappers in ops/, whose signatures the port keeps; an
output argument that only one version's wrapper names (decode_lanes' `bad`)
is passed where the wrapper takes it. The inputs are those of
chip_smoke.py's kernel phase. Each case is timed old, new, new, old, each
turn the median of CUDA-event times of one call, and again in the same
order as the mean device time of the call's kernel launches
(torch.profiler), which leaves out the host's share where the kernel is
shorter than the wrapper's host work, and for short calls (20 or more
repetitions) as the time of calls run back to back behind a spin kernel
(chip_smoke.device_ms); the two versions' outputs must be identical, but
for a float32 sum taken in another order (TOLERANCE). Prints one JSON line (and writes it to --out, if given): the
card's name and power limit, and per case the four turns of each, in ms.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def old_ops(root: str):
    """The earlier checkout's ops module loader: name -> module."""
    name = "kanzi_tpu_torch_old"
    pkg = types.ModuleType(name)
    pkg.__path__ = [os.path.join(os.path.abspath(root), "kanzi_tpu_torch")]
    sys.modules[name] = pkg
    return lambda mod: importlib.import_module(f"{name}.ops.{mod}")


def device_ms(torch, fn, reps: int) -> float | None:
    """Mean device time of one call of fn: the device times torch.profiler
    records over `reps` calls after one warm-up (every launch of a call,
    memsets included), divided by `reps`. It leaves out the host's share of
    the call. None where no device time is recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return total / reps if total > 0 else None


def call(fn, args, outs):
    """fn(*args) with the output arguments its signature names, as a tuple."""
    params = inspect.signature(fn).parameters
    got = fn(*args, **{k: v for k, v in outs.items() if k in params})
    return got if isinstance(got, tuple) else (got,)


def cases(torch, kt, native, raw, cuda):
    """case name -> (ops module, wrapper name, args, output arguments, reps)."""
    from kanzi_tpu_torch.entropy import ans_device, device_io, range_device
    from kanzi_tpu_torch.entropy.huffman_device import DeviceHuffmanEngine
    from kanzi_tpu_torch.ops.state import to_port_state

    out = {}
    # K1K2: the block statistics of the 16 blocks as compress_step makes
    # them (the parent's memset, K1, fill and K2; one fused launch now),
    # and of as many random and all-zero bytes
    rng = np.random.default_rng(cs.SEED)
    for label, x in (("corpus", raw), ("random", rng.integers(0, 256, raw.shape, np.uint8)),
                     ("zeros", np.zeros_like(raw))):
        out[f"K1K2 {label} {list(raw.shape)}"] = ("block_stats", "block_stats",
                                                  (torch.from_numpy(x.copy()).to(cuda),), {}, 50)
    posts4 = [raw[i] for i in range(4)]
    engine = DeviceHuffmanEngine(cuda)
    # K3: four raw blocks' lanes, and the level 3 Writer's launch
    for posts in (posts4, cs.transform_posts(native, kt, raw[:1], cs.LEVEL3_CHAIN,
                                             "HUFFMAN")):
        _, b = engine.lane_batch(posts)
        st = to_port_state(dict(zip(("syms", "lane_len", "table_idx", "tables"), b)), cuda)
        args = (st["syms"], st["lane_len"], st["table_idx"], st["tables"])
        out[f"K3 {list(args[0].shape)}"] = ("huffman", "pack_lanes", args, {}, 20)

    lanes_l, tidx_l, dt_l, base = [], [], [], 0
    for post in posts4:
        payload, _ = native.entropy_encode(1, post, {"bsVersion": 6})
        dt, lanes, flags, _ = native.huffman_dec_prepare(np.frombuffer(payload, np.uint8),
                                                         len(post))
        lanes_l.append(lanes.copy())
        tidx_l.append(np.repeat(np.nonzero(flags == 0)[0].astype(np.int32), 4) + base)
        dt_l.append(dt.copy())
        base += len(dt)
    for arrays in ((lanes_l[0], tidx_l[0], dt_l[0]),      # the Reader's launch
                   [np.concatenate(x) for x in (lanes_l, tidx_l, dt_l)]):
        st = to_port_state(dict(zip(("lanes", "table_idx", "dtables"), arrays)), cuda)
        args = (st["lanes"], st["table_idx"], st["dtables"])
        bad = torch.empty(len(args[0]), dtype=torch.int32, device=cuda)
        out[f"K4 {list(args[0].shape)}"] = ("huffman", "decode_lanes", args,
                                            {"bad": bad}, 10)

    posts5 = cs.transform_posts(native, kt, raw[:4], cs.LEVEL5_CHAIN, "ANS0")
    for label, order, posts, reps in (("K5 ANS0", 0, posts5, 10),
                                      ("K5 ANS1", 1, list(raw[:4]), 3)):
        st = to_port_state(ans_device.DeviceANSEngine(order, cuda).encode_batch(posts)[1],
                           cuda)
        args = (st["ans_syms"], st["ngroups"], st["ans_tables"])
        out[f"{label} {list(args[0].shape)}"] = ("ans", "encode_chunks", args, {}, reps)
    # K6: one block's host ANS0 payload (level 5) and one raw block's ANS1
    # payload, as the Reader decodes them (with the host rule, where the
    # wrapper takes it)
    for label, etype, order, post, reps in (("K6 ANS0", 5, 0, posts5[0], 10),
                                            ("K6 ANS1", 8, 1, raw[0], 3)):
        payload, _ = native.entropy_encode(etype, post, {"bsVersion": 6})
        batch, _ = ans_device.decode_batch(np.frombuffer(payload, np.uint8), len(post), order)
        st = to_port_state(batch, cuda)
        glen = int(batch["ngroups"].max())
        args = tuple(st[k] for k in ("bufs", "nbytes", "states0", "f2s", "dtabs", "ngroups",
                                     "lr")) + (order, glen)
        out[f"{label} {[len(batch['ngroups']), glen, 4]}"] = ("ans", "decode_chunks", args,
                                                            {"host": True}, reps)

    # K7: the RANGE Writer's batch (transform LZ, jobs=4: four 4 MiB
    # blocks); K8: the first chunks of the four blocks' host RANGE payloads
    posts_lz = cs.transform_posts(native, kt, raw[:4], "LZ", "RANGE")
    st = to_port_state(range_device.DeviceRangeEngine(cuda).encode_batch(posts_lz)[1], cuda)
    args = (st["rng_syms"], st["nvalid"], st["rng_tables"], st["shifts"])
    out[f"K7 {list(args[0].shape)}"] = ("range", "encode_chunks", args, {}, 10)
    # (the batched Reader's four rows; the engine's host rules, `nbits` and
    # `bound`, where the wrapper takes them)
    batch = device_io.stack([range_device.chunk_batch(np.frombuffer(
        native.entropy_encode(4, p, {"bsVersion": 6})[0], np.uint8), 0,
        range_device._CHUNK)[2] for p in posts_lz])
    st = to_port_state(batch, cuda)
    args = (st["bufs"], st["nbytes"], st["rng_tables"], st["f2s"], st["shifts"],
            st["nvalid"], range_device._CHUNK)
    out[f"K8 [{len(posts_lz)}, {range_device._CHUNK}]"] = (
        "range", "decode_chunks", args, {"nbits": st["nbits"], "bound": st["bound"]}, 20)
    # K9: a corpus block and the period-2 block, as the BWT forward sorts them
    for label, blk in (("corpus", raw[0]), ("period2", cs.period2_block(len(raw[0])))):
        out[f"K9 {label}"] = ("suffix_sort", "prefix_double",
                              (cs.padded_block(torch, blk, cuda), len(blk)), {}, 5)
    # K10 on the 16 blocks' textbook BWTs (16, 4 MiB + 1) and K11 on the 16
    # blocks, as chip_smoke's bwt_fpaq phase runs them
    from kanzi_tpu_torch.ops import bwt_inverse as ops_bi, suffix_sort as ops_ss
    _, last, prim = cs.textbook(ops_ss, raw, cuda)
    last_t = torch.from_numpy(last).to(cuda)
    lf, _ = ops_bi.build_lf(last_t)
    out[f"K10 {list(last.shape)}"] = ("bwt_inverse", "lf_walk",
                                      (last_t, lf, torch.from_numpy(prim).to(cuda),
                                       last.shape[1]), {}, 2)
    B, N = raw.shape
    out[f"K11 {[B, N]}"] = ("fpaq_batch", "encode_blocks",
                            (torch.from_numpy(raw.copy()).to(cuda),
                             torch.full((B,), N, dtype=torch.int32, device=cuda)), {}, 2)
    return out


# largest difference allowed between the two versions' outputs, by case
# prefix: K1K2's entropy is a float32 sum, taken in another order by the
# fused kernel (histograms stay exact)
TOLERANCE = {"K1K2": 1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_root")
    ap.add_argument("case", nargs="*", help="case names' prefixes (default: all)")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import kanzi_tpu_torch as kt
    from kanzi_tpu_torch import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    old = old_ops(args.old_root)
    cuda = torch.device("cuda")
    raw = np.frombuffer(cs.synth_corpus(cs.CORPUS), np.uint8).reshape(-1, cs.BLOCK)
    result = {"device": smi, "cases": {}}
    for label, (mod, fname, fargs, outs, reps) in cases(torch, kt, native, raw,
                                                        cuda).items():
        if args.case and not any(label.startswith(c) for c in args.case):
            continue
        new_fn = getattr(importlib.import_module(f"kanzi_tpu_torch.ops.{mod}"), fname)
        old_fn = getattr(old(mod), fname)
        run_old = lambda: call(old_fn, fargs, outs)  # noqa: E731
        run_new = lambda: call(new_fn, fargs, outs)  # noqa: E731
        got_old, got_new = run_old(), run_new()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(got_old, got_new))
        diff = max((float((a.long() - b.long()).abs().max()) if a.numel() else 0.0)
                   if isinstance(a, torch.Tensor) else float(a != b)
                   for a, b in zip(got_old, got_new))
        tol = next((t for k, t in TOLERANCE.items() if label.startswith(k)), 0)
        cs.check(diff <= tol, f"{label}: old and new outputs differ by {diff} > {tol}")
        turns = (run_old, run_new, run_new, run_old)
        ms = [cs.median_ms(torch, f, reps) for f in turns]
        dev = [device_ms(torch, f, reps) for f in turns]
        case = {"old_ms": [ms[0], ms[3]], "new_ms": [ms[1], ms[2]],
                "old_device_ms": [dev[0], dev[3]], "new_device_ms": [dev[1], dev[2]],
                "identical": same, "max_abs_diff": diff}
        line = (f"{label}: old {ms[0]:.4f}, new {ms[1]:.4f}, new {ms[2]:.4f}, "
                f"old {ms[3]:.4f} ms a call; device time old {dev[0]}, new {dev[1]}, "
                f"new {dev[2]}, old {dev[3]} ms")
        if reps >= 20:   # a short call: also back to back behind a spin kernel
            spin = [cs.device_ms(torch, f) for f in turns]
            case.update(old_spin_ms=[spin[0], spin[3]], new_spin_ms=[spin[1], spin[2]])
            line += (f"; back to back old {spin[0]:.5f}, new {spin[1]:.5f}, new "
                     f"{spin[2]:.5f}, old {spin[3]:.5f} ms")
        result["cases"][label] = case
        print(f"{line}; outputs identical: {same} (max abs diff {diff})", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
