#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload range.archive --seed 7 --seconds 20 --trace 0

From the root of a checkout that holds `kanzi_tpu_torch`. A cell is a
configuration (`configs/<name>.json`: the Writer's and Reader's settings)
under a traffic mix (`traffic/<name>.json`, read by traffic.py). Set-up
makes the mix's objects from the seed and hands them to the mix's
operation (`operations/<name>.py`), which does its own set-up: for
`decompress`, it writes each object as a KANZ stream with
`kanzi_tpu_torch.compress` on the card and decodes one batch of the
largest and the smallest stream. Then one closed-loop client calls the
operation on the objects in the seed's order for `--seconds`, the last
call running to its end. With `--trace 0` the run reports the cell's
end-to-end metrics; with `--trace 1` it runs the same window under
torch.profiler, with the operation's own spans (for `decompress`, a
block-event listener on each Reader), and reports the cell's per-layer
metrics, each read by its own file `metrics/<name>.py`. A cell with an
end-to-end metric read from the device trace runs its `--trace 0` window
under torch.profiler too, without the operation's spans. After the
window, the operation's checks (check.py) decide `correct`.

The last line on stdout is one JSON object; the checks, each beside its
limit, are the last lines on stderr. Without a CUDA card the run exits 3
and prints no result; if jax, jaxlib, flax or kanzi_tpu is loaded once the
window has closed, it exits 4 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import measure, trace as tracing, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kanzi_tpu")
NO_CARD, FORBIDDEN_LOADED = 3, 4


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, key: str, workload: str) -> list:
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def profiled(bench: dict, workload: str, traced: bool) -> bool:
    """Whether the window runs under torch.profiler: a traced run, or one
    whose end-to-end metrics include one read from the device trace."""
    return traced or any(m["source"] == "device_trace"
                         for m in metrics_of(bench, "end_to_end", workload))


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def operation(name: str):
    """The module of `operations/<name>.py`."""
    return importlib.import_module(f"portbench.operations.{name}")


def closed_loop(call, order, seconds):
    """One client: `call` on the objects in `order`, cycling, each call
    after the one before, from the window's start until `seconds` have
    passed, the last call running to its end. Returns the calls, their
    answers and the window's start."""
    calls, outputs, k = [], [], 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        i = int(order[k % len(order)])
        k += 1
        out, error = None, None
        try:
            out = call(i)
        except Exception as e:  # a failed call is counted and judged
            error = repr(e)
            if not any(c.error for c in calls):
                traceback.print_exc()
        calls.append(measure.Call(i, t, time.perf_counter(), len(out or b""), error))
        outputs.append(out)
    return calls, outputs, start


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", mix=None, config=None) -> tuple:
    """One run of a cell: (the result's fields, the checks). `mix` and
    `config`, where given, stand in for the cell's files."""
    import torch

    from kanzi_tpu_torch import _kernels

    cell = cell_of(bench, workload)
    config = config or load_json(HERE, "configs", f"{cell['config']}.json")
    mix = mix or traffic.load(cell["traffic"])
    op = operation(mix.operation)
    on_card = device is not None and str(device).startswith("cuda")

    # set-up: inputs from the seed, then the operation's own (streams, warm-up)
    marks = [("imports", time.perf_counter())]
    objects = traffic.generate(mix, seed)
    marks.append(("inputs", time.perf_counter()))
    state = op.setup(config, objects.objects, device)
    if on_card:
        torch.cuda.synchronize()
    marks.append((mix.operation, time.perf_counter()))
    print("set-up: " + ", ".join(f"{name} {t - prev:.3f} s" for (name, t), prev
                                 in zip(marks, [T0] + [t for _, t in marks])),
          file=sys.stderr)
    _kernels.reset_counts()
    setup_s = time.perf_counter() - T0

    # the window
    profiler = None
    if profiled(bench, workload, traced):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.__enter__()
    with torch.profiler.record_function(tracing.WINDOW):
        calls, outputs, start = closed_loop(state.traced if traced else state.call,
                                            objects.order, seconds)
    run = measure.Run(calls, calls[-1].end - start, dict(_kernels.launches))
    ms = sorted(1e3 * (c.end - c.start) for c in calls)
    print(f"window: {len(calls)} calls in {run.window_s:.3f} s, call ms min {ms[0]:.1f} "
          f"median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}"
          + (", in order " + " ".join(f"{1e3 * (c.end - c.start):.1f}" for c in calls)
             if len(calls) <= 12 else ""), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    fields = {}
    if profiler is not None:
        profiler.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            profiler.export_chrome_trace(path)
            run.trace = tracing.reduce(tracing.load(path))
        finally:
            os.unlink(path)
    if traced and run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        fields["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps}

    # after the window: the checks, then the metrics
    checks = state.judge(run, outputs, seed, mix.checked_blocks)
    del outputs
    metrics = {}
    if not traced:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in metrics_of(bench, "per_layer" if traced else "end_to_end", workload):
        if m["name"] == "setup_s":
            continue
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(c.ok for c in checks),
              "attempted": len(calls),
              "failed": sum(c.error is not None for c in calls),
              "metrics": metrics, "device": dev, **fields,
              "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}
    return result, checks


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result: dict, checks: list) -> None:
    for c in checks:
        print(f"check {c.name} {c.value} limit {c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return NO_CARD
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return FORBIDDEN_LOADED
    report(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
