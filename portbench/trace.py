"""Reduction of a torch.profiler trace (Chrome trace JSON) to device time.

The traced window is the host annotation named WINDOW. Busy time is the
union of the device's kernel, copy and set intervals inside it, so that
work on two streams at once counts once; idle time is the rest. Each idle
gap is named by the host event that covers most of it, or as host code
outside torch operations where none covers half of it.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime"}
OUTSIDE = "host code outside torch operations"
SHORT = "shorter gaps"
LABELLED_GAPS = 5000         # the longest gaps are named one by one
NAME_CHARS = 96


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list = field(default_factory=list)   # (name, start_us, end_us), clipped
    idle_gaps: list = field(default_factory=list)  # [[label, seconds]], longest first

    def device_seconds(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds any needle."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in needles)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(float)
        for n, s, e in self.device:
            total[n[:NAME_CHARS]] += (e - s) / 1e6
        return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:top]


def merge(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def load(path: str) -> list:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce(events: list, top: int = 10) -> Trace:
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and str(e.get("cat", "")).lower() == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} windows named {WINDOW}")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((str(e.get("name", "")), s, t))
        elif cat in HOST_CATS:
            host.append((str(e.get("name", "")), s, t))
    merged = merge((s, e) for _, s, e in device)
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return Trace((w1 - w0) / 1e6, busy / 1e6, device, name_gaps(gaps, host, top))


def name_gaps(gaps: list, host: list, top: int) -> list:
    """Idle seconds by what the host was doing, longest first."""
    total = defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    names = [n for n, _, _ in host]
    starts = np.array([s for _, s, _ in host], dtype=np.float64)
    ends = np.array([e for _, _, e in host], dtype=np.float64)
    for i, (g0, g1) in enumerate(gaps):
        if i >= LABELLED_GAPS:
            total[SHORT] += (g1 - g0) / 1e6
            continue
        label = OUTSIDE
        if len(names):
            cover = np.clip(np.minimum(ends, g1) - np.maximum(starts, g0), 0, None)
            j = int(np.argmax(cover))
            if cover[j] >= 0.5 * (g1 - g0):
                label = names[j][:NAME_CHARS]
        total[label] += (g1 - g0) / 1e6
    return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:top]
