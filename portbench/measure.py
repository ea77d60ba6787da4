"""The arithmetic of the end-to-end metrics and of the block events.

Times are seconds unless a name says otherwise. A run's calls are the
operation's calls of its window (decompress calls), each (object, start,
end, bytes returned, error or None); its window ends where its last call
ends.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MB = 1e6
MIB = 1 << 20


@dataclass
class Call:
    obj: int
    start: float
    end: float
    nbytes: int
    error: str | None = None


@dataclass
class Run:
    """What a window left for the metric readers: the calls, the launch
    counts, the Reader's block events of each call (traced runs), the
    reduced trace (traced runs, on a card: trace.Trace, the device's
    intervals and the program's spans) and the work of each object's
    blocks, [(entropy id, entropy payload bytes, entropy output bytes)]."""
    calls: list
    window_s: float
    launches: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    trace: object = None
    work: list = field(default_factory=list)

    @property
    def bytes_out(self) -> int:
        return sum(c.nbytes for c in self.calls if c.error is None)

    @property
    def mib_out(self) -> float:
        return self.bytes_out / MIB


def decompress_MBps(run: Run) -> float:
    """Bytes returned over the whole window, in MB/s (10^6 bytes)."""
    return run.bytes_out / MB / run.window_s


def card_ms_per_mb(run: Run) -> float | None:
    """The card's busy time (trace.Trace.busy_s: the union of its kernel,
    copy and set intervals over the window) per MB that the window's calls
    returned: what a restore holds the card for. None without a trace or
    with no device time in it."""
    if run.trace is None or run.trace.busy_s <= 0 or run.bytes_out <= 0:
        return None
    return 1e3 * run.trace.busy_s / (run.bytes_out / MB)


def device_ms_per_mb(run: Run, *needles: str) -> float | None:
    """Device time of the operations whose name holds any needle
    (trace.Trace.device_seconds) per MB returned. None without a trace or
    where no such operation ran."""
    if run.trace is None or run.bytes_out <= 0:
        return None
    seconds = run.trace.device_seconds(*needles)
    if seconds <= 0:
        return None
    return 1e3 * seconds / (run.bytes_out / MB)


def batches(log) -> list:
    """A call's entropy stage by batch, (first BEFORE_ENTROPY, last
    AFTER_ENTROPY) of each: a batch is a run of BEFORE_ENTROPY events,
    which the Reader sends for all of a batch's blocks before its launch."""
    spans, before, after, prev = [], {}, {}, None
    for kind, block, t in log:
        if kind == "BEFORE_ENTROPY":
            if prev != "BEFORE_ENTROPY" and before:
                spans.append((before, after))
                before, after = {}, {}
            before[block] = t
        elif kind == "AFTER_ENTROPY":
            after[block] = t
        prev = kind
    if before:
        spans.append((before, after))
    return [(min(b.values()), max(a[k] for k in b)) for b, a in spans
            if all(k in a for k in b)]


def entropy_seconds(log) -> float:
    return sum(e - s for s, e in batches(log))


def transform_seconds(log) -> float:
    """BEFORE_TRANSFORM to AFTER_TRANSFORM of each block, summed: thread
    time, since a batch's blocks run their inverse at once."""
    start, total = {}, 0.0
    for kind, block, t in log:
        if kind == "BEFORE_TRANSFORM":
            start[block] = t
        elif kind == "AFTER_TRANSFORM" and block in start:
            total += t - start.pop(block)
    return total


def idle_share(run: Run) -> float | None:
    """The device's idle share of a traced window: 1 - the union of its
    kernel, copy and set intervals over the window's wall time."""
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s


def launches_per_mib(run: Run) -> float | None:
    """Kernel launches of the window (the program's launch counter) per MiB
    that the window's calls returned."""
    if run.mib_out <= 0:
        return None
    return sum(run.launches.values()) / run.mib_out


def entropy_ms_per_mib(run: Run) -> float | None:
    """The Reader's entropy stage, ms per MiB returned: from each batch's
    first BEFORE_ENTROPY to its last AFTER_ENTROPY, summed over the calls."""
    if not run.events or run.mib_out <= 0:
        return None
    return 1e3 * sum(entropy_seconds(log) for log in run.events) / run.mib_out


def transform_ms_per_mib(run: Run) -> float | None:
    """The native block inverse, ms per MiB returned: BEFORE_TRANSFORM to
    AFTER_TRANSFORM of every block, summed over blocks (thread time)."""
    if not run.events or run.mib_out <= 0:
        return None
    return 1e3 * sum(transform_seconds(log) for log in run.events) / run.mib_out


def span_ms_per_mib(run: Run, *needles: str) -> float | None:
    """Thread time inside the program's spans whose name holds any needle
    (trace.Trace.span_seconds), ms per MiB returned: the convention of
    transform_ms_per_mib. None where the run has no trace or no span
    matches."""
    if run.trace is None or run.mib_out <= 0:
        return None
    seconds = run.trace.span_seconds(*needles)
    if seconds is None:
        return None
    return 1e3 * seconds / run.mib_out
