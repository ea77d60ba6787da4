"""The metric arithmetic, on made-up calls, events and traces."""

import pytest

from portbench import measure, peaks, trace
from portbench.measure import Call, Run


def calls_at(durations, gap=0.0):
    out, t = [], 0.0
    for d in durations:
        out.append(Call(0, t, t + d, 10 ** 6))
        t += d + gap
    return out


def test_rate_is_all_bytes_over_the_whole_window_and_a_stall_lowers_it():
    steady = calls_at([0.1] * 10)
    run = Run(steady, steady[-1].end - steady[0].start)
    assert measure.decompress_MBps(run) == pytest.approx(10.0)
    stalled = calls_at([0.1] * 9 + [1.0])
    run2 = Run(stalled, stalled[-1].end - stalled[0].start)
    assert measure.decompress_MBps(run2) == pytest.approx(10 / 1.9)
    # a failed call returns nothing, and its time still counts
    failed = calls_at([0.1] * 10)
    failed[3].error, failed[3].nbytes = "boom", 0
    assert measure.decompress_MBps(Run(failed, 1.0)) == pytest.approx(9.0)


def window_events(*spans, host=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100}]
    for cat, s, e in spans:
        ev.append({"ph": "X", "cat": cat, "name": f"{cat}-op", "ts": s, "dur": e - s})
    for name, s, e in host:
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": s, "dur": e - s})
    return ev


def test_idle_share_is_a_union_so_concurrent_streams_count_once():
    ev = window_events(("kernel", 10, 50), ("kernel", 20, 40), ("gpu_memcpy", 45, 60),
                       ("kernel", 90, 120))
    t = trace.reduce(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(60e-6)       # 10-60 and 90-100, clipped
    summed = sum(min(e, 100) - s for _, s, e in [(0, 10, 50), (0, 20, 40), (0, 45, 60),
                                                 (0, 90, 120)])
    assert summed * 1e-6 > t.busy_s
    assert trace.merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_idle_gaps_are_named_by_the_host_event_that_covers_them():
    ev = window_events(("kernel", 10, 50), host=[("aten::copy_", 50, 85)])
    t = trace.reduce(ev)
    gaps = dict((n, s) for n, s in t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(50e-6)        # 50-100, 35 covered
    assert gaps[trace.OUTSIDE] == pytest.approx(10e-6)        # 0-10


def test_the_window_must_be_in_the_trace():
    with pytest.raises(ValueError):
        trace.reduce([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}])


class FakeTrace:
    def __init__(self, seconds):
        self.seconds = seconds

    def device_seconds(self, *needles):
        return self.seconds


@pytest.mark.parametrize("entropy", [4, 8])
def test_roofline_reads_100_at_its_own_bound_and_no_more(entropy):
    work = [[(entropy, 3 << 20, 4 << 20), (entropy, 1 << 20, 4 << 20)]]
    calls = [Call(0, 0.0, 1.0, 8 << 20), Call(0, 1.0, 2.0, 8 << 20)]
    nbytes = nops = 0
    for e, p, o in work[0] * 2:
        b, n = peaks.decode_work(e, p, o)
        nbytes, nops = nbytes + b, nops + n
    least, by = peaks.least_seconds(nbytes, nops)
    assert by == "bytes"
    run = Run(calls, 2.0, work=work, trace=FakeTrace(least))
    assert peaks.roofline_percent(run, entropy, ("k",)) == pytest.approx(100.0)
    run.trace = FakeTrace(least * 1.5)
    assert peaks.roofline_percent(run, entropy, ("k",)) < 100.0
    run.trace = FakeTrace(0.0)
    assert peaks.roofline_percent(run, entropy, ("k",)) is None
    run.work = [[(12 - entropy, 3 << 20, 4 << 20)]]
    run.trace = FakeTrace(least)
    assert peaks.roofline_percent(run, entropy, ("k",)) == 0.0


def test_decode_work_counts_each_byte_once_and_a_table_a_chunk():
    assert peaks.decode_work(4, 100, 32768 * 2 + 1) == (100 + 65537 + 3 * 2048, 10 * 65537)
    assert peaks.decode_work(8, 100, 4 << 20) == (100 + (4 << 20) + 524288, 6 * (4 << 20))


def test_block_events_by_batch_and_by_block():
    log = [("BEFORE_ENTROPY", 1, 0.0), ("BEFORE_ENTROPY", 2, 0.1),
           ("AFTER_ENTROPY", 1, 1.0), ("BEFORE_TRANSFORM", 1, 1.0), ("AFTER_TRANSFORM", 1, 1.5),
           ("AFTER_ENTROPY", 2, 1.1), ("BEFORE_TRANSFORM", 2, 1.1), ("AFTER_TRANSFORM", 2, 1.3),
           ("BEFORE_ENTROPY", 3, 2.0),
           ("AFTER_ENTROPY", 3, 2.5), ("BEFORE_TRANSFORM", 3, 2.5), ("AFTER_TRANSFORM", 3, 2.6)]
    assert measure.batches(log) == [(0.0, 1.1), (2.0, 2.5)]
    assert measure.entropy_seconds(log) == pytest.approx(1.6)
    assert measure.transform_seconds(log) == pytest.approx(0.5 + 0.2 + 0.1)


class BusyTrace(FakeTrace):
    window_s, busy_s = 2.0, 1.5


def every_metric():
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"] if m["name"] != "setup_s"]


@pytest.mark.parametrize("name", every_metric())
def test_every_metric_has_a_reader_that_reads_a_run_or_nothing(name):
    from portbench import run as harness
    read = harness.reader(name)
    log = [("BEFORE_ENTROPY", 1, 0.0), ("AFTER_ENTROPY", 1, 0.5),
           ("BEFORE_TRANSFORM", 1, 0.5), ("AFTER_TRANSFORM", 1, 0.7)]
    work = [[(4, 3 << 20, 4 << 20), (8, 3 << 20, 4 << 20)]]
    full = Run(calls_at([1.0, 1.0]), 2.0, {"k": 8}, [log, log], BusyTrace(1.0), work)
    empty = Run(calls_at([1.0]), 1.0)
    value = read(full)
    assert isinstance(value, float) and value > 0
    if name == "decompress_MBps":
        assert read(empty) == pytest.approx(1.0)
    elif name.startswith("launches"):
        assert read(empty) == 0.0
    else:
        assert read(empty) is None
