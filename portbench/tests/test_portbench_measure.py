"""The metric arithmetic, on made-up calls, events and traces."""

import pytest

from portbench import measure, peaks, reference, trace
from portbench.measure import Call, Run

# the entropy ids whose reference file gives the roofline's work
WORK = sorted(i for i, codec in reference.codecs("entropy").items() if hasattr(codec, "work"))


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


def chrome_trace():
    """Kernels on two streams, a copy and a set, host events, and the
    program's nested spans on two threads, some past the window's ends;
    a device-side projection of a span and an instant event, neither a
    span."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 1000,
           "pid": 1, "tid": 1}]

    def x(cat, name, s, e, tid=1):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s, "pid": 1,
                   "tid": tid})
    x("kernel", "range_decode_kernel", 100, 300, 7)
    x("kernel", "ans_decode_kernel", 250, 420, 8)
    x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 500, 560, 7)
    x("gpu_memset", "Memset (Device)", 700, 710, 7)
    x("kernel", "range_decode_kernel", 980, 1100, 7)
    x("kernel", "early_kernel", -40, 20, 7)
    x("cpu_op", "aten::to", 430, 495)
    x("cuda_runtime", "cudaStreamSynchronize", 560, 690)
    x("cpu_op", "aten::empty", 0, 5)
    x("user_annotation", "kanzi.read", 50, 900)
    x("user_annotation", "kanzi.frame", 100, 200)
    x("user_annotation", "kanzi.frame", 300, 400)
    x("user_annotation", "kanzi.inverse", 720, 950, 2)
    x("user_annotation", "kanzi.inverse", 950, 1100, 2)
    x("user_annotation", "kanzi.before", -50, 30, 2)
    x("user_annotation", "kanzi.after", 1200, 1300, 2)
    x("gpu_user_annotation", "kanzi.read", 100, 900, 7)
    ev.append({"ph": "i", "cat": "user_annotation", "name": "marker", "ts": 10, "pid": 1,
               "tid": 1})
    return ev


def test_spans_are_kept_and_change_nothing_else_the_trace_reads():
    ev = chrome_trace()
    t = trace.reduce(ev)
    # what trace.reduce read from this trace before it kept spans
    assert t.window_s == pytest.approx(1000e-6) and t.busy_s == pytest.approx(430e-6)
    assert t.device == [("range_decode_kernel", 100.0, 300.0),
                        ("ans_decode_kernel", 250.0, 420.0),
                        ("Memcpy HtoD (Pinned -> Device)", 500.0, 560.0),
                        ("Memset (Device)", 700.0, 710.0),
                        ("range_decode_kernel", 980.0, 1000.0), ("early_kernel", 0.0, 20.0)]
    assert [n for n, _ in t.idle_gaps] == [trace.OUTSIDE, "cudaStreamSynchronize", "aten::to"]
    assert [s for _, s in t.idle_gaps] == pytest.approx([350e-6, 140e-6, 80e-6])
    # and the same without the spans
    bare = trace.reduce([e for e in ev if e["cat"] != "user_annotation"
                         or e["name"] == trace.WINDOW])
    assert (bare.window_s, bare.busy_s, bare.device, bare.idle_gaps, bare.spans) == \
        (t.window_s, t.busy_s, t.device, t.idle_gaps, [])
    assert t.device_ops() == bare.device_ops()
    assert t.spans == [("kanzi.read", 1, 50.0, 900.0), ("kanzi.frame", 1, 100.0, 200.0),
                       ("kanzi.frame", 1, 300.0, 400.0), ("kanzi.inverse", 2, 720.0, 950.0),
                       ("kanzi.inverse", 2, 950.0, 1000.0), ("kanzi.before", 2, 0.0, 30.0)]


def test_span_seconds_is_thread_time_and_a_nested_match_counts_once():
    t = trace.reduce(chrome_trace())
    assert t.span_seconds("kanzi.frame") == pytest.approx(200e-6)
    assert t.span_seconds("kanzi.inverse") == pytest.approx(280e-6)
    # thread 1: 50-900 holds both frames; thread 2: 0-30 and 720-1000
    assert t.span_seconds("kanzi.") == pytest.approx(850e-6 + 310e-6)
    assert t.span_seconds("kanzi.frame", "kanzi.inverse") == pytest.approx(480e-6)
    assert t.span_seconds("kanzi.after") is None and t.span_seconds("nothing") is None


def test_span_ms_per_mib_reads_a_span_or_nothing():
    calls = calls_at([0.5, 0.5])
    calls[0].nbytes = calls[1].nbytes = 1 << 20
    run = Run(calls, 1.0, trace=trace.reduce(chrome_trace()))
    assert measure.span_ms_per_mib(run, "kanzi.frame") == pytest.approx(1e3 * 200e-6 / 2)
    assert measure.span_ms_per_mib(run, "nothing") is None
    run.trace = None
    assert measure.span_ms_per_mib(run, "kanzi.frame") is None


def test_card_time_is_the_union_of_device_intervals_over_all_bytes_returned():
    # a kernel 10-40 and a copy 30-50 on another stream: 40 us busy, once
    ev = window_events(("kernel", 10, 40), ("gpu_memcpy", 30, 50))
    calls = calls_at([0.5, 0.5])                      # 2 MB returned
    run = Run(calls, 1.0, trace=trace.reduce(ev))
    assert measure.card_ms_per_mb(run) == pytest.approx(1e3 * 40e-6 / 2)
    # a failed call returns nothing, and the card's time still counts
    calls[1].error, calls[1].nbytes = "boom", 0
    assert measure.card_ms_per_mb(run) == pytest.approx(1e3 * 40e-6)
    assert measure.card_ms_per_mb(Run(calls_at([1.0]), 1.0)) is None
    assert measure.card_ms_per_mb(Run(calls_at([1.0]), 1.0, trace=trace.reduce(
        window_events()))) is None


def test_device_ms_per_mb_reads_the_named_operations_or_nothing():
    ev = window_events(("kernel", 10, 40), ("gpu_memcpy", 50, 60), ("gpu_memcpy", 70, 75))
    run = Run(calls_at([1.0]), 1.0, trace=trace.reduce(ev))
    assert measure.device_ms_per_mb(run, "gpu_memcpy") == pytest.approx(1e3 * 15e-6)
    assert measure.device_ms_per_mb(run, "absent") is None
    assert measure.device_ms_per_mb(Run(calls_at([1.0]), 1.0), "gpu_memcpy") is None


def test_a_cell_with_a_device_trace_end_to_end_metric_is_profiled_untraced_too():
    from portbench import run as harness
    bench = {"end_to_end": [
        {"name": "rate", "source": "host_clock"},
        {"name": "card", "source": "device_trace", "workloads": ["b"]}]}
    assert not harness.profiled(bench, "a", False)
    assert harness.profiled(bench, "a", True)
    assert harness.profiled(bench, "b", False)
    real = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for cell in real["workloads"]:
        device = [m["name"] for m in harness.metrics_of(real, "end_to_end", cell["name"])
                  if m["source"] == "device_trace"]
        assert harness.profiled(real, cell["name"], False) == bool(device)


def test_the_window_must_be_in_the_trace():
    with pytest.raises(ValueError):
        trace.reduce([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}])


class FakeTrace:
    """A reduced trace whose device operations and spans match any needle."""

    def __init__(self, seconds):
        self.seconds = seconds
        self.spans = [("span", 1, 0.0, 0.25e6)]

    def device_seconds(self, *needles):
        return self.seconds

    def span_seconds(self, *needles):
        return sum(e - s for _, _, s, e in self.spans) / 1e6


@pytest.mark.parametrize("entropy", WORK)
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
    other = next(i for i in WORK + [0] if i != entropy)
    run.work = [[(other, 3 << 20, 4 << 20)]]
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
    work = [[(i, 3 << 20, 4 << 20) for i in WORK]]
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
