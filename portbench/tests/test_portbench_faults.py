"""`correct` comes out false when the timed path is broken underneath.

Each test drives a whole run of a cell (set-up, window, checks), without
the harness's look for a card, at a size a test run holds: the cell's
configuration with 4 KiB blocks, on the Reader's batched device path run
by the kernels' plain versions (device="cpu"). One fault is planted at a
time: the control (the checksum verification removed, or the plain
reference decoder put in the program's place without it), an answer
altered where it is produced, half of a batch left out, and an entropy
stage that hands back its input unchanged. A cell on one card has no
exchange between cards to leave out. The last test runs the same on the
card (marked gpu).
"""

import contextlib

import numpy as np
import pytest

from portbench import control, reference, run, traffic

import kanzi_tpu_torch as kt
from kanzi_tpu_torch import entropy as program_entropy
from kanzi_tpu_torch.kio import compressed_stream

BLOCK = 4096
# the archive's mix and a mix of several one-block objects, both under
# the range cell's configuration
MIXES = {"archive": traffic.Mix(3 * BLOCK + 100, [[3 * BLOCK + 100, 1]], checked_blocks=2),
         "objects": traffic.Mix(64 << 10, [[1000, 1], [2000, 1], [3000, 1]],
                                checked_blocks=2)}


def one_run(mix, device="cpu", seed=2 ** 31 + 7, workload="range.archive"):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    cell = run.cell_of(bench, workload)
    config = dict(run.load_json(run.HERE, "configs", f"{cell['config']}.json"),
                  block_size=BLOCK)
    result, checks = run.run_cell(bench, workload, seed, 0.01, False, device=device,
                                  mix=MIXES[mix], config=config)
    return result, {c.name: c.value for c in checks}


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_sound_run_is_correct(mix):
    result, checks = one_run(mix)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_an_untraced_run_of_a_cell_with_a_card_metric_runs_under_the_profiler():
    # ans1.archive reports card_ms_per_MB, read from the device trace, so its
    # --trace 0 window is profiled; on the CPU the trace holds no device time
    # and the metric is left out, and the run stays untraced in what it prints
    seen = []
    with patched(run.tracing, "reduce", lambda ev, _r=run.tracing.reduce: seen.append(1)
                 or _r(ev)):
        result, checks = one_run("archive", workload="ans1.archive")
    assert result["correct"], checks
    assert seen == [1]
    assert "card_ms_per_MB" not in result["metrics"] and "setup_s" in result["metrics"]
    assert "breakdown" not in result and "busy_s" not in result["device"]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_control_checksum_unverified(mix):
    with control.unchecked_blocks():
        result, checks = one_run(mix)
    assert not result["correct"]
    assert checks["corrupt_accepted"] == 1 and checks["wrong_outputs"] == 0


def reference_decompress(data, jobs=1, headerless=False, ctx=None, device=None):
    header, frames = reference.parse(data)
    return b"".join(reference.decode_block(data, header, f)[0] for f in frames)


def test_control_reference_in_the_programs_place():
    with patched(kt, "decompress", reference_decompress):
        result, checks = one_run("archive")
    assert not result["correct"]
    assert checks["corrupt_accepted"] == 1 and checks["wrong_outputs"] == 0


def after_warm_up(fault, sound):
    """`fault` in place of `sound` from its second call on: set-up's one
    warm-up decode runs sound, the window's calls run the fault."""
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(1)
        return (sound if len(calls) == 1 else fault)(*args, **kwargs)
    return wrapped


def test_an_answer_altered_where_the_card_produces_it():
    sound = program_entropy.decode_many

    def altered(*args, **kwargs):
        outs = sound(*args, **kwargs)
        first = np.array(outs[0], copy=True)
        first[len(first) // 2] ^= 1
        return [first] + list(outs[1:])
    with patched(program_entropy, "decode_many", after_warm_up(altered, sound)):
        result, checks = one_run("archive")
    assert not result["correct"] and checks["failed_calls"] >= 1


def test_an_answer_altered_where_the_call_returns_it():
    original = kt.decompress

    def altered(*args, **kwargs):
        out = bytearray(original(*args, **kwargs))
        out[-1] ^= 1
        return bytes(out)
    with patched(kt, "decompress", altered):
        result, checks = one_run("objects")
    assert not result["correct"] and checks["wrong_outputs"] >= 1


def test_half_of_a_batch_left_out():
    decode_frames = compressed_stream.Reader._decode_frames

    def half(self, frames, payloads, listeners):
        outs = decode_frames(self, frames, payloads, listeners)
        return outs[:(len(outs) + 1) // 2]
    with patched(compressed_stream.Reader, "_decode_frames", half):
        result, checks = one_run("archive")
    assert not result["correct"] and checks["wrong_outputs"] >= 1


def test_an_entropy_stage_that_returns_its_input_unchanged():
    def unchanged(entropy_type, payloads, out_lens, ctx, run_, nbits=None):
        return [np.frombuffer(bytes(p[:n]).ljust(n, b"\0"), np.uint8)
                for p, n in zip(payloads, out_lens)]
    with patched(program_entropy, "decode_many",
                 after_warm_up(unchanged, program_entropy.decode_many)):
        result, checks = one_run("archive")
    assert not result["correct"] and checks["failed_calls"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_on_the_card_sound_and_control(mix):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = one_run(mix, device="cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
    with control.unchecked_blocks():
        result, checks = one_run(mix, device="cuda")
    assert not result["correct"] and checks["corrupt_accepted"] == 1
