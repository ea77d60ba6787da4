"""Every mutation kind of kanzi_tpu_torch.robustness against kanzi_tpu, on
the CPU.

chip_smoke.py's robustness phase holds the card's outcome on these kinds
to the host C++ route's. Here each kind's mutants of small seeded streams
(two blocks of 4 KiB: the "cpu" route's plain range and ANS loops are
slow) decode through kanzi_tpu and through the port on its host route
(device=None) and its plain-version route (device="cpu"), at jobs 1 or 4
in turns: the same bytes, or a KanziError with the same code.
"""

import numpy as np
import pytest

import kanzi_tpu
from kanzi_tpu.core import KanziError as JaxKanziError
import kanzi_tpu_torch as kt
from kanzi_tpu_torch import native, robustness
from kanzi_tpu_torch.bench import synth_corpus
from torch_jax_native import jax_native  # noqa: F401  (builds kanzi_tpu's library once)

_DATA = synth_corpus(1 << 20, 21)[300000:300000 + (8 << 10)]


def _outcome(decode):
    try:
        return robustness.outcome(decode)
    except JaxKanziError as e:
        return "KanziError", e.code


@pytest.mark.parametrize("kind", robustness.KINDS)
def test_mutation_kind_outcomes_match(kind):
    rng = np.random.default_rng(robustness.KINDS.index(kind))
    done = 0
    for codec, kw in robustness.CODECS.items():
        for checksum in (32, 0):
            good = kanzi_tpu.compress(_DATA, block_size=4 << 10, checksum=checksum, **kw)
            bad = robustness.mutate(good, kind, codec, rng)
            if bad is None:
                continue
            done += 1
            jobs = 1 + 3 * (done & 1)
            want = _outcome(lambda: kanzi_tpu.decompress(bad, jobs=jobs))
            for route in (None, "cpu"):
                got = _outcome(lambda: kt.decompress(bad, jobs=jobs, device=route))
                assert got == want, (codec, checksum, jobs, route)
            if checksum and want[0] == "bytes":
                assert want == robustness.outcome(lambda: _DATA), (codec, "silent")
    assert done >= (4 if kind in ("logrange", "chunksize") else 8)


@pytest.mark.parametrize("codec", ["ANS0", "ANS1"])
def test_ans_hostile_state_matches_reference(codec):
    """An ANS chunk whose first state has bit 31 set (no encoder writes
    one): the host decoder's state is an int, so it shifts it down and
    compares it with ANS_TOP signed; the device route follows it, where
    kanzi_tpu's device op reads it as u32."""
    kw = robustness.CODECS[codec]
    good = kanzi_tpu.compress(_DATA, block_size=4 << 10, checksum=0, **kw)
    start = robustness._frames(good)[0][1]
    pre_len = robustness._read_bits(good, robustness._frames(good)[0][2], 16)
    at, width = robustness._chunk_size_field(good, start, codec, pre_len)
    for bit in (0, 1, 5):                     # bits 31, 30 and 26 of state 3
        bad = robustness._flip(good, at + width + 96 + bit, 1, 1)
        want = _outcome(lambda: kanzi_tpu.decompress(bad))
        for route in (None, "cpu"):
            for jobs in (1, 4):
                got = _outcome(lambda: kt.decompress(bad, jobs=jobs, device=route))
                assert got == want, (bit, route, jobs)


def test_inverse_room_is_the_native_paths():
    """The device path's inverse transforms take the native block
    decode's room (native.block_inverse), whatever earlier calls left in
    the native wrappers' pooled scratch. The seeded HUFFMAN mutant here
    (64 KiB blocks, checksum 32) has an LZ inverse that overruns that
    room: the host rejects it (ERR_PROCESS_BLOCK); a room taken from a
    large pool decoded it and failed its checksum instead."""
    native._get_scratch("ti", 64 << 20)      # as a process that decoded 4 MiB blocks
    bad = next(c for k, c in enumerate(robustness.streams(404, big=16)) if k == 336)[5]
    want = _outcome(lambda: kanzi_tpu.decompress(bad))
    assert want == ("KanziError", 13)
    for jobs in (1, 4):
        for route in (None, "cpu"):
            assert _outcome(lambda: kt.decompress(bad, jobs=jobs, device=route)) == want
