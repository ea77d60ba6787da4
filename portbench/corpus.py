"""The mixed corpus the traffic is cut from, frozen with the benchmark.

A copy of the port's `bench.synth_corpus`: 45 % perturbed copies of a
49,567-byte English technical text, 20 % int32 deltas, 10 % DNA, 10 %
sparse zeros and 15 % random bytes, shuffled in 1 MiB strides. One change:
the order of the strides is drawn from a seed of its own, which the
traffic fixes, so that a run's seed changes the bytes and not the kinds of
data in each block. The text is kept here (`data/survey_text.gz`,
checked against its SHA-256 when read), so that no later edit elsewhere in
the repository changes the corpus.
"""

from __future__ import annotations

import gzip
import hashlib
import os

import numpy as np

MIB = 1 << 20
TEXT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "survey_text.gz")
TEXT_BYTES = 49_567
TEXT_SHA256 = "36b25a34634425c2e578e9a3e56f7ec689433ef813da2c54547bacc9c1642baa"


def text() -> bytes:
    with open(TEXT_PATH, "rb") as fh:
        raw = gzip.decompress(fh.read())
    if len(raw) != TEXT_BYTES or hashlib.sha256(raw).hexdigest() != TEXT_SHA256:
        raise ValueError(f"{TEXT_PATH} is not the corpus's text")
    return raw


def synth_corpus(size: int, seed: int, layout_seed: int) -> bytes:
    """`size` bytes of the mixed corpus, its bytes drawn from `seed` and the
    order of its 1 MiB strides from `layout_seed` (any integers that
    numpy's default_rng takes). With one `layout_seed`, every seed puts
    strides of the same kinds in the same places."""
    rng = np.random.default_rng(seed)
    src = np.frombuffer(text(), dtype=np.uint8)
    tpart = []
    tlen = 0
    while tlen < int(size * 0.45):
        arr = src.copy()
        idx = rng.integers(0, len(arr), len(arr) // 64)
        arr[idx] = rng.integers(32, 127, len(idx), dtype=np.uint8)
        tpart.append(arr.tobytes())
        tlen += len(arr)
    parts = [b"".join(tpart)]
    n = int(size * 0.20) // 4
    parts.append(np.cumsum(rng.integers(-3, 4, n, dtype=np.int32)).astype("<i4").tobytes())
    parts.append(np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, int(size * 0.10))].tobytes())
    z = np.zeros(int(size * 0.10), dtype=np.uint8)
    idx = rng.integers(0, len(z), len(z) // 50)
    z[idx] = rng.integers(1, 256, len(idx), dtype=np.uint8)
    parts.append(z.tobytes())
    parts.append(rng.integers(0, 256, int(size * 0.15), dtype=np.uint8).tobytes())
    arr = np.frombuffer(b"".join(parts)[:size], dtype=np.uint8)
    m = (len(arr) >> 20) << 20
    strided = arr[:m].reshape(-1, MIB)
    order = np.random.default_rng(layout_seed).permutation(len(strided))
    return strided[order].tobytes() + arr[m:].tobytes()
