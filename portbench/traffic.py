"""The one traffic generator: a mix's parameters in, its objects and calls out.

A mix (`traffic/<name>.json`) names the operation that the window drives
(`operations/<name>.py`), a corpus size, the objects' sizes as a histogram
of [bytes, count] pairs, and how many blocks of their streams the plain
reference decodes after a run. A key it does not know is an error. The
sizes are fixed by the mix, and so are the kinds of data in each 1 MiB of
the corpus and each object's offset in it; the seed draws the corpus's
bytes and the order of the calls within each round of them (call_order).
The operation's one closed-loop client then calls it on the objects in
that order, cycling, each call waiting for the one before. An archive is a
mix of one object, the whole corpus; a store of many objects is a mix of
many.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np

from . import corpus

HERE = os.path.dirname(os.path.abspath(__file__))
LAYOUT = 0x4B414E5A          # the seed of the corpus's layout and the objects' offsets


@dataclass
class Mix:
    corpus_bytes: int
    sizes_hist: list            # [[object bytes, count], ...], in object order
    checked_blocks: int         # blocks the plain reference decodes after a run
    operation: str = "decompress"

    def sizes(self) -> list[int]:
        return [int(size) for size, n in self.sizes_hist for _ in range(n)]

    @property
    def count(self) -> int:
        return sum(n for _, n in self.sizes_hist)


KEYS = {"why": None, "operation": "operation", "corpus_bytes": "corpus_bytes",
        "sizes": "sizes_hist", "checked_blocks": "checked_blocks"}


def load(name: str) -> Mix:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        spec = json.load(fh)
    unknown = sorted(set(spec) - set(KEYS))
    if unknown:
        raise ValueError(f"traffic {name}: unknown keys {unknown}")
    mix = Mix(**{KEYS[k]: v for k, v in spec.items() if KEYS[k]})
    if mix.count < 1 or not all(1 <= s <= mix.corpus_bytes and n >= 1
                                for s, n in mix.sizes_hist):
        raise ValueError(f"traffic {name}: sizes out of order")
    return mix


@dataclass
class Traffic:
    objects: list[bytes]     # the originals, in object order
    order: np.ndarray        # object indices, one cycle of calls (call_order)


def generate(mix: Mix, seed: int) -> Traffic:
    """The objects and the call order of `mix` for `seed`. The layout is
    the same for every seed: the kinds of data stride by stride in the
    corpus, and each object's size and offset. The seed draws the bytes
    and the order of the calls, so every seed asks for the same work in
    another order."""
    s = seed % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, 0x54524146])
    data = corpus.synth_corpus(mix.corpus_bytes, int(rng.integers(0, 2 ** 63)), LAYOUT)
    view = memoryview(data)
    layout = np.random.default_rng(LAYOUT)
    objects = []
    for size in mix.sizes():
        off = int(layout.integers(0, mix.corpus_bytes - size + 1))
        objects.append(data if size == len(data) else bytes(view[off:off + size]))
    return Traffic(objects, call_order(mix.count, rng))


def call_order(count: int, rng: np.random.Generator) -> np.ndarray:
    """One cycle of calls in rounds: object i is in round i % R, with R
    about the square root of `count`, so that each round holds objects
    from across the sizes; the rounds come in a fixed order and the seed
    orders the calls within each. Any window of whole rounds then asks for
    the same objects whatever the seed."""
    rounds = max(1, math.isqrt(count))
    return np.concatenate([rng.permutation(np.arange(r, count, rounds))
                           for r in range(rounds)])
