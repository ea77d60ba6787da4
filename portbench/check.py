"""What decides `correct`: the window's answers and the program's streams,
held to the originals and to the plain reference decoder.

- failed_calls: calls of the window that raised (limit 0).
- wrong_outputs: calls whose bytes differ from the object they decode,
  compared once the window has closed (limit 0).
- reference_blocks_wrong: blocks of the streams that set-up wrote, drawn
  from the seed with the longest block in the sample, that the plain
  reference decoder (reference/) decodes to other bytes than the
  original, or whose stored XXHash32 is not the original's (limit 0).
- corrupt_accepted: a copy of one stream, drawn from the seed, with one bit
  of one block's stored checksum flipped, decoded through the window's own
  call: 0 where the call rejects it with kanzi's checksum error (19), else 1
  (limit 0). The configurations state that a checksum is kept and
  verified for every block, so a decoder that returns such a block's bytes
  breaks their guarantee, though every answer of the window may be right.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from . import reference


@dataclass
class Check:
    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def sample_rng(seed: int, salt: int) -> np.random.Generator:
    s = seed % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, salt])


def layouts(streams: list) -> list:
    """Each stream's header, frames and block heads (reference/)."""
    out = []
    for stream in streams:
        header, frames = reference.parse(stream)
        out.append((header, frames,
                    [reference.block_head(stream, header, f) for f in frames]))
    return out


def work(layout) -> list:
    """[(entropy id, entropy payload bytes, entropy output bytes)] a block."""
    header, frames, heads = layout
    return [(h.entropy, (f.pos + f.nbits - h.payload_pos + 7) >> 3, h.length)
            for f, h in zip(frames, heads)]


def reference_blocks_wrong(objects, streams, lays, block_size, seed, count) -> int:
    blocks = [(i, j) for i, (_, frames, _) in enumerate(lays) for j in range(len(frames))]
    longest = max(blocks, key=lambda b: lays[b[0]][1][b[1]].nbits)
    rest = [b for b in blocks if b != longest]
    picked = [rest[k] for k in sample_rng(seed, 0x52454646).permutation(len(rest))[:count - 1]]
    wrong = 0
    for i, j in [longest] + picked:
        header, frames, _ = lays[i]
        original = objects[i][j * block_size:(j + 1) * block_size]
        try:
            data, stored = reference.decode_block(streams[i], header, frames[j])
        except reference.FormatError as e:
            print(f"reference: object {i} block {j}: {e}", file=sys.stderr)
            wrong += 1
            continue
        if data != original or stored != reference.xxhash32(original):
            print(f"reference: object {i} block {j} differs", file=sys.stderr)
            wrong += 1
    return wrong


def corrupt_accepted(streams, lays, decode, jobs, seed) -> int:
    rng = sample_rng(seed, 0x43524354)
    i = int(rng.integers(0, len(streams)))
    header, frames, heads = lays[i]
    j = int(rng.integers(0, min(jobs, len(frames))))
    pos = heads[j].checksum_pos
    bad = bytearray(streams[i])
    bad[pos >> 3] ^= 0x80 >> (pos & 7)
    try:
        decode(bytes(bad))
    except Exception as e:  # the decoder's rejection is the answer judged
        if getattr(e, "code", None) == reference.ERR_CRC_CHECK:
            return 0
        print(f"corrupt checksum: object {i} block {j} raised {e!r}, "
              f"not the checksum error", file=sys.stderr)
        return 1
    print(f"corrupt checksum: object {i} block {j} was accepted", file=sys.stderr)
    return 1


def judge(run, outputs, objects, streams, lays, decode, config, seed, checked) -> list:
    """The checks of one run, each beside its limit."""
    wrong = 0
    for call, out in zip(run.calls, outputs):
        if call.error is None and out != objects[call.obj]:
            wrong += 1
    return [
        Check("failed_calls", sum(c.error is not None for c in run.calls), 0),
        Check("wrong_outputs", wrong, 0),
        Check("reference_blocks_wrong",
              reference_blocks_wrong(objects, streams, lays, config["block_size"],
                                     seed, checked), 0),
        Check("corrupt_accepted",
              corrupt_accepted(streams, lays, decode, config["jobs"], seed), 0),
    ]
