#!/usr/bin/env python3
"""The control of `correct`: a run of a cell with one guarantee broken.

    python3 portbench/control.py --workload range.archive --seed 7 --seconds 20

The configurations state that every block's XXHash32 is stored and
verified. The control removes the verification from the program's Reader
(`kio.compressed_stream._verify_checksum` returns the block unchecked) and
runs the cell as run.py does, with `--trace 0`. Every answer of the window
is still right; `correct` must come out false all the same, by the
`corrupt_accepted` check. The benchmark's own runs never run this.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run as harness  # noqa: E402


def main(argv=None) -> int:
    args = harness.parse_args(list(argv if argv is not None else sys.argv[1:]) + ["--trace", "0"])
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return harness.NO_CARD
    with unchecked_blocks():
        result, checks = harness.run_cell(bench, args.workload, args.seed, args.seconds, False)
    harness.report(result, checks)
    return 0


class unchecked_blocks:
    """Within it, the program's Reader returns blocks without verifying
    their checksums."""

    def __enter__(self):
        from kanzi_tpu_torch.kio import compressed_stream as cs
        self._cs, self._saved = cs, cs._verify_checksum
        cs._verify_checksum = lambda result, checksum_bits, checksum1: result
        return self

    def __exit__(self, *exc):
        self._cs._verify_checksum = self._saved
        return False


if __name__ == "__main__":
    sys.exit(main())
