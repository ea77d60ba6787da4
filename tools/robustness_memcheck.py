#!/usr/bin/env python3
"""Hostile decodes for a memory checker: a few dozen of chip_smoke.py's
robustness streams on the card, and good round trips of each device codec.

    python3 -c "from kanzi_tpu_torch import _kernels; _kernels.build()"
    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python3 tools/robustness_memcheck.py [--streams 48]

The kernels are built first, outside the checker (nvcc is a process of its
own). The mutants (kanzi_tpu_torch.robustness.streams, 64 KiB blocks) feed
hostile payloads to K4 (decode_lanes), K6 (ans_decode) and K8
(range_decode); the round trips run K3, K5 and K7 on good blocks and the
decode kernels on their streams. Each device outcome must equal the host
C++ route's. Prints the counts and the launches as one JSON line; exits
non-zero on a disagreement, a fault, or a kernel that did not launch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=48)
    args = ap.parse_args(argv)

    import torch

    import kanzi_tpu_torch as kt
    from kanzi_tpu_torch import _kernels as K, robustness
    from kanzi_tpu_torch.bench import synth_corpus

    if not torch.cuda.is_available():
        print("robustness_memcheck: no CUDA device", file=sys.stderr)
        return 2
    K.reset_counts()
    res = robustness.check(list(robustness.streams(args.streams)),
                           lambda b, j: kt.decompress(b, jobs=j, device="cuda"),
                           lambda b, j: kt.decompress(b, jobs=j, device=None), jobs=(1, 4))
    hostile = dict(K.launches)
    data = synth_corpus(1 << 20, 7)[:512 << 10]
    K.reset_counts()
    for codec, kw in robustness.CODECS.items():
        blob = kt.compress(data, block_size=128 << 10, checksum=32, jobs=4,
                           device="cuda", **kw)
        if kt.decompress(blob, jobs=4, device="cuda") != data:
            print(f"robustness_memcheck: {codec} round trip failed", file=sys.stderr)
            return 1
    torch.cuda.synchronize()
    good = dict(K.launches)
    print(json.dumps({"streams": res["streams"], "exact": res["exact"],
                      "rejected": {str(k): v for k, v in res["rejected"].items()},
                      "other_bytes": res["other_bytes"], "disagree": res["disagree"],
                      "hostile_launches": hostile, "good_launches": good,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    missing = [k for k, n in (("decode_lanes", hostile["decode_lanes"]),
                              ("ans_decode", hostile["ans_decode"]),
                              ("range_decode", hostile["range_decode"]),
                              ("pack_lanes", good["pack_lanes"]),
                              ("ans_encode", good["ans_encode"]),
                              ("range_encode", good["range_encode"])) if n == 0]
    if res["disagree"] or missing:
        print(f"robustness_memcheck: disagreements {res['disagree']}, not launched "
              f"{missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
