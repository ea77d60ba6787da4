"""Peaks of one H100 and the least time of the decode kernels' work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s
of HBM3, and 67 TOP/s outside the tensor cores, taken for the integer work
here. The least time of some work is the larger of its bytes over the first
and its operations over the second.

A decode kernel's work is counted from the stream it decodes, as the
algorithm needs it: each entropy payload byte read once, each decoded byte
written once, each chunk's frequency table read once (what a launch's row
needs to rebuild its slot table), and a fixed number of integer operations
a decoded byte:

- range (K8, RangeCodec.go): 32 KiB chunks; a chunk's table is its
  (cumFreq, freq) planes of 256 u32 each; a byte is a shift, a subtract, a
  divide, a slot lookup, a multiply-add, a subtract and a multiply, and the
  renormalisation test (xor, add, and, compare): 10 operations.
- ANS order 1 (K6, ANSRangeCodec.go): 4 MiB chunks; a chunk's table is
  256 contexts of 256 (cumFreq, freq) u32 pairs; a byte is a mask, a slot
  lookup, a shift, a multiply-add, a subtract and the renormalisation
  compare: 6 operations.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

CODECS = {
    # entropy id: (chunk bytes, table bytes a chunk, operations a decoded byte)
    4: (1 << 15, 2 * 256 * 4, 10),          # RANGE
    8: (16384 << 8, 256 * 256 * 2 * 4, 6),   # ANS1
}


def least_seconds(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time of the work, and which of the two peaks bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = nops / PEAK_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_work(entropy: int, payload_bytes: int, out_bytes: int) -> tuple[int, int]:
    """(bytes, operations) the decode of one block's entropy payload needs."""
    chunk, table, ops = CODECS[entropy]
    chunks = -(-out_bytes // chunk)
    return payload_bytes + out_bytes + chunks * table, ops * out_bytes


def roofline_percent(run, entropy: int, needles: tuple) -> float | None:
    """A decode kernel's share of its roofline over a traced window, in %:
    the least time of the entropy payloads of type `entropy` that the
    window's calls decoded (bytes and operations summed over the window)
    over the device time of the operations named by `needles`. None where
    the trace shows no such operation."""
    if run.trace is None:
        return None
    device_s = run.trace.device_seconds(*needles)
    if device_s <= 0:
        return None
    nbytes = nops = 0
    for call in run.calls:
        if call.error is not None:
            continue
        for ent, payload, out in run.work[call.obj]:
            if ent == entropy:
                b, o = decode_work(ent, payload, out)
                nbytes += b
                nops += o
    return 100.0 * least_seconds(nbytes, nops)[0] / device_s
