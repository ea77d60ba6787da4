"""The port's bench: kanzi_tpu_torch on one CUDA card beside its host C++ path.

    python3 -m kanzi_tpu_torch.bench [--codecs] [--size 64m] [--runs 7]
                                     [--levels 0,1,...,9,ANS1,RANGE] [--jobs 4]

The counterpart of kanzi_tpu's bench.py, on the same seeded corpora. The
last line on stdout is one JSON object (its first keys are bench.py's
headline: level 1 encode); progress goes to stderr. Its sections:

- levels: compress/decompress of levels 0-9, 4 MiB blocks, checksum=32,
  `--jobs` threads, each stream decoded with the `jobs` it was encoded
  with. Level 1 runs on the corpus (64 MiB), levels 0 and 2-7 on its first
  16 MiB, levels 8-9 on its first 4 MiB and, as levels_hard, on a 4 MiB
  corpus of silesia-like difficulty; ANS1 (transform NONE) and RANGE
  (transform LZ) on 16 MiB. Each row runs device="cuda" (the default users
  get) and device=None (the host C++ path) in turns, round-robin across
  rows, after one warm-up a row and path: MB/s each way as median,
  quartiles, min and max of `--runs` samples, and the device/host ratio of
  medians. Every round trip must be exact and every device stream equal to
  the host stream; the rows whose device path launches a kernel (2, 3, 5,
  ANS1, RANGE) are marked and checked.
- codecs (with --codecs): every entropy codec and transform of the
  registry standalone on the host C++ engine; HUFFMAN, ANS0, ANS1 and
  RANGE also through their device engines, as the Writer and Reader call
  them.
- device_kernels and batch_curve: bench.py's device rows on the port's
  wrappers with device-resident inputs (K3 on 512 lanes, K5 and K6 on 128
  chunks of 16 KiB, block_stats on (16, 1 MiB); K3, K5 and K6 at 1, 16,
  64 and 256 blocks of 256 KiB), and with readback (a host clock around
  the call and its .cpu()).
- kernels: every kernel of _kernels.KERNELS at the main path's shapes
  (those of chip_smoke.py) beside its bound and launches.

A kernel's time is taken with CUDA events around each call ("ms", its
wrapper's host work included) and, for a call under 1 ms, also over calls
run back to back behind a spin kernel ("device_ms": the device's time).

Without a card every device row reads "unavailable" and the host rows are
measured. Nothing else is caught: a failing device call raises and the
bench exits non-zero. No plain version may run (checked at the end). The
launch counters are the bench's own while it runs and are restored after.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import _kernels as K
from . import entropy as E
from . import native
from . import transforms as T

MIB = 1 << 20
BLOCK = 4 * MIB
SEED = 0x4B414E5A          # synth_corpus's, as in kanzi_tpu's bench.py
HARD_SEED = 0x51E51A       # synth_hard_corpus's
LEVEL5_CHAIN = "TEXT+UTF+BWT+RANK+ZRLT"
ROWS = tuple(str(lv) for lv in range(10)) + ("ANS1", "RANGE")
KERNEL_ROWS = ("2", "3", "5", "ANS1", "RANGE")   # the device path launches a kernel
CURVE_BLOCKS = (1, 16, 64, 256)
CURVE_BLOCK = 256 << 10
ANS_CHUNK = 16384
UNAVAILABLE = "unavailable"

# the reference's published level 1 encode on its 16-core desktop
# (kanzi-go README: 211,957,760 bytes of silesia.tar in 173 ms), and its
# ms per level (encode, decode) on that file
BASELINE_L1_ENCODE_GBPS = 211_957_760 / 0.173 / 1e9
REFERENCE_CORES = 16
REF_MS = {1: (173, 75), 2: (137, 88), 3: (230, 112), 4: (448, 185),
          5: (940, 398), 6: (1255, 973), 7: (1714, 1227),
          8: (8362, 7943), 9: (17944, 17512)}
REF_BYTES = 211_957_760

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and
# the non-tensor-core rate, taken for the integer and float32 work here
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

KERNEL_SOURCES = {
    "block_stats": ("block_stats.cu", "kanzi_tpu/ops/pallas_kernels.py:100"),
    "histograms_u8": ("block_stats.cu", "kanzi_tpu/ops/pallas_kernels.py:27"),
    "entropy1024": ("block_stats.cu", "kanzi_tpu/ops/pallas_kernels.py:67"),
    "pack_lanes": ("huffman.cu", "kanzi_tpu/ops/huffman.py:29"),
    "decode_lanes": ("huffman.cu", "kanzi_tpu/ops/huffman.py:86"),
    "ans_encode": ("ans.cu", "kanzi_tpu/ops/ans.py:54"),
    "ans_decode": ("ans.cu", "kanzi_tpu/ops/ans.py:114"),
    "range_encode": ("range.cu", "kanzi_tpu/ops/range.py:109"),
    "range_decode": ("range.cu", "kanzi_tpu/ops/range.py:186"),
    "prefix_double": ("suffix_sort.cu", "kanzi_tpu/ops/suffix_sort.py:40"),
    "lf_walk": ("bwt_inverse.cu", "kanzi_tpu/ops/bwt_inverse.py:48"),
    "fpaq_encode": ("fpaq_batch.cu", "kanzi_tpu/ops/fpaq_batch.py:82"),
}
# wrappers that read a result back before they return (K9 its rounds, K10
# its index flags): no back-to-back device time for them
WAITING_WRAPPERS = ("prefix_double", "lf_walk")
DEVICE_CODECS = ("HUFFMAN", "ANS0", "ANS1", "RANGE")
ENTROPY_CODECS = ("NONE", "HUFFMAN", "ANS0", "ANS1", "RANGE", "FPAQ", "CM", "TPAQ",
                  "TPAQX")
TRANSFORMS = ("BWT", "BWTS", "LZ", "LZX", "LZP", "ROLZ", "ROLZX", "RLT", "ZRLT", "MTFT",
              "RANK", "SRT", "TEXT", "UTF", "PACK", "DNA", "MM", "EXE")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench: {msg}")


# -- corpora (byte-for-byte copies of kanzi_tpu's bench.py) -----------------

def _survey_text() -> bytes:
    """SURVEY.md beside the package: the text of synth_corpus. There is no
    other text: a missing file raises, since any other would change the
    corpus."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "SURVEY.md")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"synth_corpus needs {path}: its text is the corpus's")
    with open(path, "rb") as fh:
        return fh.read()


def synth_corpus(size: int = 64 * MIB, seed: int = SEED) -> bytes:
    """Deterministic mixed corpus (text/binary/dna/zeros/random), silesia-like:
    45 % perturbed copies of SURVEY.md, 20 % int32 deltas, 10 % DNA, 10 %
    sparse zeros, 15 % random, shuffled in 1 MiB strides."""
    rng = np.random.default_rng(seed)
    text = _survey_text()
    parts = []
    tpart = []
    while sum(map(len, tpart)) < int(size * 0.45):
        arr = np.frombuffer(text, dtype=np.uint8).copy()
        idx = rng.integers(0, len(arr), len(arr) // 64)
        arr[idx] = rng.integers(32, 127, len(idx), dtype=np.uint8)
        tpart.append(arr.tobytes())
    parts.append(b"".join(tpart))
    n = int(size * 0.20) // 4
    vals = np.cumsum(rng.integers(-3, 4, n, dtype=np.int32)).astype("<i4")
    parts.append(vals.tobytes())
    dna = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, int(size * 0.10))]
    parts.append(dna.tobytes())
    z = np.zeros(int(size * 0.10), dtype=np.uint8)
    idx = rng.integers(0, len(z), len(z) // 50)
    z[idx] = rng.integers(1, 256, len(idx), dtype=np.uint8)
    parts.append(z.tobytes())
    parts.append(rng.integers(0, 256, int(size * 0.15), dtype=np.uint8).tobytes())
    blob = b"".join(parts)[:size]
    arr = np.frombuffer(blob, dtype=np.uint8)
    m = (len(arr) >> 20) << 20
    strided = arr[:m].reshape(-1, MIB)
    order = rng.permutation(len(strided))
    return strided[order].tobytes() + arr[m:].tobytes()


def synth_hard_corpus(size: int = BLOCK) -> bytes:
    """Deterministic corpus of silesia-like difficulty for levels 8-9: 45 %
    Zipf-sampled pseudo-English, 18 % structured log lines, 14 % x86-like
    code from a bank of templates, 18 % float32 telemetry, 5 % random."""
    rng = np.random.default_rng(HARD_SEED)
    parts = []
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    lfreq = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                      4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5,
                      1.0, 0.15, 0.15, 0.1, 0.1, 0.07])
    lfreq /= lfreq.sum()
    nvocab = 8192
    wlens = np.clip(rng.poisson(5.5, nvocab), 2, 14)
    vocab = [bytes(rng.choice(letters, ln, p=lfreq)) for ln in wlens]
    ranks = np.arange(1, nvocab + 1, dtype=np.float64)
    zipf = 1.0 / ranks
    zipf /= zipf.sum()
    n_text = int(size * 0.45)
    words = rng.choice(nvocab, n_text // 6, p=zipf)
    buf = bytearray()
    sent = 0
    for w in words:
        tok = vocab[w]
        if sent == 0:
            tok = tok[:1].upper() + tok[1:]
        buf += tok
        sent += 1
        if sent >= 8 and rng.random() < 0.18:
            buf += b". " if rng.random() < 0.85 else b".\n"
            sent = 0
        else:
            buf += b" "
        if len(buf) >= n_text:
            break
    parts.append(bytes(buf[:n_text]))
    n_log = int(size * 0.18)
    hosts = [b"api-%02d" % i for i in range(12)]
    levels_ = [b"INFO", b"WARN", b"DEBUG", b"ERROR"]
    msgs = [b"request handled", b"cache miss", b"retrying upstream",
            b"connection reset", b"slow query", b"gc pause"]
    lg = bytearray()
    ts = 1700000000_000
    while len(lg) < n_log:
        ts += int(rng.integers(1, 900))
        lg += b"%d %s %s %s latency_us=%d size=%d\n" % (
            ts, hosts[int(rng.integers(0, 12))],
            levels_[int(rng.choice(4, p=[0.7, 0.15, 0.1, 0.05]))],
            msgs[int(rng.integers(0, 6))],
            int(rng.integers(40, 9000)), int(rng.integers(0, 4096)))
    parts.append(bytes(lg[:n_log]))
    n_exe = int(size * 0.14)
    templates = []
    for _ in range(48):
        body = bytearray(b"\x55\x48\x89\xe5")  # push rbp; mov rbp,rsp
        for _i in range(int(rng.integers(6, 24))):
            kind = rng.integers(0, 5)
            if kind == 0:    # mov reg, [rbp-disp8]
                body += bytes([0x48, 0x8b, 0x45 + int(rng.integers(0, 3)) * 8,
                               0x100 - 8 * int(rng.integers(1, 16)) & 0xFF])
            elif kind == 1:  # call rel32 (patched per instance)
                body += b"\xe8\x00\x00\x00\x00"
            elif kind == 2:  # cmp eax, imm8; jne rel8
                body += bytes([0x83, 0xf8, int(rng.integers(0, 16)),
                               0x75, int(rng.integers(2, 64))])
            elif kind == 3:  # add rax, imm32 (small)
                body += b"\x48\x05" + int(rng.integers(0, 4096)).to_bytes(4, "little")
            else:            # mov [rbp-disp8], reg
                body += bytes([0x48, 0x89, 0x45 + int(rng.integers(0, 3)) * 8,
                               0x100 - 8 * int(rng.integers(1, 16)) & 0xFF])
        body += b"\x5d\xc3"  # pop rbp; ret
        templates.append(bytes(body))
    ops = bytearray()
    while len(ops) < n_exe:
        t = bytearray(templates[int(rng.integers(0, 48))])
        for i in range(len(t) - 4):
            if t[i] == 0xE8 and t[i + 1:i + 5] == b"\x00\x00\x00\x00":
                t[i + 1:i + 5] = int(rng.integers(-(1 << 16), 1 << 16)
                                     ).to_bytes(4, "little", signed=True)
        ops += t
    parts.append(bytes(ops[:n_exe]))
    n_f = int(size * 0.18) // 4
    tgrid = np.arange(n_f, dtype=np.float64)
    sig = np.sin(tgrid / 97.0) * 1000 + np.sin(tgrid / 7.3) * 40
    noise = rng.normal(0, 1.0, n_f) * (rng.random(n_f) < 0.15)
    sig = (np.round((sig + noise) * 10) / 10).astype("<f4")
    parts.append(sig.tobytes())
    parts.append(rng.integers(0, 256, int(size * 0.05), dtype=np.uint8).tobytes())
    return b"".join(parts)[:size]


# -- measurement --------------------------------------------------------------

def spread(samples) -> dict:
    """Median, quartiles, min and max of samples, and their count."""
    a = np.asarray(samples, dtype=np.float64)
    q1, med, q3 = np.percentile(a, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "min": float(a.min()), "max": float(a.max()), "n": len(a)}


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    """The least time in ms for the work: bytes moved at the card's memory
    rate against operations at its peak rate; which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prefix_double_bound(size: int, rounds: int) -> tuple[float, str]:
    """K9's least time: the padded input read and the order written once;
    per round a key and a relabel of a few operations and the n log2 n
    comparisons that a sort of size keys needs."""
    return bound(8 * size, rounds * size * (size.bit_length() - 1 + 7))


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def event_ms(fn, reps: int, warmup: int = 1) -> list:
    """Per-call device times in ms from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def device_ms(fn, reps: int = 20, samples: int = 5) -> list:
    """Device time of one call, `samples` times: `reps` calls enqueued
    behind a spin kernel (torch.cuda._sleep, about 50 ms), so that they run
    back to back on the device whatever the host's time a call, between
    two CUDA events. Raises if the spin ended before the host had enqueued
    them all (a call that synchronises, or a host slower than the spin)."""
    out = []
    for _ in range(samples):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1e8))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        check(not a.query(), "device_ms: the host fell behind the spin kernel")
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def timed_kernel(fn, back_to_back: bool = True, budget_ms: float = 1000.0) -> dict:
    """A warm-up call, then as many calls as fit `budget_ms` (3 to 30),
    each timed by CUDA events ("ms": a call's time, its host work
    included); for a call under 1 ms, where the host's share sets the
    call's time, also its device time back to back ("device_ms"), unless
    the call waits for the device itself (`back_to_back` False).
    "launches" counts every launch made here."""
    before = dict(K.launches)
    first = event_ms(fn, 1, 0)[0]
    row = {"ms": spread(event_ms(fn, int(min(30, max(3, budget_ms // max(first, 1e-3)))),
                                 0))}
    if back_to_back and row["ms"]["median"] < 1.0:
        row["device_ms"] = spread(device_ms(fn))
    row["launches"] = {k: K.launches[k] - before[k] for k in K.KERNELS}
    return row


def readback_ms(fn, reps: int) -> list:
    """Host clock around one call and the .cpu() of its outputs."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for out in fn():
            out.cpu()
        times.append((time.perf_counter() - t) * 1e3)
    return times


@contextlib.contextmanager
def own_counts():
    """The launch and plain-version counters zeroed for the bench, and put
    back as they were after it, so that a caller's counts do not see the
    bench's launches."""
    saved = dict(K.launches), dict(K.plain_calls)
    K.reset_counts()
    try:
        yield
    finally:
        K.launches.update(saved[0])
        K.plain_calls.update(saved[1])


def device_available() -> bool:
    return torch.cuda.is_available()


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# -- inputs shared with chip_smoke.py -----------------------------------------

def transform_posts(blocks, chain: str, entropy: str) -> list:
    """The post-transform blocks that the Writer hands the entropy engine."""
    posts = []
    ctx = {"bsVersion": 6, "entropy": entropy, "blockSize": BLOCK}
    for b in blocks:
        dst = np.empty(2 * len(b) + 65536, np.uint8)
        n = native.block_transform(b, T.get_type(chain), E.get_type(entropy), dict(ctx),
                                   0, False, dst)[0]
        posts.append(dst[:n].copy())
    return posts


def reader_ans_batch(posts, order: int) -> dict:
    """The K6 rows of the blocks' host ANS payloads stacked as the batched
    Reader stacks them."""
    from .entropy import ans_device, device_io
    etype = 8 if order else 5
    return device_io.stack([ans_device.decode_batch(
        np.frombuffer(native.entropy_encode(etype, p, {"bsVersion": 6})[0], np.uint8),
        len(p), order)[0] for p in posts])


def period2_block(n: int) -> np.ndarray:
    """A block that repeats "ab": about log2(n) doubling rounds."""
    return np.tile(np.frombuffer(b"ab", np.uint8), n // 2)


def padded_block(block: np.ndarray, device) -> torch.Tensor:
    """The (size,) int32 input of prefix_double for one block."""
    from .ops.suffix_sort import _bucket
    padded = np.zeros(_bucket(len(block)), np.int32)
    padded[:len(block)] = block
    return torch.from_numpy(padded).to(device)


def textbook(blocks, device):
    """(texts, last columns, primary rows) of the textbook BWTs of the
    blocks with their zero bytes mapped to 1 and one 0 appended. The
    unique minimum makes the sorted rotations the sorted suffixes, so the
    suffix order of the mapped block (K9) gives both."""
    from .ops import suffix_sort as ops_ss
    texts, lasts, prims = [], [], []
    for b in blocks:
        t = np.concatenate([np.where(b == 0, 1, b), [0]]).astype(np.uint8)
        sa = np.concatenate([[len(t) - 1], ops_ss.suffix_array_device(t[:-1], device)])
        texts.append(t)
        lasts.append(t[(sa - 1) % len(t)])
        prims.append(int(np.nonzero(sa == 0)[0][0]))
    return np.stack(texts), np.stack(lasts), np.array(prims, np.int32)


# -- bench.py's device rows: inputs as numpy arrays named for to_port_state ----

def pack_inputs(lanes: int, seed: int = 1) -> dict:
    """K3 on `lanes` lanes of FRAG random symbols, one table of 8-bit codes."""
    from .ops.huffman import FRAG
    rng = np.random.default_rng(seed)
    return {"syms": rng.integers(0, 256, (lanes, FRAG), dtype=np.uint8),
            "lane_len": np.full(lanes, FRAG, np.int32),
            "table_idx": np.zeros(lanes, np.int32),
            "tables": ((8 << 12) | np.arange(256, dtype=np.int32))[None, :]}


def pack_table_inputs(data: np.ndarray) -> dict:
    """K3 on the 16 KiB chunks of `data`, four lanes a chunk, each chunk
    with its host Huffman table."""
    from .ops.huffman import FRAG
    nchunks = len(data) // ANS_CHUNK
    return {"syms": data[:nchunks * ANS_CHUNK].reshape(4 * nchunks, FRAG).astype(np.int32),
            "lane_len": np.full(4 * nchunks, FRAG, np.int32),
            "table_idx": np.repeat(np.arange(nchunks, dtype=np.int32), 4),
            "tables": np.stack([native.huffman_prepare(
                data[c * ANS_CHUNK:(c + 1) * ANS_CHUNK])[0][0].astype(np.int32)
                for c in range(nchunks)])}


def ans_encode_inputs(data: np.ndarray) -> dict:
    """K5 (order 0) on the 16 KiB chunks of `data` that go to the device."""
    from .ops.ans import build_syms_order0
    tables, _, _, flags = native.ans_prepare(data, 0)
    dev = np.nonzero(flags == 0)[0]
    syms = np.stack([build_syms_order0(data[c * ANS_CHUNK:(c + 1) * ANS_CHUNK])
                     for c in dev])
    return {"ans_syms": syms, "ngroups": np.full(len(dev), syms.shape[1], np.int32),
            "ans_tables": tables[dev]}


def ans_decode_inputs(data: np.ndarray) -> dict:
    """K6 (order 0): the device rows of `data`'s host ANS0 payload."""
    from .entropy import ans_device
    payload, _ = native.entropy_encode(5, data, {"bsVersion": 6})
    return ans_device.decode_batch(np.frombuffer(payload, np.uint8), len(data), 0)[0]


def stats_inputs(rows: int, n: int, seed: int = 2) -> dict:
    """block_stats on `rows` random rows of n bytes."""
    return {"blocks": np.random.default_rng(seed).integers(0, 256, (rows, n),
                                                           dtype=np.uint8)}


def device_calls(name: str, st: dict):
    """(kernel, wrapper call) of a bench.py device row on to_port_state
    tensors."""
    from .ops import ans as ops_ans, block_stats, huffman as ops_huffman
    if name == "huffman_pack":
        return "pack_lanes", lambda: ops_huffman.pack_lanes(
            st["syms"], st["lane_len"], st["table_idx"], st["tables"])
    if name == "ans_encode":
        return name, lambda: ops_ans.encode_chunks(st["ans_syms"], st["ngroups"],
                                                   st["ans_tables"])
    if name == "ans_decode":
        glen = int(st["ngroups"].max().item())
        return name, lambda: ops_ans.decode_chunks(
            st["bufs"], st["nbytes"], st["states0"], st["f2s"], st["dtabs"],
            st["ngroups"], st["lr"], 0, glen)
    if name == "block_stats":
        return name, lambda: block_stats.block_stats(st["blocks"])
    raise ValueError(f"no device row {name!r}")


def _device_row(name: str, arrays: dict, nbytes: int, card, readback: bool) -> dict:
    from .ops.state import to_port_state
    kernel, fn = device_calls(name, to_port_state(arrays, card))
    row = dict(timed_kernel(fn), bytes=nbytes)
    row.update(launches=row["launches"][kernel], gbps=nbytes / row["ms"]["median"] / 1e6)
    if "device_ms" in row:
        row["device_gbps"] = nbytes / row["device_ms"]["median"] / 1e6
    if readback:
        rb = spread(readback_ms(fn, row["ms"]["n"]))
        row["readback"] = {"ms": rb, "gbps": nbytes / rb["median"] / 1e6}
    return row


def bench_device_kernels(card) -> dict:
    """bench.py's device rows: K3 on 512 lanes of FRAG, K5 and K6 on 128
    chunks of 16 KiB, block_stats on (16, 1 MiB)."""
    from .ops.huffman import FRAG
    rows = {}
    rows["huffman_pack"] = _device_row("huffman_pack", pack_inputs(512), 512 * FRAG,
                                       card, True)
    data = np.random.default_rng(2).integers(0, 64, 128 * ANS_CHUNK, dtype=np.uint8)
    rows["ans_encode"] = _device_row("ans_encode", ans_encode_inputs(data), len(data),
                                     card, True)
    rows["ans_decode"] = _device_row("ans_decode", ans_decode_inputs(data), len(data),
                                     card, True)
    rows["block_stats"] = _device_row("block_stats", stats_inputs(16, MIB), 16 * MIB,
                                      card, True)
    for k, r in rows.items():
        log(f"device_kernels {k}: {r['ms']['median']:.4f} ms a call ({r['gbps']:.3f} GB/s), "
            f"device {r.get('device_ms', r['ms'])['median']:.5f} ms, with readback "
            f"{r['readback']['ms']['median']:.4f} ms")
    return rows


def bench_batch_curve(card) -> dict:
    """K3, K5 and K6 at 1, 16, 64 and 256 blocks of 256 KiB a launch."""
    rng = np.random.default_rng(42)
    curve = {}
    for nblocks in CURVE_BLOCKS:
        data = rng.integers(0, 64, nblocks * CURVE_BLOCK, dtype=np.uint8)
        curve[str(nblocks)] = {
            "huffman_pack": _device_row("huffman_pack", pack_table_inputs(data),
                                        len(data), card, False),
            "ans_encode": _device_row("ans_encode", ans_encode_inputs(data), len(data),
                                      card, False),
            "ans_decode": _device_row("ans_decode", ans_decode_inputs(data), len(data),
                                      card, False)}
        log(f"batch_curve {nblocks} blocks: " + ", ".join(
            f"{k} {r['gbps']:.3f} GB/s" for k, r in curve[str(nblocks)].items()))
    return curve


# -- every kernel at the main path's shapes -----------------------------------

def main_path_cases(raw: np.ndarray, card):
    """(name, shape, call, (bound ms, by), extra) of each kernel at the
    shapes chip_smoke.py gives it: K1, K2 and block_stats on the blocks; K3
    on the lanes of four raw blocks; K4 on the lanes of their host Huffman
    payloads; K5 and K6 on four blocks at level 5 (and, as order1, four raw
    blocks with ANS1); K7 on four blocks after LZ; K8 on the first chunks
    of their host RANGE payloads; K9 on the first block; K10 on the
    blocks' textbook BWTs; K11 on the blocks."""
    from .entropy import ans_device, device_io, range_device
    from .entropy.huffman_device import DeviceHuffmanEngine
    from .ops import ans as ops_ans, block_stats, bwt_inverse as ops_bi
    from .ops import fpaq_batch as ops_fb, huffman as ops_huffman, range as ops_range
    from .ops import suffix_sort as ops_ss
    from .ops.state import to_port_state

    B, N = raw.shape
    blocks = torch.from_numpy(raw.copy()).to(card)
    lengths = torch.full((B,), N, dtype=torch.int32, device=card)
    h, _ = block_stats.block_stats(blocks)
    yield ("block_stats", [B, N], lambda: block_stats.block_stats(blocks),
           bound(B * N + B * 256 * 4 + B * 4, B * N + 4 * B * 256), {})
    yield ("histograms_u8", [B, N], lambda: block_stats.histograms_u8(blocks),
           bound(B * N + B * 256 * 4, B * N), {})
    yield ("entropy1024", [B, 256], lambda: block_stats.entropy1024(h, lengths),
           bound(B * 256 * 4 + 2 * B * 4, 4 * B * 256), {})
    del blocks, h

    four = list(raw[:4])
    _, (syms, lens, tidx, tables) = DeviceHuffmanEngine(card).lane_batch(four)
    st = to_port_state({"syms": syms, "lane_len": lens, "table_idx": tidx,
                        "tables": tables}, card)
    L, frag = syms.shape
    yield ("pack_lanes", [L, frag], lambda: ops_huffman.pack_lanes(
        st["syms"], st["lane_len"], st["table_idx"], st["tables"]),
        bound(L * frag + 2 * L * 4 + tables.shape[0] * 256 * 4
              + L * ops_huffman.WORDS * 4 + L * 4, 5 * int(lens.sum())), {})

    lanes_l, tidx_l, dt_l, base = [], [], [], 0
    for post in four:
        payload, _ = native.entropy_encode(1, post, {"bsVersion": 6})
        dt, lanes, flags, _ = native.huffman_dec_prepare(np.frombuffer(payload, np.uint8),
                                                         len(post))
        lanes_l.append(lanes.copy())
        tidx_l.append(np.repeat(np.nonzero(flags == 0)[0].astype(np.int32), 4) + base)
        dt_l.append(dt.copy())
        base += len(dt)
    st = to_port_state({"lanes": np.concatenate(lanes_l), "table_idx": np.concatenate(tidx_l),
                        "dtables": np.concatenate(dt_l)}, card)
    L, S = st["lanes"].shape
    bad = torch.empty(L, dtype=torch.int32, device=card)
    yield ("decode_lanes", [L, S], lambda: ops_huffman.decode_lanes(
        st["lanes"], st["table_idx"], st["dtables"], bad),
        bound(L * S + L * 4 + st["dtables"].numel() * 2 + L * ops_huffman.FRAG + L * 4,
              10 * L * ops_huffman.FRAG), {})

    posts5 = transform_posts(four, LEVEL5_CHAIN, "ANS0")

    def encode_case(posts, order):
        _, batch = ans_device.DeviceANSEngine(order, card).encode_batch(posts)
        s = to_port_state(batch, card)
        a = (s["ans_syms"], s["ngroups"], s["ans_tables"])
        R, G, _ = a[0].shape
        # pairs (4G u16), npairs and states out; about 10 operations a symbol
        return ([R, G, 4], lambda: ops_ans.encode_chunks(*a),
                bound(nbytes_of(*a) + R * 4 * G * 2 + R * 20,
                      40 * int(batch["ngroups"].sum())))

    def decode_case(posts, order):
        batch = reader_ans_batch(posts, order)
        glen = int(batch["ngroups"].max())
        s = to_port_state(batch, card)
        a = (s["bufs"], s["nbytes"], s["states0"], s["f2s"], s["dtabs"], s["ngroups"],
             s["lr"])
        R = a[0].shape[0]
        return ([R, glen, 4], lambda: ops_ans.decode_chunks(*a, order, glen, True),
                bound(nbytes_of(*a) + R * glen * 4 + R * 4,
                      12 * 4 * int(batch["ngroups"].sum())))

    shape, call, bnd = encode_case(posts5, 0)
    yield ("ans_encode", shape, call, bnd, {"order1": encode_case(four, 1)})
    shape, call, bnd = decode_case(posts5, 0)
    yield ("ans_decode", shape, call, bnd, {"order1": decode_case(four, 1)})
    del posts5

    posts_lz = transform_posts(four, "LZ", "RANGE")
    _, batch = range_device.DeviceRangeEngine(card).encode_batch(posts_lz)
    s = to_port_state(batch, card)
    a7 = (s["rng_syms"], s["nvalid"], s["rng_tables"], s["shifts"])
    R, W = a7[0].shape
    yield ("range_encode", [R, W], lambda: ops_range.encode_chunks(*a7),
           bound(nbytes_of(*a7) + R * 2 * W * 4 + R * 12, 20 * int(batch["nvalid"].sum())),
           {})
    del a7, s
    batch = device_io.stack([range_device.chunk_batch(
        np.frombuffer(native.entropy_encode(4, p, {"bsVersion": 6})[0], np.uint8), 0,
        range_device._CHUNK)[2] for p in posts_lz])
    s = to_port_state(batch, card)
    a8 = (s["bufs"], s["nbytes"], s["rng_tables"], s["f2s"], s["shifts"], s["nvalid"])
    R, glen = a8[0].shape[0], range_device._CHUNK
    # the engine's call: each row's bits and the host rules' slot bound
    yield ("range_decode", [R, glen],
           lambda: ops_range.decode_chunks(*a8, glen, s["nbits"], s["bound"]),
           bound(nbytes_of(*a8, s["nbits"], s["bound"]) + R * glen + R * 4, 30 * R * glen), {})
    del a8, s

    padded = padded_block(raw[0], card)
    _, rounds = ops_ss.prefix_double(padded, N)
    yield ("prefix_double", [padded.shape[0]], lambda: ops_ss.prefix_double(padded, N),
           prefix_double_bound(padded.shape[0], rounds), {"rounds": rounds})
    del padded

    _, last, prim = textbook(raw, card)
    last_t = torch.from_numpy(last).to(card)
    prim_t = torch.from_numpy(prim).to(card)
    lf, _ = ops_bi.build_lf(last_t)
    n = last.shape[1]
    yield ("lf_walk", [B, n], lambda: ops_bi.lf_walk(last_t, lf, prim_t, n),
           bound(5 * B * n + 4 * B + B * n, B * n), {"jump": ops_bi.jump_rounds(n)})
    del lf, last_t

    data = torch.from_numpy(raw.copy()).to(card)
    nb = torch.full((B,), N, dtype=torch.int32, device=card)
    yield ("fpaq_encode", [B, N], lambda: ops_fb.encode_blocks(data, nb),
           bound(B * N + 4 * B * N + 24 * B, 12 * 8 * B * N), {})


def _kernel_row(name, shape, call, bnd) -> dict:
    """The row of one kernel; bound_share is the bound over the device time
    back to back where it was taken, else over a call's time."""
    row = dict(timed_kernel(call, name not in WAITING_WRAPPERS), shape=shape,
               bound_ms=bnd[0], bound_by=bnd[1])
    row["launches"] = row["launches"][name]
    row["bound_share"] = bnd[0] / row.get("device_ms", row["ms"])["median"]
    return row


def bench_kernels(raw: np.ndarray, card) -> dict:
    rows = {}
    for name, shape, call, bnd, extra in main_path_cases(raw, card):
        source, replaces = KERNEL_SOURCES[name]
        rows[name] = r = dict(_kernel_row(name, shape, call, bnd),
                              source=f"kanzi_tpu_torch/csrc/{source}", replaces=replaces)
        for k, v in extra.items():      # order1 is a case of its own
            r[k] = _kernel_row(name, *v) if k == "order1" else v
        dev = r.get("device_ms")
        log(f"kernel {name} {shape}: median {r['ms']['median']:.4f} ms "
            f"(q1 {r['ms']['q1']:.4f}, q3 {r['ms']['q3']:.4f}, n {r['ms']['n']}), device "
            f"{'-' if dev is None else format(dev['median'], '.5f')} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), share {r['bound_share']:.4f}, "
            f"launches {r['launches']}")
    check(list(rows) == list(K.KERNELS), f"kernel rows {list(rows)} != {K.KERNELS}")
    return rows


# -- levels -------------------------------------------------------------------

def level_rows(selected, corpus: bytes, hard_size: int) -> list:
    """(section, key, data, compress kwargs) of each selected row."""
    mid, small = corpus[:16 * MIB], corpus[:BLOCK]
    hard = synth_hard_corpus(hard_size) if {"8", "9"} & set(selected) else None
    rows = []
    for key in selected:
        if key == "ANS1":
            rows.append(("levels", key, mid, dict(transform="NONE", entropy="ANS1")))
        elif key == "RANGE":
            rows.append(("levels", key, mid, dict(transform="LZ", entropy="RANGE")))
        elif key in ("8", "9"):
            rows.append(("levels", key, small, dict(level=int(key))))
            rows.append(("levels_hard", key, hard, dict(level=int(key))))
        else:
            rows.append(("levels", key, corpus if key == "1" else mid,
                         dict(level=int(key))))
    return rows


def _round_trip(kt, data: bytes, kw: dict, device, jobs: int) -> tuple:
    """(stream, encode MB/s, decode MB/s) of one compress and decompress."""
    t0 = time.perf_counter()
    blob = kt.compress(data, device=device, **kw)
    t1 = time.perf_counter()
    back = kt.decompress(blob, jobs=jobs, device=device)
    t2 = time.perf_counter()
    check(back == data, f"{kw} on {device}: the round trip is not exact")
    return blob, len(data) / (t1 - t0) / 1e6, len(data) / (t2 - t1) / 1e6


def bench_levels(rows: list, runs: int, jobs: int, card) -> dict:
    """Every row on the device and host C++ paths in turns: one warm-up a
    row and path, then `runs` rounds over all rows."""
    import kanzi_tpu_torch as kt

    paths = (("device", card), ("host", None)) if card is not None else (("host", None),)
    state = []
    for sec, key, data, kw in rows:
        kw = dict(kw, block_size=BLOCK, jobs=jobs, checksum=32)
        blobs = {name: _round_trip(kt, data, kw, dev, jobs)[0] for name, dev in paths}
        check(len(set(blobs.values())) == 1,
              f"{sec} {key}: the device stream != the host C++ stream")
        state.append((sec, key, data, kw, blobs["host"], {name: ([], []) for name, _ in paths},
                      {k: 0 for k in K.KERNELS}))
        log(f"{sec} {key}: warm-up done, {len(data)} -> {len(blobs['host'])} bytes")
    for r in range(runs):
        for sec, key, data, kw, want, rates, launches in state:
            for name, dev in paths:
                before = dict(K.launches)
                blob, enc, dec = _round_trip(kt, data, kw, dev, jobs)
                check(blob == want, f"{sec} {key}: the {name} stream changed between runs")
                rates[name][0].append(enc)
                rates[name][1].append(dec)
                if dev is not None:
                    for k in K.KERNELS:
                        launches[k] += K.launches[k] - before[k]
        log(f"levels: round {r + 1} of {runs} done")
    out = {"levels": {}, "levels_hard": {}}
    for sec, key, data, kw, want, rates, launches in state:
        row = {"bytes": len(data), "ratio": len(want) / len(data),
               "kernel": key in KERNEL_ROWS}
        for name, _ in paths:
            row[name] = {"encode_mbs": spread(rates[name][0]),
                         "decode_mbs": spread(rates[name][1])}
        if card is None:
            row["device"] = row["device_over_host"] = UNAVAILABLE
        else:
            row["device"]["launches"] = {k: v for k, v in launches.items() if v}
            check(bool(row["device"]["launches"]) == row["kernel"],
                  f"{sec} {key}: device launches {row['device']['launches']}, but the "
                  f"row is {'' if row['kernel'] else 'not '}marked as running a kernel")
            row["device_over_host"] = {
                d: row["device"][f"{d}_mbs"]["median"] / row["host"][f"{d}_mbs"]["median"]
                for d in ("encode", "decode")}
        out[sec][key] = row
        log(f"{sec} {key}: " + "; ".join(
            f"{name} encode {row[name]['encode_mbs']['median']:.1f}, decode "
            f"{row[name]['decode_mbs']['median']:.1f} MB/s" for name, _ in paths))
    return out


# -- codecs (--codecs) --------------------------------------------------------

def bench_codecs(data: bytes, runs: int, card) -> dict:
    """Every entropy codec and transform standalone on the host C++ engine,
    one warm-up and `runs` runs each; HUFFMAN, ANS0, ANS1 and RANGE also
    through their device engines in turns, their payloads equal to the
    host's."""
    from .entropy import device_io
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    ctx = {"bsVersion": 6, "blockSize": n, "jobs": 1, "entropy": "NONE"}
    out = {"bytes": n, "entropy": {}, "transforms": {}}
    for name in ENTROPY_CODECS:
        et = E.get_type(name)
        # (encode, decode ctx) a path; the device engine is None for the
        # codecs that run on the host C++ engine on every path
        paths = {"host": (lambda: E.encode(et, src, dict(ctx))[0], ctx)}
        engine = E.device_engine(et, card) if card is not None else None
        if engine is not None:
            paths["device"] = (lambda: device_io.encode_block(engine, src, 1 << 18)[0],
                               dict(ctx, device=card))
        rates = {p: ([], []) for p in paths}
        payloads = {}
        for i in range(runs + 1):
            for p, (encode, dctx) in paths.items():
                t0 = time.perf_counter()
                payload = encode()
                t1 = time.perf_counter()
                back = E.decode(et, payload, n, dict(dctx))
                t2 = time.perf_counter()
                check(bytes(back) == data, f"codec {name} ({p}): the round trip is not exact")
                payloads[p] = payload
                if i:              # the first run is the warm-up (it faults model tables)
                    rates[p][0].append(n / (t1 - t0) / 1e6)
                    rates[p][1].append(n / (t2 - t1) / 1e6)
        check(len(set(payloads.values())) == 1,
              f"codec {name}: the device payload != the host payload")
        row = {"ratio": len(payloads["host"]) / n}
        for p in paths:
            row[p] = {"encode_mbs": spread(rates[p][0]), "decode_mbs": spread(rates[p][1])}
        if name in DEVICE_CODECS and card is None:
            row["device"] = UNAVAILABLE
        out["entropy"][name] = row
        log(f"codec {name}: host encode {row['host']['encode_mbs']['median']:.1f} MB/s"
            + (f", device encode {row['device']['encode_mbs']['median']:.1f}"
               if isinstance(row.get("device"), dict) else ""))
    for name in TRANSFORMS:
        encs, decs, skipped, ratio = [], [], False, None
        for i in range(runs + 1):
            seq = T.new_sequence(dict(ctx), T.get_type(name))
            t = time.perf_counter()
            fwd, flags = seq.forward(src)
            t1 = time.perf_counter()
            skipped = bool(flags & 0x80)   # a one-transform chain: bit 7 = skipped
            if not skipped:
                back = seq.inverse(fwd)
                t2 = time.perf_counter()
                check(back.tobytes() == data, f"transform {name}: the round trip is not exact")
                ratio = len(fwd) / n
            if i:
                encs.append(n / (t1 - t) / 1e6)
                if not skipped:
                    decs.append(n / (t2 - t1) / 1e6)
        row = {"forward_mbs": spread(encs), "skipped": skipped}
        if not skipped:
            row.update(inverse_mbs=spread(decs), ratio=ratio)
        out["transforms"][name] = row
    return out


# -- the run ------------------------------------------------------------------

def _size(text: str) -> int:
    t = text.strip().lower()
    scale = {"k": 1 << 10, "m": MIB, "g": 1 << 30}.get(t[-1:], 1)
    return int(t[:-1] if scale > 1 else t) * scale


def _levels(text: str) -> list:
    keys = [k.strip().upper() for k in text.split(",") if k.strip()]
    bad = [k for k in keys if k not in ROWS]
    if bad:
        raise argparse.ArgumentTypeError(f"unknown rows {bad}; rows are {', '.join(ROWS)}")
    return keys


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m kanzi_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--codecs", action="store_true",
                   help="add the codec and transform matrix (2 MiB)")
    p.add_argument("--size", type=_size, default=64 * MIB,
                   help="corpus bytes (64m); level rows take at most 16m, "
                        "levels 8-9 at most 4m")
    p.add_argument("--runs", type=int, default=7, help="measured runs a row and path")
    p.add_argument("--levels", type=_levels, default=list(ROWS),
                   help="rows to run: " + ",".join(ROWS))
    p.add_argument("--jobs", type=int, default=4, help="Writer and Reader jobs")
    args = p.parse_args(argv)
    if args.runs < 1 or args.jobs < 1 or args.size < 1:
        p.error("--runs, --jobs and --size must be positive")
    return args


def run(args) -> dict:
    card = torch.device("cuda") if device_available() else None
    with own_counts():
        build_s = UNAVAILABLE
        if card is not None:
            t = time.perf_counter()
            K.build()
            build_s = time.perf_counter() - t
            log(f"kernel build: {build_s:.3f} s")
        t = time.perf_counter()
        corpus = synth_corpus(args.size)
        log(f"corpus: {len(corpus)} bytes in {time.perf_counter() - t:.3f} s")
        hard_size = min(args.size, BLOCK)
        levels = bench_levels(level_rows(args.levels, corpus, hard_size), args.runs,
                              args.jobs, card)
        l1 = levels["levels"].get("1")
        path = "device" if card is not None else "host"
        value = l1[path]["encode_mbs"]["median"] / 1e3 if l1 else None
        result = {
            "metric": "silesia-like mixed corpus encode GB/s (level 1, 4 MiB blocks, "
                      f"jobs={args.jobs}, kanzi_tpu_torch "
                      + ("device='cuda'" if card is not None else "device=None") + ")",
            "value": value, "unit": "GB/s",
            "vs_baseline": value / BASELINE_L1_ENCODE_GBPS if value is not None else None,
            "card": card_line() if card is not None else UNAVAILABLE,
            "levels": levels["levels"], "levels_hard": levels["levels_hard"]}
        if args.codecs:
            result["codecs"] = bench_codecs(synth_corpus(8 * MIB)[:min(args.size, 2 * MIB)],
                                            args.runs, card)
        if card is None:
            result["device_kernels"] = {k: UNAVAILABLE for k in (
                "huffman_pack", "ans_encode", "ans_decode", "block_stats")}
            result["batch_curve"] = {str(b): UNAVAILABLE for b in CURVE_BLOCKS}
            result["kernels"] = {k: UNAVAILABLE for k in K.KERNELS}
        else:
            result["device_kernels"] = bench_device_kernels(card)
            result["batch_curve"] = bench_batch_curve(card)
            n = min(args.size, BLOCK)
            rows = max(min(args.size, 16 * BLOCK) // n, 1)
            raw = np.frombuffer(corpus, np.uint8)[:rows * n].reshape(rows, n)
            result["kernels"] = bench_kernels(raw, card)
        check(sum(K.plain_calls.values()) == 0,
              f"a plain version ran: {dict(K.plain_calls)}")
        result["launches"] = {k: v for k, v in K.launches.items() if v}
    result["build_s"] = build_s
    result["corpus"] = {"bytes": len(corpus), "seed": SEED, "text": "SURVEY.md",
                        "levels_bytes": min(args.size, 16 * MIB),
                        "levels_8_9_bytes": min(args.size, BLOCK),
                        "hard_bytes": hard_size, "hard_seed": HARD_SEED,
                        "block_size": BLOCK, "jobs": args.jobs, "runs": args.runs}
    result["reference_per_core"] = {
        str(lv): {"encode_gbps": REF_BYTES / (e / 1e3) / 1e9 / REFERENCE_CORES,
                  "decode_gbps": REF_BYTES / (d / 1e3) / 1e9 / REFERENCE_CORES}
        for lv, (e, d) in REF_MS.items()}
    result["host_cores"] = len(os.sched_getaffinity(0))
    return result


def main(argv=None) -> int:
    result = run(parse_args(argv))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
