#!/usr/bin/env python3
"""Drive kanzi_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each failing hard (no exception is caught):

1. the card's name and power limit, and the time to build the kernels
   (nvcc, one process per source under kanzi_tpu_torch/csrc/);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path, with its median time from CUDA events, its
   roofline bound and (where one exists) the time of one PyTorch library
   call computing the same function; K1, K2 and their fused launch
   (block_stats, the one compress_step makes) also with their device time
   from back-to-back launches, beside one empty launch's, and the cluster
   size the fused kernel takes on this card; the rANS kernels'
   ns per symbol and the range kernels' ns per byte, K4's ns per lane step
   at the Reader's one-block launch and its time on four blocks' lanes, K3
   also held and timed at the level 3 Writer's launch, K5 also held on a
   row whose every step emits, K7 and K8 also held on a row of u32 table
   planes, the SM clock, and the RANGE chunk walk's host time per chunk
   beside the range decode kernel's; K9 held on a corpus block and on a
   period-2 block, K10 at (4, 65536) and K11 at (2, 1024);
3. the slice: a 64 MiB seeded corpus through compress/decompress at levels
   2, 3 and 5 on the card, and its first 16 MiB through the ANS1 and RANGE
   codecs, byte-identical to the host C++ path, each decoded with the
   `jobs` it was encoded with, each path read by the launch counters; the
   device decode's launches of each run checked: one a wide batch of
   blocks (K4, K6; the Reader's device_batch_frames at -j 4: 64 blocks of
   4 MiB on an H100, so one for the 16 blocks), the longest block's chunk
   count a wide batch at most (K8);
4. cli: the corpus, written to a temporary file, through the CLI
   (kanzi_tpu_torch.app.main in-process) at -l 2 and -l 5 (three runs of
   --device cuda and --device none in turns) and the first 16 MiB at
   -e ANS1 -t NONE and -e RANGE -t LZ, each at -j 4 -v 4 (the block
   listener attached): streams equal across devices, outputs equal to the
   input, one block line a block, equal with times masked, the encode
   launching once a batch and the decode at most as often as without a
   listener; the stream API (compress_stream/decompress_stream, 1 MiB
   chunks) on the card; `python3 -m kanzi_tpu_torch` in a subprocess with
   no --device (the same stream) and with no visible card (an error, no
   output file); the host striping (compress_multiproc over 4 processes,
   the multihost launcher over 2 ranks) equal to compress(device=None);
5. compress_step on the real blocks and lanes, checked against numpy and
   the integer entropy reference, its block statistics one fused launch;
6. bwt_fpaq: the device BWT and FPAQ entry points on the corpus's 16
   blocks of 4 MiB: bwt_forward_device (K9) on each and on a period-2
   block, byte-identical to the host BWT transform; bwt_inverse_device
   (K10) on the blocks' textbook BWTs, decoding to the blocks;
   fpaq_encode_device_batch (K11) on the 16 blocks, byte-identical to the
   host FPAQ encoder; each kernel's time at that shape beside the host
   C++ time of the same work (K9 also per block, with its rounds and the
   suffixes each round sorted; K10 also at the doubling rounds around its
   wrapper's rule; K11 also in cycles a bit);
7. mesh: the mesh over cards (kanzi_tpu_torch.parallel), on the mesh of
   every card (one on a one-card machine) and on four shards of card 0
   (Mesh([cuda:0] * 4): the split and the gather with the real kernels,
   no multi-card claim): compress_multichip and decompress_multichip of
   the corpus at level 2 and level 5 and of its first 16 MiB with ANS1
   and RANGE (the four-shard mesh: level 2 and ANS1), 4 MiB blocks,
   jobs=4, each stream equal to the host C++ and the single-card stream
   and decoded to the input, one launch a shard with rows a batch, no
   plain version; the MB/s of each run beside the single-card run's;
   compress_step on both meshes equal to the single-card step (its
   launches one fused block_stats and one K3 a shard, its reduced total
   the sum of nbits); dryrun_multichip(device_count()). Its launches are
   counted apart from the main path's ("mesh_launches");
8. robustness: the decode contract on hostile streams, on the card: 420
   seeded mutants (kanzi_tpu_torch.robustness: byte XORs, payload XORs,
   truncations, edits of the first chunk header, of ANS logRange and
   chunk sizes, and of block sizes) of HUFFMAN (K4), ANS0 and ANS1 (K6)
   and RANGE (K8) streams, checksum 32 and 0, 404 of 64 KiB blocks and 16
   of the main path's 4 MiB blocks, each decoded by a device Reader (jobs
   1 and 4 in turns) and by the host C++ Reader: the outcomes equal (the
   same bytes, or KanziError with the same code), no DeviceFault, no
   checksum-32 mutant decoded to other bytes, K4, K6 and K8 launched; then
   a good round trip of each codec and a clean torch.cuda.synchronize();
   the counts by outcome and the phase's seconds on a line of their own;
9. bench: the port's bench (kanzi_tpu_torch.bench.main in-process) on
   16 MiB, three runs of levels 2, 3 and 5, ANS1 and RANGE on the device
   and host C++ paths in turns, and its kernel rows: its JSON read back,
   every device row measured, its card line this card's, no plain version
   run, and the launch counts of the other phases left as they were; each
   kernel's bench median beside its time in the kernel phase;
10. a profile of the level 2, ANS1 and RANGE device paths: the device's
   busy share (torch.profiler) and the host functions that take the time
   (cProfile).

It then prints one JSON line with every kernel's numbers and, last, the
result line {"ok": true, "device": {...}}. Without a card it exits
non-zero and prints no result; without the package beside this script its
import fails.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from kanzi_tpu_torch import bench
from kanzi_tpu_torch.bench import (BLOCK, LEVEL5_CHAIN, MIB, SEED, bound,  # noqa: F401
                                   nbytes_of, period2_block, prefix_double_bound,
                                   synth_corpus)

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = 64 * MIB
SHORT = 16 * MIB          # the ANS1 and RANGE paths: a smaller depth
SLICE_REPS = 3
SHORT_REPS = 3
LEVEL3_CHAIN = "TEXT+UTF+PACK+MM+LZX"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# median_ms, transform_posts, reader_ans_batch, padded_block and textbook
# keep the signatures that tools/torch_kernel_ab.py calls them with; the
# work is the bench module's

def median_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median of per-call device times from CUDA events."""
    return statistics.median(bench.event_ms(fn, reps, warmup))


def transform_posts(native, kt, blocks, chain: str, entropy: str) -> list:
    """The post-transform blocks that the Writer hands the entropy engine
    (bench.transform_posts)."""
    return bench.transform_posts(blocks, chain, entropy)


def hold(torch, kernel, plain, args, extra=()) -> float:
    """Run the kernel and its plain version on the same tensors; fail
    unless they agree exactly. Returns the largest difference (0)."""
    got = kernel(*args, *extra)
    want = plain(*args, *extra)
    torch.cuda.synchronize()
    err = max(float((g.long() - w.long()).abs().max().item()) if g.numel() else 0.0
              for g, w in zip(got, want))
    check(err == 0, f"{kernel.__module__}.{kernel.__name__}: kernel != plain "
          f"(max abs err {err})")
    return err


def reader_ans_batch(native, ans_device, posts, order: int) -> dict:
    """The K6 rows of the blocks' host ANS payloads stacked as the batched
    Reader stacks them (bench.reader_ans_batch)."""
    return bench.reader_ans_batch(posts, order)


def ans_range_kernels(torch, kt, native, raw, cuda, results) -> None:
    """K5-K8 against their plain versions at the main path's shapes."""
    from kanzi_tpu_torch.entropy import ans_device, device_io, range_device
    from kanzi_tpu_torch.ops import ans as ops_ans, range as ops_range
    from kanzi_tpu_torch.ops.state import to_port_state

    # K5, order 0: the level 5 Writer's batch (jobs=4: four 4 MiB blocks)
    posts5 = transform_posts(native, kt, raw[:4], LEVEL5_CHAIN, "ANS0")
    _, batch = ans_device.DeviceANSEngine(0, cuda).encode_batch(posts5)
    st = to_port_state(batch, cuda)
    a = (st["ans_syms"], st["ngroups"], st["ans_tables"])
    err = hold(torch, ops_ans.encode_chunks, ops_ans._encode_chunks_plain, a)
    B, G, _ = a[0].shape
    nsym = 4 * int(batch["ngroups"].sum())
    bms, bby = bound(nbytes_of(*a) + B * 4 * G * 2 + B * 4 + B * 16, 10 * nsym)
    enc = dict(source="kanzi_tpu_torch/csrc/ans.cu",
               replaces="kanzi_tpu/ops/ans.py:54", shape=[B, G, 4],
               max_abs_err=err,
               ms=median_ms(torch, lambda: ops_ans.encode_chunks(*a), 10),
               plain_ms=median_ms(torch, lambda: ops_ans._encode_chunks_plain(*a), 1, 0),
               bound_ms=bms, bound_by=bby, library_ms=None)
    enc["ns_per_step"] = enc["ms"] * 1e6 / nsym
    # a row whose every step emits (xMax 0): npairs = 4G, the whole row is
    # one in-place move at the end of the kernel
    full = (a[0][:1].contiguous(), torch.full((1,), G, dtype=torch.int32, device=cuda),
            a[2][:1].clone())
    full[2][:, 0] = 0
    enc["max_abs_err"] = max(err, hold(torch, ops_ans.encode_chunks,
                                       ops_ans._encode_chunks_plain, full))
    check(int(ops_ans.encode_chunks(*full)[1].item()) == 4 * G, "every-step row")
    del st, a, full

    # K6, order 0: the rows of four blocks' host ANS0 payloads in one
    # launch, as the batched Reader decodes them at level 5 (jobs=4), with
    # the engine's host rule (held under kanzi_tpu's too)
    batch = reader_ans_batch(native, ans_device, posts5, 0)
    glen = int(batch["ngroups"].max())
    st = to_port_state(batch, cuda)
    a = (st["bufs"], st["nbytes"], st["states0"], st["f2s"], st["dtabs"],
         st["ngroups"], st["lr"])
    derr = max(hold(torch, ops_ans.decode_chunks, ops_ans._decode_chunks_plain, a,
                    (0, glen, True)),
               hold(torch, ops_ans.decode_chunks, ops_ans._decode_chunks_plain, a, (0, glen)))
    B = a[0].shape[0]
    nsym = 4 * int(batch["ngroups"].sum())
    bms, bby = bound(nbytes_of(*a) + B * glen * 4 + B * 4, 12 * nsym)
    dec = dict(source="kanzi_tpu_torch/csrc/ans.cu",
               replaces="kanzi_tpu/ops/ans.py:114", shape=[B, glen, 4],
               max_abs_err=derr,
               ms=median_ms(torch, lambda: ops_ans.decode_chunks(*a, 0, glen, True), 10),
               plain_ms=median_ms(torch, lambda: ops_ans._decode_chunks_plain(*a, 0, glen, True),
                                  1, 0),
               bound_ms=bms, bound_by=bby, library_ms=None)
    dec["ns_per_step"] = dec["ms"] * 1e6 / nsym
    del st, a

    # order 1 (ANS1): the kernels timed at the Writer's and the batched
    # Reader's shape (four raw blocks, one 2^20-group row each); the
    # plain loop over 2^20 groups would take minutes, so kernel and plain
    # version are held against each other on one 32 KiB chunk
    eng1 = ans_device.DeviceANSEngine(1, cuda)
    _, batch = eng1.encode_batch(list(raw[:4]))
    st = to_port_state(batch, cuda)
    a = (st["ans_syms"], st["ngroups"], st["ans_tables"])
    B, G, _ = a[0].shape
    bms, bby = bound(nbytes_of(*a) + B * 4 * G * 2 + B * 20,
                     40 * int(batch["ngroups"].sum()))
    enc["order1"] = dict(shape=[B, G, 4], bound_ms=bms, bound_by=bby,
                         ms=median_ms(torch, lambda: ops_ans.encode_chunks(*a), 3))
    enc["order1"]["ns_per_step"] = (enc["order1"]["ms"] * 1e6
                                    / (4 * int(batch["ngroups"].sum())))
    del st, a
    batch = reader_ans_batch(native, ans_device, list(raw[:4]), 1)
    glen = int(batch["ngroups"].max())
    st = to_port_state(batch, cuda)
    a = (st["bufs"], st["nbytes"], st["states0"], st["f2s"], st["dtabs"],
         st["ngroups"], st["lr"])
    B = a[0].shape[0]
    nsym = 4 * int(batch["ngroups"].sum())
    bms, bby = bound(nbytes_of(*a) + B * glen * 4 + B * 4, 12 * nsym)
    dec["order1"] = dict(shape=[B, glen, 4], bound_ms=bms, bound_by=bby,
                         ms=median_ms(torch, lambda: ops_ans.decode_chunks(*a, 1, glen, True),
                                      3))
    dec["order1"]["ns_per_step"] = dec["order1"]["ms"] * 1e6 / nsym
    del st, a
    small = raw[0][:32768]
    _, batch = eng1.encode_batch([small])
    st = to_port_state(batch, cuda)
    a = (st["ans_syms"], st["ngroups"], st["ans_tables"])
    enc["max_abs_err"] = max(err, hold(torch, ops_ans.encode_chunks,
                                       ops_ans._encode_chunks_plain, a))
    enc["order1"].update(held_on=list(a[0].shape), plain_ms=median_ms(
        torch, lambda: ops_ans._encode_chunks_plain(*a), 1, 0))
    payload, _ = native.entropy_encode(8, small, {"bsVersion": 6})
    batch, _ = ans_device.decode_batch(np.frombuffer(payload, np.uint8), len(small), 1)
    glen = int(batch["ngroups"].max())
    st = to_port_state(batch, cuda)
    a = (st["bufs"], st["nbytes"], st["states0"], st["f2s"], st["dtabs"],
         st["ngroups"], st["lr"])
    dec["max_abs_err"] = max(derr, hold(torch, ops_ans.decode_chunks,
                                        ops_ans._decode_chunks_plain, a, (1, glen, True)))
    dec["order1"].update(held_on=[1, glen, 4], plain_ms=median_ms(
        torch, lambda: ops_ans._decode_chunks_plain(*a, 1, glen, True), 1, 0))
    del st, a
    results["ans_encode"], results["ans_decode"] = enc, dec

    # K7: the RANGE Writer's batch (transform LZ, jobs=4: four 4 MiB blocks)
    posts_lz = transform_posts(native, kt, raw[:4], "LZ", "RANGE")
    _, batch = range_device.DeviceRangeEngine(cuda).encode_batch(posts_lz)
    st = to_port_state(batch, cuda)
    a = (st["rng_syms"], st["nvalid"], st["rng_tables"], st["shifts"])
    err = hold(torch, ops_range.encode_chunks, ops_range._encode_chunks_plain, a)
    B, N = a[0].shape
    nb = int(batch["nvalid"].sum())
    bms, bby = bound(nbytes_of(*a) + B * 2 * N * 4 + B * 12, 20 * nb)
    r7 = results["range_encode"] = dict(
        source="kanzi_tpu_torch/csrc/range.cu", replaces="kanzi_tpu/ops/range.py:109",
        shape=[B, N], max_abs_err=err,
        ms=median_ms(torch, lambda: ops_range.encode_chunks(*a), 10),
        plain_ms=median_ms(torch, lambda: ops_range._encode_chunks_plain(*a), 1, 0),
        bound_ms=bms, bound_by=bby, library_ms=None)
    # the chain's time a byte: one launch runs every row's chain at once,
    # so the longest row sets it
    r7["ns_per_step"] = r7["ms"] * 1e6 / int(batch["nvalid"].max())
    # K7 and K8 on one row of u32 table planes (cumFreq at or above 2^31,
    # freq mostly below 16): kernel against plain
    rng = np.random.default_rng(SEED)
    t = rng.integers(1 << 31, 1 << 32, (1, 2, 256), dtype=np.uint64)
    small = rng.random(256) < 0.9
    t[0, 1, small] = rng.integers(1, 16, int(small.sum()), dtype=np.uint64)
    t32 = torch.from_numpy(t.astype(np.uint32).view(np.int32)).to(cuda)
    u = (a[0][:1, :4096].contiguous(), torch.full((1,), 4096, dtype=torch.int32, device=cuda),
         t32, a[3][:1].clone())
    r7["max_abs_err"] = max(err, hold(torch, ops_range.encode_chunks,
                                      ops_range._encode_chunks_plain, u))
    check(int(ops_range.encode_chunks(*u)[1].item()) > 0, "u32 row: no word emitted")
    glen_u = 2048
    ubuf = torch.from_numpy(rng.integers(0, 256, (1, 8 * glen_u), dtype=np.uint8)).to(cuda)
    u_dec = (ubuf, torch.full((1,), 8 * glen_u, dtype=torch.int32, device=cuda), t32,
             torch.from_numpy(rng.integers(0, 256, (1, 4096), dtype=np.uint8)).to(cuda),
             torch.full((1,), 12, dtype=torch.int32, device=cuda),
             torch.full((1,), glen_u, dtype=torch.int32, device=cuda))
    u32_dec_err = hold(torch, ops_range.decode_chunks, ops_range._decode_chunks_plain,
                       u_dec, (glen_u,))
    del st, a, u, u_dec

    # K8: the first chunks of four blocks' host RANGE payloads, four rows as
    # the batched Reader's lockstep walk launches them (jobs=4), with the
    # engine's host rules (each row's bits and slot table bound); also
    # timed under kanzi_tpu's rules (no bound), the call it made before
    payloads = [native.entropy_encode(4, p, {"bsVersion": 6})[0] for p in posts_lz]
    batch = device_io.stack([range_device.chunk_batch(np.frombuffer(p, np.uint8), 0,
                                                      range_device._CHUNK)[2]
                             for p in payloads])
    payload = payloads[0]
    st = to_port_state(batch, cuda)
    a = (st["bufs"], st["nbytes"], st["rng_tables"], st["f2s"], st["shifts"],
         st["nvalid"])
    glen = range_device._CHUNK
    B = a[0].shape[0]
    host_rules = (glen, st["nbits"], st["bound"])
    err = hold(torch, ops_range.decode_chunks, ops_range._decode_chunks_plain, a, host_rules)
    err = max(err, hold(torch, ops_range.decode_chunks, ops_range._decode_chunks_plain, a,
                        (glen,)))
    bms, bby = bound(nbytes_of(*a, st["nbits"], st["bound"]) + B * glen + B * 4,
                     30 * B * glen)
    r = results["range_decode"] = dict(
        source="kanzi_tpu_torch/csrc/range.cu", replaces="kanzi_tpu/ops/range.py:186",
        shape=[B, glen], max_abs_err=max(err, u32_dec_err),
        ms=median_ms(torch, lambda: ops_range.decode_chunks(*a, *host_rules), 20),
        plain_ms=median_ms(torch, lambda: ops_range._decode_chunks_plain(*a, *host_rules),
                           1, 0),
        bound_ms=bms, bound_by=bby, library_ms=None)
    r["ns_per_step"] = r["ms"] * 1e6 / glen
    r["kanzi_rules_ms"] = median_ms(torch, lambda: ops_range.decode_chunks(*a, glen), 20)
    print(f"range_decode at {[B, glen]}: {r['ms']:.4f} ms with the host rules, "
          f"{r['kanzi_rules_ms']:.4f} ms with kanzi_tpu's (no bound)", flush=True)
    # the Reader's chunk walk over the whole block: host clock per chunk
    # beside the kernel's device time, so the host share of a step shows
    n = len(posts_lz[0])
    range_device.range_decode_device(payload, n, cuda)
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        back = range_device.range_decode_device(payload, n, cuda)
        walls.append((time.perf_counter() - t) * 1e3)
    check(back == posts_lz[0].tobytes(), "range chunk walk != input")
    chunks = -(-n // glen)
    per_chunk = statistics.median(walls) / chunks
    print(f"range chunk walk: {n} bytes, {chunks} chunks, wall {statistics.median(walls)} "
          f"ms (runs {walls}), {per_chunk} ms per chunk, of which range_decode "
          f"{r['ms']} ms on the device: host share {per_chunk - r['ms']} ms per chunk",
          flush=True)


def timed_ms(torch, fn):
    """(fn(), its device time in ms from CUDA events): one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def padded_block(torch, block: np.ndarray, device):
    """The (size,) int32 input of prefix_double for one block
    (bench.padded_block)."""
    return bench.padded_block(block, device)


def prefix_double_torch_sort(torch, padded, n: int):
    """K9's rounds with one torch.sort(stable=True) of the packed key in
    place of the hand-written radix sort: the library yardstick, timed
    here and used nowhere in the port."""
    size = padded.shape[0]
    idx = torch.arange(size, device=padded.device)
    rank = torch.where(idx < n, padded.long(), 256 + idx)
    b = (size + 256).bit_length()
    k = 1
    while True:
        pos = idx + k
        r2 = torch.where(pos < n, rank[pos.clamp(max=size - 1)], -1)
        sk, order = torch.sort((rank << b) | (r2 + 1), stable=True)
        neq = torch.ones_like(sk)
        neq[1:] = (sk[1:] != sk[:-1]).long()
        new = torch.cumsum(neq, 0) - 1
        rank = torch.empty_like(rank)
        rank[order] = new
        k *= 2
        if not (k < size and int(new[-1].item()) < size - 1):
            return order


def textbook(ops_ss, blocks, device):
    """(texts, last columns, primary rows) of the textbook BWTs of the
    blocks (bench.textbook)."""
    return bench.textbook(blocks, device)


def scan_kernels(torch, raw, device) -> dict:
    """K9, K10 and K11 against their plain versions on the card, each
    plain call timed: K9 on a corpus block and a period-2 block (with the
    torch.sort yardstick), K10 at (4, 65536), K11 at (2, 1024)."""
    from kanzi_tpu_torch.ops import bwt_inverse as ops_bi, fpaq_batch as ops_fb
    from kanzi_tpu_torch.ops import suffix_sort as ops_ss

    held = {}
    for label, blk in (("corpus", raw[0]), ("period2", period2_block(len(raw[0])))):
        padded = padded_block(torch, blk, device)
        order, rounds = ops_ss.prefix_double(padded, len(blk))
        (want, want_rounds), plain_ms = timed_ms(
            torch, lambda: ops_ss._prefix_double_plain(padded, len(blk)))
        check(torch.equal(order, want) and rounds == want_rounds,
              f"prefix_double kernel != plain on the {label} block")
        lib = prefix_double_torch_sort(torch, padded, len(blk))
        check(torch.equal(lib.to(torch.int32), order), f"torch.sort rounds != K9 ({label})")
        held[f"prefix_double {label}"] = dict(
            shape=[padded.shape[0]], rounds=rounds, plain_ms=plain_ms,
            library_ms=median_ms(torch, lambda: prefix_double_torch_sort(
                torch, padded, len(blk)), 3))

    n = 65536
    _, last, prim = textbook(ops_ss, [r[:n - 1] for r in raw[:4]], device)
    args = [torch.from_numpy(x).to(device) for x in (last, prim)]
    lf, _ = ops_bi.build_lf(args[0])
    got = ops_bi.lf_walk(args[0], lf, args[1], n)
    want, plain_ms = timed_ms(torch, lambda: ops_bi._lf_walk_plain(args[0], lf, args[1], n))
    check(torch.equal(got, want), "lf_walk kernel != plain")
    held["lf_walk"] = dict(shape=list(last.shape), plain_ms=plain_ms)

    data = torch.from_numpy(raw[:2, :1024].copy()).to(device)
    nb = torch.tensor([1024, 700], dtype=torch.int32, device=device)
    got = ops_fb.encode_blocks(data, nb)
    want, plain_ms = timed_ms(torch, lambda: ops_fb._encode_blocks_plain(data, nb))
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "fpaq_encode kernel != plain")
    held["fpaq_encode"] = dict(shape=[2, 1024], plain_ms=plain_ms)
    for name, h in held.items():
        print(f"{name}: held against plain at {h['shape']}, plain {h['plain_ms']:.4f} ms"
              + (f", {h['rounds']} rounds, torch.sort rounds {h['library_ms']:.4f} ms"
                 if "rounds" in h else ""), flush=True)
    return held


def bwt_fpaq(torch, K, native, raw, device, held, results) -> dict:
    """The device BWT and FPAQ entry points on the blocks, byte-identical
    to the host C++ path; then each kernel timed at the path's shapes
    beside the host C++ time of the same work. Returns the path's launch
    counts, set to 0 just before it and read just after."""
    from kanzi_tpu_torch.ops import bwt_inverse as ops_bi, fpaq_batch as ops_fb
    from kanzi_tpu_torch.ops import suffix_sort as ops_ss

    B, N = raw.shape
    blocks = list(raw) + [period2_block(N)]
    texts, last, prim = textbook(ops_ss, raw, device)          # set-up
    K.reset_counts()
    payloads = [ops_ss.bwt_forward_device(b, device) for b in blocks]
    decoded = ops_bi.bwt_inverse_device(last, prim, device)
    coded = ops_fb.fpaq_encode_device_batch(list(raw), device)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    for k in ("prefix_double", "lf_walk", "fpaq_encode"):
        check(counts[k] > 0, f"bwt_fpaq: {k} never launched")
    check(sum(K.plain_calls.values()) == 0, "bwt_fpaq: a plain version ran")

    host = {"BWT forward (SA-IS)": [], "BWT inverse": [], "FPAQ encode": []}
    for i, b in enumerate(blocks):
        t = time.perf_counter()
        ref, _ = native.transform_forward(1, b, {"blockSize": N}, 2 * N + 64)
        host["BWT forward (SA-IS)"].append((time.perf_counter() - t) * 1e3)
        check(payloads[i] == ref, f"block {i}: bwt_forward_device != host BWT")
        t = time.perf_counter()
        back = native.transform_inverse(1, ref, {"blockSize": N}, N)
        host["BWT inverse"].append((time.perf_counter() - t) * 1e3)
        check(back == b.tobytes(), f"block {i}: host BWT inverse != block")
    check(np.array_equal(decoded, texts), "bwt_inverse_device != the textbook blocks")
    for i, b in enumerate(raw):
        t = time.perf_counter()
        want = native.entropy_encode(2, b, {"bsVersion": 6})
        host["FPAQ encode"].append((time.perf_counter() - t) * 1e3)
        check(coded[i] == want, f"block {i}: fpaq_encode_device_batch != host FPAQ")
    print(f"bwt_fpaq: {len(blocks)} BWT payloads (16 blocks and a period-2 block), "
          f"{B} textbook inverses of {last.shape[1]} bytes and {B} FPAQ payloads "
          f"byte-identical to the host C++ path; launches {counts}", flush=True)
    for k, v in host.items():
        print(f"  host C++ {k}: {sum(v)} ms for {len(v)} blocks, per block {v}", flush=True)

    # K9 per block, with its rounds (the first call is the warm-up)
    per_block, rounds = [], []
    for b in blocks:
        padded = padded_block(torch, b, device)
        rounds.append(ops_ss.prefix_double(padded, len(b))[1])
        per_block.append(median_ms(torch, lambda: ops_ss.prefix_double(padded, len(b)), 3, 0))
    print(f"  K9 prefix_double per block: ms {per_block}, rounds {rounds} (the last "
          f"is the period-2 block); 16 corpus blocks {sum(per_block[:B])} ms", flush=True)
    active = {}
    for label, b in (("corpus block 0", blocks[0]), ("period-2 block", blocks[-1])):
        ops_ss.prefix_double(padded_block(torch, b, device), len(b))
        buf = np.zeros(64, np.int64)
        active[label] = buf[:K.query("kz_prefix_double_active", buf.ctypes.data, 64)].tolist()
        print(f"  K9 suffixes sorted per round, {label}: {active[label]} (sum "
              f"{sum(active[label])}, against {rounds[0 if label[0] == 'c' else -1]} "
              f"x {len(b)} for whole-block rounds)", flush=True)
    h = held["prefix_double corpus"]
    check(h["rounds"] == rounds[0], "K9 rounds differ between calls")
    bms, bby = prefix_double_bound(h["shape"][0], rounds[0])
    results["prefix_double"] = dict(
        source="kanzi_tpu_torch/csrc/suffix_sort.cu",
        replaces="kanzi_tpu/ops/suffix_sort.py:40", shape=h["shape"], max_abs_err=0.0,
        ms=per_block[0], plain_ms=h["plain_ms"], bound_ms=bms, bound_by=bby,
        library_ms=h["library_ms"], per_block_ms=per_block, rounds=rounds, active=active,
        period2=dict(held["prefix_double period2"], ms=per_block[-1],
                     bound_ms=prefix_double_bound(h["shape"][0], rounds[-1])[0]))

    # K10 on the 16 textbook BWTs, and build_lf on the card apart
    last_t = torch.from_numpy(last).to(device)
    prim_t = torch.from_numpy(prim).to(device)
    lf_ms = median_ms(torch, lambda: ops_bi.build_lf(last_t), 3)
    lf, _ = ops_bi.build_lf(last_t)
    n = last.shape[1]
    walk_ms = median_ms(torch, lambda: ops_bi.lf_walk(last_t, lf, prim_t, n), 3)
    # K10's doubling rounds: the wrapper's rule and its neighbours
    k_rule = ops_bi.jump_rounds(n)
    jump_ms = {k: median_ms(torch, lambda: ops_bi.lf_walk(last_t, lf, prim_t, n, jump=k), 3)
               for k in range(k_rule - 2, k_rule + 2)}
    bms, bby = bound(5 * B * n + 4 * B + B * n, B * n)
    results["lf_walk"] = dict(
        source="kanzi_tpu_torch/csrc/bwt_inverse.cu",
        replaces="kanzi_tpu/ops/bwt_inverse.py:48", shape=[B, n], max_abs_err=0.0,
        ms=walk_ms, plain_ms=held["lf_walk"]["plain_ms"], held_on=held["lf_walk"]["shape"],
        bound_ms=bms, bound_by=bby, library_ms=None, build_lf_ms=lf_ms,
        ns_per_step=walk_ms * 1e6 / n, jump=k_rule, jump_ms=jump_ms)
    del lf, last_t
    # K11 on the 16 blocks
    data = torch.from_numpy(raw.copy()).to(device)
    nb = torch.full((B,), N, dtype=torch.int32, device=device)
    fpaq_ms = median_ms(torch, lambda: ops_fb.encode_blocks(data, nb), 2)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    bms, bby = bound(B * N + 4 * B * N + 24 * B, 12 * 8 * B * N)
    results["fpaq_encode"] = dict(
        source="kanzi_tpu_torch/csrc/fpaq_batch.cu",
        replaces="kanzi_tpu/ops/fpaq_batch.py:82", shape=[B, N], max_abs_err=0.0,
        ms=fpaq_ms, plain_ms=held["fpaq_encode"]["plain_ms"],
        held_on=held["fpaq_encode"]["shape"], bound_ms=bms, bound_by=bby,
        library_ms=None, ns_per_step=fpaq_ms * 1e6 / N, sm_mhz=sm_mhz,
        cycles_per_bit=fpaq_ms * 1e6 / N * sm_mhz / 1e3 / 8)
    for name in ("prefix_double", "lf_walk", "fpaq_encode"):
        r = results[name]
        print(f"{name}: shape {r['shape']} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms (at {r.get('held_on', r['shape'])}), bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library {r['library_ms']}", flush=True)
    p2 = results["prefix_double"]["period2"]
    print(f"  prefix_double on the period-2 block: {p2['ms']:.4f} ms, {p2['rounds']} rounds, "
          f"bound {p2['bound_ms']:.6f} ms, torch.sort rounds {p2['library_ms']:.4f} ms, "
          f"plain {p2['plain_ms']:.4f} ms", flush=True)
    print(f"  lf_walk: {results['lf_walk']['ns_per_step']} ns per step; build_lf on the "
          f"card {lf_ms:.4f} ms; jump rounds {k_rule} (the rule), ms by rounds "
          f"{jump_ms}", flush=True)
    f = results["fpaq_encode"]
    print(f"  fpaq_encode: {f['ns_per_step']} ns per byte of a row, "
          f"{f['cycles_per_bit']} cycles a bit at the SM clock read after it "
          f"({sm_mhz} MHz)", flush=True)
    return counts


def device_ms(torch, fn, reps: int = 100) -> float:
    """Device time of one call of fn: `reps` calls enqueued behind a spin
    kernel (torch.cuda._sleep), so they run back to back on the device
    whatever the host's time a call, between two CUDA events; fails if the
    spin ended before the host had enqueued them all."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))            # about 50 ms at 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    check(not a.query(), "device_ms: the host fell behind the spin kernel")
    b.synchronize()
    return a.elapsed_time(b) / reps


def block_stats_kernels(torch, K, block_stats, blocks, results) -> None:
    """K1, K2 and their fused launch (block_stats) against their plain
    versions on the 16 corpus blocks of 4 MiB, each with its wrapper-call
    time (CUDA events around one call), its device time (device_ms) and
    the floor of one empty launch measured both ways."""
    cuda = blocks.device
    B, N = blocks.shape
    h_f, e_f = block_stats.block_stats(blocks)
    h_p, e_p = block_stats._block_stats_plain(blocks)
    lengths = torch.full((B,), N, dtype=torch.int32, device=cuda)
    h_k = block_stats.histograms_u8(blocks)
    e_k = block_stats.entropy1024(h_f, lengths)
    torch.cuda.synchronize()
    check(torch.equal(h_f, h_p), "block_stats kernel histograms != plain")
    check(torch.equal(h_k, h_p), "histograms_u8 kernel != plain")
    check(torch.equal(e_f, e_k), "block_stats entropy != entropy1024 on its histograms")
    err_f = int((e_f - e_p).abs().max().item())
    err_k = int((e_k - block_stats._entropy_plain(h_f, lengths)).abs().max().item())
    check(err_f <= 1 and err_k <= 1, f"entropy kernel vs plain differ by {max(err_f, err_k)} > 1")
    resident = np.zeros(8, np.int64)
    c = K.query("kz_block_stats_cluster", B, N, resident.ctypes.data)
    check(c > 0, f"kz_block_stats_cluster failed: {c}")
    stream = torch.cuda.current_stream(cuda).cuda_stream
    empty = lambda: K.query("kz_empty_launch", stream)  # noqa: E731
    floor = dict(device_ms=device_ms(torch, empty, 200), ms=median_ms(torch, empty, 50))

    idx64 = blocks.long()
    ones64 = torch.ones_like(idx64)
    lib_out = torch.zeros(B, 256, dtype=torch.int64, device=cuda)
    lib_ms = median_ms(torch, lambda: lib_out.zero_().scatter_add_(1, idx64, ones64), 5)
    del idx64, ones64, lib_out
    for name, line, fn, plain, nbytes, nops, lib, err in (
            ("block_stats", 100, lambda: block_stats.block_stats(blocks),
             lambda: block_stats._block_stats_plain(blocks),
             B * N + B * 256 * 4 + B * 4, B * N + 4 * B * 256, None, err_f),
            ("histograms_u8", 27, lambda: block_stats.histograms_u8(blocks),
             lambda: block_stats._histograms_plain(blocks), B * N + B * 256 * 4, B * N,
             lib_ms, 0),
            ("entropy1024", 67, lambda: block_stats.entropy1024(h_f, lengths),
             lambda: block_stats._entropy_plain(h_f, lengths), B * 256 * 4 + 2 * B * 4,
             4 * B * 256, None, err_k)):
        bms, bby = bound(nbytes, nops)
        results[name] = dict(
            source="kanzi_tpu_torch/csrc/block_stats.cu",
            replaces=f"kanzi_tpu/ops/pallas_kernels.py:{line}",
            shape=[B, N] if name != "entropy1024" else [B, 256], max_abs_err=float(err),
            ms=median_ms(torch, fn, 50), device_ms=device_ms(torch, fn),
            plain_ms=median_ms(torch, plain, 5), bound_ms=bms, bound_by=bby, library_ms=lib)
        r = results[name]
        print(f"{name}: device {r['device_ms']:.5f} ms, wrapper call {r['ms']:.5f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({bby}): device time at {r['bound_ms'] / r['device_ms']:.1%} "
              f"of the bound", flush=True)
    print(f"block_stats: clusters of {c} CTAs a row for {B} rows; clusters of 1..8 CTAs "
          f"resident at once {resident.tolist()}; one empty launch: device "
          f"{floor['device_ms']:.5f} ms, wrapper call {floor['ms']:.5f} ms", flush=True)
    # many short rows (the first MiB as 256 rows of 4 KiB): the kernel's
    # fixed work a CTA, and the cluster size the card takes for them
    short = blocks.view(-1)[:256 * 4096].view(256, 4096)
    h_s, e_s = block_stats.block_stats(short)
    h_sp, e_sp = block_stats._block_stats_plain(short)
    torch.cuda.synchronize()
    check(torch.equal(h_s, h_sp) and int((e_s - e_sp).abs().max().item()) <= 1,
          "block_stats on 256 rows of 4 KiB != plain")
    rows = dict(shape=[256, 4096], cluster=K.query("kz_block_stats_cluster", 256, 4096,
                                                   resident.ctypes.data),
                device_ms=device_ms(torch, lambda: block_stats.block_stats(short)))
    print(f"block_stats on 256 rows of 4 KiB: clusters of {rows['cluster']}, device "
          f"{rows['device_ms']:.5f} ms", flush=True)
    results["block_stats"].update(cluster=c, resident=resident.tolist(), empty_launch=floor,
                                  short_rows=rows)


def wide_batches(torch, nblocks: int) -> int:
    """The device Reader's wide batches (device_batch_frames) in a stream
    of `nblocks` blocks of BLOCK bytes at jobs=4 on the card."""
    from kanzi_tpu_torch.kio.compressed_stream import device_batch_frames

    return -(-nblocks // device_batch_frames(torch.device("cuda"), BLOCK, 4))


def run_path(torch, kt, K, label, data, reps, kw, kernels, decode_limits) -> dict:
    """One slice path: `reps` runs of the device and the host C++ paths in
    turns, byte-identical streams decoded to the input, each decoded with
    the `jobs` it was encoded with. The launch counts are set to 0 just
    before and read just after; returns them. The device decode's launches
    of each run are checked against `decode_limits` (kernel -> the most
    one decode may make: one a wide batch, or the longest block's chunks a
    wide batch for K8), which shows that the Reader batches its blocks."""
    K.reset_counts()
    runs = {k: [] for k in ("device encode", "device decode",
                            "host C++ encode", "host C++ decode")}
    decode_launches = []
    for _ in range(reps):
        for device, name in (("cuda", "device"), (None, "host C++")):
            t = time.perf_counter()
            blob = kt.compress(data, checksum=32, device=device, **kw)
            torch.cuda.synchronize()
            runs[f"{name} encode"].append(len(data) / (time.perf_counter() - t) / 1e6)
            before = dict(K.launches)
            t = time.perf_counter()
            back = kt.decompress(blob, jobs=kw["jobs"], device=device)
            torch.cuda.synchronize()
            runs[f"{name} decode"].append(len(data) / (time.perf_counter() - t) / 1e6)
            check(back == data, f"{label}: {name} decode != input")
            if device is None:
                check(blob == dev_blob, f"{label}: device stream != host C++ stream")
            else:
                dev_blob = blob
                decode_launches.append({k: K.launches[k] - before[k] for k in kernels})
    counts = dict(K.launches)
    print(f"{label} ({kw}): {len(data)} -> {len(dev_blob)} bytes, {reps} runs "
          f"of each path, launches {counts}; device decode launches per run "
          f"{decode_launches[0]} (at most {decode_limits})", flush=True)
    for k, v in runs.items():
        print(f"  {k}: median {statistics.median(v)} MB/s, runs {v}", flush=True)
    for k in kernels:
        check(counts[k] > 0, f"{label}: {k} never launched")
    for d in decode_launches:
        for k, most in decode_limits.items():
            check(0 < d[k] <= most, f"{label}: {d[k]} {k} launches in one decode, "
                  f"at most {most} (one a wide batch)")
    check(sum(K.plain_calls.values()) == 0, f"{label}: a plain version ran")
    return counts


def block_lines(err: str) -> list:
    """The InfoPrinter's block lines of one CLI run, times masked."""
    return [re.sub(r"\d+ ms", "N ms", ln) for ln in err.splitlines()
            if re.match(r"Block \d+: ", ln)]


def cli_run(K, cli_main, argv) -> tuple:
    """One in-process run of the CLI with stderr captured: (seconds, the
    launches it made, stderr). Fails unless it exits with 0."""
    import contextlib
    import io

    before = dict(K.launches)
    err = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    dt = time.perf_counter() - t
    check(rc == 0, f"cli {argv}: exit code {rc}: {err.getvalue()[-800:]}")
    return dt, {k: K.launches[k] - before[k] for k in K.KERNELS}, err.getvalue()


def cli_path(K, cli_main, tmp, label, src, data, reps, flags, kernels, nblocks,
             dec_limit) -> dict:
    """One CLI path, `reps` runs of --device cuda and --device none in turns,
    each a compress and a decompress at -j 4 -v 4 (the block listener
    attached): streams equal, outputs equal to the input, the block lines
    equal with their times masked and one a block, the encode launching
    its kernel once a batch and the decode at most `dec_limit` times.
    Returns the medians' inputs (MB/s of each run) and the device runs'
    launches."""
    enc_k, dec_k = kernels
    nbatches = -(-nblocks // 4)
    runs = {k: [] for k in ("device encode", "device decode", "host C++ encode",
                            "host C++ decode")}
    per_run = []
    for _ in range(reps):
        for device, name in (("cuda", "device"), ("none", "host C++")):
            knz = os.path.join(tmp, f"{label}.{device}.knz")
            out = os.path.join(tmp, f"{label}.{device}.out")
            dt, enc, err = cli_run(K, cli_main, ["-c", "-i", src, "-o", knz, *flags,
                                                 "-j", "4", "-x32", "-v", "4", "-f",
                                                 f"--device={device}"])
            runs[f"{name} encode"].append(len(data) / dt / 1e6)
            dt, dec, err_d = cli_run(K, cli_main, ["-d", "-i", knz, "-o", out, "-j", "4",
                                                   "-v", "4", "-f", f"--device={device}"])
            runs[f"{name} decode"].append(len(data) / dt / 1e6)
            with open(out, "rb") as fh:
                check(fh.read() == data, f"cli {label}: {name} decode != input")
            with open(knz, "rb") as fh:
                blob = fh.read()
            lines = (block_lines(err), block_lines(err_d))
            check(len(lines[0]) == len(lines[1]) == nblocks,
                  f"cli {label}: {len(lines[0])}, {len(lines[1])} block lines, "
                  f"not one a block ({nblocks})")
            if device == "cuda":
                dev = (blob, lines)
                per_run.append({enc_k: enc[enc_k], dec_k: dec[dec_k]})
                check(enc[enc_k] == nbatches, f"cli {label}: {enc[enc_k]} {enc_k} "
                      f"launches in one encode, not one a batch ({nbatches})")
                check(0 < dec[dec_k] <= dec_limit, f"cli {label}: {dec[dec_k]} {dec_k} "
                      f"launches in one decode with the listener, at most {dec_limit}")
            else:
                check(blob == dev[0], f"cli {label}: --device cuda stream != --device none")
                check(lines == dev[1], f"cli {label}: block lines differ across devices")
    check(sum(K.plain_calls.values()) == 0, f"cli {label}: a plain version ran")
    print(f"cli {label} ({' '.join(flags)} -j 4 -x32 -v 4): {len(data)} -> "
          f"{len(dev[0])} bytes, {nblocks} block lines each way; device launches "
          f"per run {per_run} (encode: one a batch of 4; decode at most {dec_limit})",
          flush=True)
    for k, v in runs.items():
        print(f"  {k}: median {statistics.median(v)} MB/s, runs {v}", flush=True)
    return {"runs": runs, "launches": per_run, "stream": dev[0]}


def cli_phase(torch, kt, K, corpus: bytes, short: bytes, range_chunks: int) -> dict:
    """The CLI (kanzi_tpu_torch.app.main in-process, then `python3 -m
    kanzi_tpu_torch` in a subprocess), the stream API and the host
    striping, on the corpus written to a temporary file. Returns the
    launches of the device runs made in this process."""
    import io
    import shutil
    import tempfile

    from kanzi_tpu_torch.app import main as cli_main
    from kanzi_tpu_torch.parallel import (compress_multiproc, decompress_multiproc,
                                          multihost)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        src, src16 = os.path.join(tmp, "corpus.bin"), os.path.join(tmp, "short.bin")
        for path, data in ((src, corpus), (src16, short)):
            with open(path, "wb") as fh:
                fh.write(data)
        K.reset_counts()
        # the Writer's batches of four blocks, the Reader's wide batches
        batches, wide = CORPUS // BLOCK // 4, wide_batches(torch, CORPUS // BLOCK)
        b = ["-b", str(BLOCK)]   # the levels' own block size (4 MiB)
        paths = {
            "level 2": cli_path(K, cli_main, tmp, "l2", src, corpus, SLICE_REPS,
                                ["-l", "2", *b], ("pack_lanes", "decode_lanes"),
                                CORPUS // BLOCK, wide),
            "level 5": cli_path(K, cli_main, tmp, "l5", src, corpus, SLICE_REPS,
                                ["-l", "5", *b], ("ans_encode", "ans_decode"),
                                CORPUS // BLOCK, wide),
            "ANS1": cli_path(K, cli_main, tmp, "ans1", src16, short, 1,
                             ["-e", "ANS1", "-t", "NONE", *b],
                             ("ans_encode", "ans_decode"), SHORT // BLOCK, 1),
            "RANGE": cli_path(K, cli_main, tmp, "range", src16, short, 1,
                              ["-e", "RANGE", "-t", "LZ", *b],
                              ("range_encode", "range_decode"), SHORT // BLOCK,
                              range_chunks)}

        # the stream API on the card, 1 MiB chunks through file-like objects;
        # compress() writes the input size into the header and the stream
        # API does not, so the stream is held to the host C++ stream API's
        before = dict(K.launches)
        t = time.perf_counter()
        sink = io.BytesIO()
        check(kt.compress_stream(io.BytesIO(corpus), sink, level=2, block_size=BLOCK,
                                 jobs=4, chunk_size=MIB) == len(corpus),
              "compress_stream: count")
        t_enc = time.perf_counter() - t
        host = io.BytesIO()
        kt.compress_stream(io.BytesIO(corpus), host, level=2, block_size=BLOCK, jobs=4,
                           chunk_size=MIB, device=None)
        check(sink.getvalue() == host.getvalue(),
              "compress_stream: device stream != host C++ stream")
        back = io.BytesIO()
        t = time.perf_counter()
        check(kt.decompress_stream(io.BytesIO(sink.getvalue()), back, jobs=4,
                                   chunk_size=MIB) == len(corpus), "decompress_stream: count")
        t_dec = time.perf_counter() - t
        check(back.getvalue() == corpus, "decompress_stream != input")
        check(kt.decompress(sink.getvalue(), jobs=4, device=None) == corpus,
              "the stream API's stream does not decode on the host C++ path")
        stream_launches = {k: K.launches[k] - before[k] for k in ("pack_lanes", "decode_lanes")}
        check(stream_launches["pack_lanes"] == batches
              and 0 < stream_launches["decode_lanes"] <= wide,
              f"stream API launches {stream_launches}")
        print(f"stream API, level 2, jobs=4, 1 MiB chunks: encode "
              f"{len(corpus) / t_enc / 1e6} MB/s, decode {len(corpus) / t_dec / 1e6} "
              f"MB/s, launches {stream_launches}", flush=True)
        launches = dict(K.launches)
        check(sum(K.plain_calls.values()) == 0, "cli phase: a plain version ran")

        # `python3 -m kanzi_tpu_torch` with no --device: the card by default,
        # and without a visible card an error and no output file
        env = dict(os.environ, PYTHONPATH=HERE)
        sub = os.path.join(tmp, "sub.knz")
        argv = [sys.executable, "-m", "kanzi_tpu_torch", "-c", "-i", src, "-o", sub,
                "-l", "2", "-b", str(BLOCK), "-j", "4", "-x32", "-f"]
        t = time.perf_counter()
        res = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True,
                             timeout=300)
        t_sub = time.perf_counter() - t
        check(res.returncode == 0, f"python3 -m kanzi_tpu_torch: {res.stderr[-800:]}")
        with open(sub, "rb") as fh:
            check(fh.read() == paths["level 2"]["stream"],
                  "python3 -m kanzi_tpu_torch stream != the in-process level 2 stream")
        os.remove(sub)
        res = subprocess.run(argv, cwd=HERE, env=dict(env, CUDA_VISIBLE_DEVICES=""),
                             capture_output=True, text=True, timeout=300)
        check(res.returncode != 0 and "No CUDA device" in res.stderr,
              f"no visible card: exit code {res.returncode}, {res.stderr[-400:]}")
        check(not os.path.exists(sub), "no visible card: an output file was left")
        print(f"python3 -m kanzi_tpu_torch -l 2 (no --device): {t_sub:.3f} s with "
              f"its start, stream equal; with CUDA_VISIBLE_DEVICES='': exit code "
              f"{res.returncode}, no output: {res.stderr.strip()}", flush=True)

        # the host striping on the first 16 MiB (4 blocks of 4 MiB)
        cfg = dict(transform="DNA+LZ", entropy="HUFFMAN", block_size=BLOCK, checksum=32)
        want = kt.compress(short, device=None, **cfg)
        t = time.perf_counter()
        check(compress_multiproc(short, procs=4, **cfg) == want,
              "compress_multiproc != compress(device=None)")
        check(decompress_multiproc(want, procs=4) == short, "decompress_multiproc != input")
        t_mp = time.perf_counter() - t
        mh = os.path.join(tmp, "mh.knz")
        margs = [sys.executable, "-m", "kanzi_tpu_torch.parallel.multihost", "-i", src16,
                 "-o", mh, "--transform", "DNA+LZ", "--entropy", "HUFFMAN",
                 "--block-size", str(BLOCK), "--checksum", "32"]
        t = time.perf_counter()
        ranks = [subprocess.Popen(margs, cwd=HERE, env=dict(env, KANZI_RANK=str(r),
                                                            KANZI_WORLD="2"))
                 for r in range(2)]
        codes = [p.wait(timeout=300) for p in ranks]
        check(codes == [0, 0], f"multihost ranks: exit codes {codes}")
        check(subprocess.run(margs + ["--assemble", "--world", "2"], cwd=HERE, env=env,
                             timeout=300).returncode == 0, "multihost --assemble failed")
        with open(mh, "rb") as fh:
            check(fh.read() == want, "multihost stream != compress(device=None)")
        check(multihost.decompress_multihost(want, world=2) == short,
              "decompress_multihost != input")
        t_mh = time.perf_counter() - t
        print(f"host striping, {len(short) >> 20} MiB ({cfg}): compress_multiproc + "
              f"decompress_multiproc (4 processes) {t_mp:.3f} s; multihost launcher "
              f"(2 ranks + assemble) + decompress_multihost {t_mh:.3f} s; streams "
              f"equal to compress(device=None)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label in ("level 2", "level 5"):
        r = paths[label]["runs"]
        print(f"cli MB/s, {label} (medians of {SLICE_REPS} runs in turns): "
              + ", ".join(f"{k} {statistics.median(v)}" for k, v in r.items()), flush=True)
    return launches


def mesh_run(torch, kt, K, parallel, mesh, label, data, kw, kernels, want) -> dict:
    """One config through compress_multichip and decompress_multichip on
    `mesh`: the stream equal to `want` (the host C++ stream, which the
    single-card stream equals too), decoded to the input, no plain version
    run, and one launch of each sharded kernel a shard with rows a batch
    (the rows of every sharded launch read by a spy on the launch). The
    launch counts are set to 0 just before each direction and read just
    after; returns them summed, and the MB/s of each direction."""
    rows = []
    real = parallel._launch_rows

    def spy(m, streams, row_arrays, tables, kernel):
        rows.append(len(next(iter(row_arrays.values()))))
        return real(m, streams, row_arrays, tables, kernel)

    nonempty = lambda r: sum(hi > lo for lo, hi in mesh.shares(r))  # noqa: E731
    parallel._launch_rows = spy
    try:
        K.reset_counts()
        t = time.perf_counter()
        blob = parallel.compress_multichip(data, mesh, checksum=32, block_size=BLOCK,
                                           jobs=4, **kw)
        torch.cuda.synchronize()
        enc_mbs = len(data) / (time.perf_counter() - t) / 1e6
        counts = dict(K.launches)
        enc_rows = list(rows)
        check(blob == want, f"mesh {label}: stream != the host C++ and single-card stream")
        rows.clear()
        K.reset_counts()
        t = time.perf_counter()
        back = parallel.decompress_multichip(blob, mesh)
        torch.cuda.synchronize()
        dec_mbs = len(data) / (time.perf_counter() - t) / 1e6
        check(back == data, f"mesh {label}: decode != input")
        dec_rows = list(rows)
    finally:
        parallel._launch_rows = real
    check(sum(K.plain_calls.values()) == 0, f"mesh {label}: a plain version ran")
    nblocks = -(-len(data) // BLOCK)
    enc_k, dec_k = kernels
    check(0 < len(enc_rows) <= -(-nblocks // 4)
          and counts[enc_k] == sum(nonempty(r) for r in enc_rows),
          f"mesh {label}: {counts[enc_k]} {enc_k} launches for sharded launches of "
          f"{enc_rows} rows")
    if dec_k == "range_decode":    # RANGE decodes on the mesh's first card
        check(dec_rows == [] and K.launches[dec_k] > 0, f"mesh {label}: RANGE decode")
    else:
        # decompress_multichip's Reader: jobs = the mesh's size (blocks a batch)
        check(0 < len(dec_rows) <= -(-nblocks // mesh.size)
              and K.launches[dec_k] == sum(nonempty(r) for r in dec_rows),
              f"mesh {label}: {K.launches[dec_k]} {dec_k} launches for sharded "
              f"launches of {dec_rows} rows")
    if len(set(mesh.devices)) < mesh.size:   # shards on one card: every one ran
        check(all(r >= mesh.size for r in enc_rows + dec_rows),
              f"mesh {label}: a batch left a shard empty ({enc_rows}, {dec_rows})")
    for k, v in K.launches.items():
        counts[k] += v
    print(f"mesh {label} on {mesh}: {len(data)} -> {len(blob)} bytes, encode "
          f"{enc_mbs} MB/s (sharded launches of {enc_rows} rows), decode {dec_mbs} "
          f"MB/s ({dec_rows}), launches {counts}", flush=True)
    return {"launches": counts, "encode": enc_mbs, "decode": dec_mbs}


def mesh_phase(torch, kt, K, parallel, smi, corpus, short, raw, lanes, step) -> dict:
    """The mesh over cards: compress_multichip and decompress_multichip on
    the mesh of every card and on four shards of one card (the split and
    the gather with the real kernels; no multi-card claim), each stream
    equal to the host C++ and the single-card stream; compress_step on
    both meshes equal to the single-card step `step`, its reduced total
    equal to the sum of its lane bit counts; dryrun_multichip. Returns the
    phase's launches."""
    world = parallel.device_mesh()
    split = parallel.Mesh([torch.device("cuda", 0)] * 4)
    paths = {"level 2": (corpus, dict(transform="DNA+LZ", entropy="HUFFMAN"),
                         ("pack_lanes", "decode_lanes")),
             "level 5": (corpus, dict(transform=LEVEL5_CHAIN, entropy="ANS0"),
                         ("ans_encode", "ans_decode")),
             "ANS1": (short, dict(transform="NONE", entropy="ANS1"),
                      ("ans_encode", "ans_decode")),
             "RANGE": (short, dict(transform="LZ", entropy="RANGE"),
                       ("range_encode", "range_decode"))}
    launches = {k: 0 for k in K.KERNELS}
    rates = {}
    for label, (data, kw, kernels) in paths.items():
        cfg = dict(checksum=32, block_size=BLOCK, jobs=4, **kw)
        want = kt.compress(data, device=None, **cfg)
        t = time.perf_counter()
        single = kt.compress(data, device="cuda", **cfg)
        torch.cuda.synchronize()
        enc_mbs = len(data) / (time.perf_counter() - t) / 1e6
        check(single == want, f"{label}: single-card stream != host C++ stream")
        t = time.perf_counter()
        check(kt.decompress(single, jobs=4, device="cuda") == data,
              f"{label}: single-card decode != input")
        torch.cuda.synchronize()
        rates[label] = {"single card": (enc_mbs,
                                        len(data) / (time.perf_counter() - t) / 1e6)}
        for name, mesh in (("world", world), ("split", split)):
            if name == "split" and label not in ("level 2", "ANS1"):
                continue
            r = mesh_run(torch, kt, K, parallel, mesh, f"{label} ({name})", data, kw,
                         kernels, want)
            rates[label][f"{name} mesh ({mesh.size} shards)"] = (r["encode"], r["decode"])
            for k, v in r["launches"].items():
                launches[k] += v
    print(f"mesh MB/s (encode, decode), one run each, {smi}:", flush=True)
    for label, r in rates.items():
        print(f"  {label}: " + "; ".join(f"{k} {v[0]}, {v[1]}" for k, v in r.items()),
              flush=True)

    # compress_step on both meshes against the single-card step
    blocks, (syms, lens, tidx, tables) = raw, lanes
    for name, mesh in (("world", world), ("split", split)):
        K.reset_counts()
        got = parallel.compress_step(blocks, syms, lens, tidx, tables, mesh=mesh)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        for a, b, what in zip(got, step, ("histos", "entropy1024", "words", "nbits",
                                          "total")):
            check(torch.equal(a.cpu(), b.cpu()), f"compress_step ({name} mesh): {what} "
                  "!= the single-card step")
        check(got[4].device == mesh.devices[0] and int(got[4]) == int(got[3].sum()),
              f"compress_step ({name} mesh): total")
        nb = sum(hi > lo for lo, hi in mesh.shares(len(blocks)))
        nl = sum(hi > lo for lo, hi in mesh.shares(len(syms)))
        check(counts["block_stats"] == nb and counts["pack_lanes"] == nl,
              f"compress_step ({name} mesh): launches {counts}, expected {nb} and {nl}")
        check(sum(K.plain_calls.values()) == 0, "compress_step on a mesh: a plain version ran")
        for k, v in counts.items():
            launches[k] += v
        print(f"compress_step on the {name} mesh {mesh}: equal to the single-card "
              f"step, total {int(got[4])} bits, launches {counts}", flush=True)

    K.reset_counts()
    t = time.perf_counter()
    parallel.dryrun_multichip(torch.cuda.device_count())
    torch.cuda.synchronize()
    check(sum(K.plain_calls.values()) == 0, "dryrun_multichip: a plain version ran")
    for k, v in K.launches.items():
        launches[k] += v
    print(f"dryrun_multichip({torch.cuda.device_count()}): {time.perf_counter() - t:.3f} s, "
          f"launches {dict(K.launches)}", flush=True)
    return launches


ROBUST_STREAMS, ROBUST_BIG = 404, 16    # 64 KiB-block and 4 MiB-block mutants


def robustness_phase(torch, kt, K, smi: str) -> None:
    """Hostile streams through device Readers against the host C++
    Reader (kanzi_tpu_torch.robustness): every outcome equal, no fault, the
    context usable after; the counts and the phase's launches printed."""
    from kanzi_tpu_torch import robustness

    t0 = time.perf_counter()
    cases = list(robustness.streams(ROBUST_STREAMS, big=ROBUST_BIG))
    made = time.perf_counter() - t0
    check(len(cases) == ROBUST_STREAMS + ROBUST_BIG,
          f"robustness: {len(cases)} streams made, not {ROBUST_STREAMS + ROBUST_BIG}")
    K.reset_counts()
    res = robustness.check(cases, lambda b, j: kt.decompress(b, jobs=j, device="cuda"),
                           lambda b, j: kt.decompress(b, jobs=j, device=None), jobs=(1, 4))
    torch.cuda.synchronize()
    launches = dict(K.launches)
    check(sum(K.plain_calls.values()) == 0, "robustness: a plain version ran")
    for k in ("decode_lanes", "ans_decode", "range_decode"):
        check(launches[k] > 0, f"robustness: {k} never launched")
    check(not res["disagree"], f"robustness: device and host disagree on "
          f"{len(res['disagree'])} streams: {res['disagree'][:8]}")
    check(res["wrong_bytes"] == 0, f"robustness: {res['wrong_bytes']} checksum-32 "
          "mutants decoded to other bytes than the input")
    # the context stays usable: a good round trip of each codec
    good = bench.synth_corpus(1 << 20, 7)
    for codec, kw in robustness.CODECS.items():
        blob = kt.compress(good, block_size=256 << 10, checksum=32, jobs=4,
                           device="cuda", **kw)
        check(blob == kt.compress(good, block_size=256 << 10, checksum=32, jobs=4,
                                  device=None, **kw), f"robustness: {codec} stream after")
        check(kt.decompress(blob, jobs=4, device="cuda") == good,
              f"robustness: {codec} round trip after the hostile streams")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print("robustness " + json.dumps({
        "streams": res["streams"], "exact": res["exact"],
        "other_bytes": res["other_bytes"],
        "rejected": {str(k): v for k, v in sorted(res["rejected"].items())},
        "disagree": len(res["disagree"]), "by_codec": res["by_codec"],
        "decode_seconds": round(res["seconds"], 3), "made_seconds": round(made, 3),
        "seconds": round(seconds, 3), "card": smi}), flush=True)
    print(f"robustness launches: {launches}", flush=True)


def bench_phase(K, smi: str, results: dict) -> None:
    """kanzi_tpu_torch.bench.main in-process on 16 MiB, three runs of levels
    2, 3 and 5, ANS1 and RANGE: its last stdout line parsed, every device
    row measured, its card line this card's, no plain version run and the
    other phases' launch counts untouched; each kernel's bench median
    printed beside its kernel-phase time (the bench's K1, K2, block_stats,
    K10 and K11 rows run on four blocks here, the kernel phase's on 16)."""
    import contextlib
    import io

    before = (dict(K.launches), dict(K.plain_calls))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--size", "16m", "--runs", "3", "--levels", "2,3,5,ANS1,RANGE"])
    check(rc == 0, f"bench: exit code {rc}")
    check((dict(K.launches), dict(K.plain_calls)) == before,
          "bench: the launch counts of the other phases changed")
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    check(result["card"] == smi, f"bench: card {result['card']!r}, not {smi!r}")
    check(sorted(result["levels"]) == sorted(["2", "3", "5", "ANS1", "RANGE"]),
          f"bench: rows {sorted(result['levels'])}")
    for key, row in result["levels"].items():
        d, h = row["device"], row["host"]
        check(row["kernel"] and d["launches"], f"bench {key}: no device launch")
        for way in ("encode_mbs", "decode_mbs"):
            check(d[way]["n"] == 3 and d[way]["min"] > 0 and h[way]["min"] > 0,
                  f"bench {key}: {way} not measured")
        print(f"bench {key}: MB/s medians device/host encode {d['encode_mbs']['median']}/"
              f"{h['encode_mbs']['median']}, decode {d['decode_mbs']['median']}/"
              f"{h['decode_mbs']['median']}; device launches {d['launches']}", flush=True)
    check(list(result["kernels"]) == list(K.KERNELS), "bench: kernel rows")
    for name, r in result["kernels"].items():
        check(r["ms"]["median"] > 0 and r["launches"] > 0 and r["bound_ms"] > 0,
              f"bench kernel {name}: not measured")
        k = results[name]
        print(f"bench kernel {name} {r['shape']}: median {r['ms']['median']:.4f} ms (q1 "
              f"{r['ms']['q1']:.4f}, q3 {r['ms']['q3']:.4f}, n {r['ms']['n']}), device "
              f"{r.get('device_ms', {}).get('median')} ms; kernel phase {k['ms']:.4f} ms, "
              f"device {k.get('device_ms')} ms at {k['shape']}", flush=True)
    for name, r in result["device_kernels"].items():
        check(r["ms"]["median"] > 0 and r["readback"]["ms"]["median"] > 0,
              f"bench device row {name}: not measured")
    for nblocks, point in result["batch_curve"].items():
        check(all(r["gbps"] > 0 for r in point.values()), f"bench curve {nblocks}")
    print(f"bench: {result['metric']}: value {result['value']}; device rows "
          f"{ {k: r['gbps'] for k, r in result['device_kernels'].items()} } GB/s; launches "
          f"{result['launches']}", flush=True)


def profile_path(torch, kt, name: str, data: bytes, kw: dict) -> None:
    """One device compress and decompress of a slice path under
    torch.profiler (the device's busy time against the wall time) and one
    of each under cProfile (the host functions that take the time, on the
    calling thread). Runs after the measured phases: both profilers slow
    the host."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    def encode():
        return kt.compress(data, checksum=32, device="cuda", **kw)

    blob = encode()
    for label, fn in (("encode", encode),
                      ("decode", lambda: kt.decompress(blob, jobs=kw["jobs"],
                                                       device="cuda"))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        dev = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.self_device_time_total > 0}
        if dev:
            busy = sum(dev.values())
            top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
            print(f"{name} {label} under torch.profiler: wall {wall_ms} ms, "
                  f"device busy {busy} ms (sum of device self times), idle "
                  f"share {1 - busy / wall_ms}; top device: {top}", flush=True)
        else:
            print(f"{name} {label} under torch.profiler: wall {wall_ms} ms, "
                  "no device time recorded: busy share not measured", flush=True)
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(8)
        lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
        print(f"{name} {label} under cProfile, top host functions by own time:")
        print("\n".join(lines[-9:]), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    import kanzi_tpu_torch as kt
    from kanzi_tpu_torch import _kernels as K, internal, native, parallel
    from kanzi_tpu_torch.entropy.huffman_device import DeviceHuffmanEngine
    from kanzi_tpu_torch.ops import block_stats, huffman as ops_huffman
    from kanzi_tpu_torch.ops.state import to_port_state

    t0 = time.perf_counter()
    K.build()
    phase_s = {"build": time.perf_counter() - t0}
    print(f"kernel build: {phase_s['build']:.3f} s "
          f"(nvcc, {len(K.build_log)} sources in parallel)", flush=True)
    # what ptxas gave the fused block-stats kernel (registers, shared memory)
    print("block_stats.cu ptxas: " + "; ".join(
        ln.split(":", 1)[1].strip() for ln in K.build_log.get("block_stats.cu", "").splitlines()
        if "registers" in ln), flush=True)
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    corpus = synth_corpus(CORPUS)
    raw = np.frombuffer(corpus, dtype=np.uint8).reshape(-1, BLOCK)   # (16, 4 MiB)
    results = {}

    # -- 2. kernels against their plain versions, at main-path shapes -----
    print("== kernels", flush=True)
    t_phase = time.perf_counter()
    blocks = torch.from_numpy(raw.copy()).to(cuda)
    block_stats_kernels(torch, K, block_stats, blocks, results)

    # K3 on the lane batch of four raw blocks, real tables
    engine = DeviceHuffmanEngine(cuda)
    posts4 = [raw[i] for i in range(4)]
    _, batch = engine.lane_batch(posts4)
    syms_np, lens_np, tidx_np, tables_np = batch
    st = to_port_state({"syms": syms_np, "lane_len": lens_np,
                        "table_idx": tidx_np, "tables": tables_np}, cuda)
    args = (st["syms"], st["lane_len"], st["table_idx"], st["tables"])
    w_k, n_k = ops_huffman.pack_lanes(*args)
    w_p, n_p = ops_huffman._pack_lanes_plain(*args)
    check(torch.equal(w_k, w_p) and torch.equal(n_k, n_p),
          "pack_lanes kernel != plain")
    L, frag = st["syms"].shape
    ms = median_ms(torch, lambda: ops_huffman.pack_lanes(*args), 20)
    plain_ms = median_ms(torch, lambda: ops_huffman._pack_lanes_plain(*args), 3)
    nsym = int(lens_np.sum())
    bms, bby = bound(L * frag + 2 * L * 4 + tables_np.shape[0] * 256 * 4
                     + L * ops_huffman.WORDS * 4 + L * 4, 5 * nsym)
    results["pack_lanes"] = dict(
        source="kanzi_tpu_torch/csrc/huffman.cu",
        replaces="kanzi_tpu/ops/huffman.py:29", shape=[L, frag],
        max_abs_err=float(max((w_k.long() - w_p.long()).abs().max().item(),
                              (n_k - n_p).abs().max().item())),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None)
    del w_p, n_p
    # K3 at the level 3 Writer's launch (jobs=1: one block's lanes)
    _, b3 = engine.lane_batch(transform_posts(native, kt, raw[:1], LEVEL3_CHAIN, "HUFFMAN"))
    st3 = to_port_state(dict(zip(("syms", "lane_len", "table_idx", "tables"), b3)), cuda)
    args3 = (st3["syms"], st3["lane_len"], st3["table_idx"], st3["tables"])
    err3 = hold(torch, ops_huffman.pack_lanes, ops_huffman._pack_lanes_plain, args3)
    L3 = args3[0].shape[0]
    bms3, bby3 = bound(L3 * frag + 2 * L3 * 4 + b3[3].shape[0] * 256 * 4
                       + L3 * ops_huffman.WORDS * 4 + L3 * 4, 5 * int(b3[1].sum()))
    results["pack_lanes"]["max_abs_err"] = max(results["pack_lanes"]["max_abs_err"], err3)
    results["pack_lanes"]["level3"] = dict(
        shape=list(args3[0].shape), bound_ms=bms3, bound_by=bby3,
        ms=median_ms(torch, lambda: ops_huffman.pack_lanes(*args3), 20))

    # K4 on the real lanes of the same four blocks' host Huffman payloads:
    # the batched Reader's launch at level 2 (jobs=4) decodes the four
    # blocks' lanes; the level 3 Reader's (jobs=1) one block's, held and
    # timed too
    lanes_l, tidx_l, dt_l, base = [], [], [], 0
    for post in posts4:
        payload, _ = native.entropy_encode(1, post, {"bsVersion": 6})
        dt, lanes, flags, _ = native.huffman_dec_prepare(
            np.frombuffer(payload, np.uint8), len(post))
        lanes_l.append(lanes.copy())
        tidx_l.append(np.repeat(np.nonzero(flags == 0)[0].astype(np.int32), 4) + base)
        dt_l.append(dt.copy())
        base += len(dt)
    one = to_port_state({"lanes": lanes_l[0], "table_idx": tidx_l[0],
                         "dtables": dt_l[0]}, cuda)
    four = to_port_state({"lanes": np.concatenate(lanes_l),
                          "table_idx": np.concatenate(tidx_l),
                          "dtables": np.concatenate(dt_l)}, cuda)
    dargs, dargs4 = [tuple(x[k] for k in ("lanes", "table_idx", "dtables"))
                     for x in (one, four)]
    L, S = dargs4[0].shape
    # the engine's call: the table index flags come back beside the symbols
    dbad = torch.empty(len(dargs4[0]), dtype=torch.int32, device=cuda)
    err = 0.0
    for a in (dargs, dargs4):
        s_k = ops_huffman.decode_lanes(*a, dbad[:len(a[0])])
        s_p = ops_huffman._decode_lanes_plain(*a)
        check(torch.equal(s_k, s_p) and not dbad[:len(a[0])].any(),
              f"decode_lanes kernel != plain at {list(a[0].shape)}")
        err = max(err, float((s_k.int() - s_p.int()).abs().max().item()))
    ms = median_ms(torch, lambda: ops_huffman.decode_lanes(*dargs4, dbad), 10)
    plain_ms = median_ms(torch, lambda: ops_huffman._decode_lanes_plain(*dargs4), 1, 0)
    bms, bby = bound(L * S + L * 4 + dargs4[2].numel() * 2 + L * ops_huffman.FRAG
                     + L * 4, 10 * L * ops_huffman.FRAG)
    results["decode_lanes"] = dict(
        source="kanzi_tpu_torch/csrc/huffman.cu",
        replaces="kanzi_tpu/ops/huffman.py:86", shape=[L, S], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
        ns_per_step=ms * 1e6 / ops_huffman.FRAG,
        one_block=dict(shape=list(dargs[0].shape), ms=median_ms(
            torch, lambda: ops_huffman.decode_lanes(*dargs, dbad[:len(dargs[0])]), 10)))
    del s_p
    ans_range_kernels(torch, kt, native, raw, cuda, results)
    held = scan_kernels(torch, raw, cuda)
    for name, r in results.items():
        print(f"{name}: shape {r['shape']} kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), library {r['library_ms']}, "
              f"max_abs_err {r['max_abs_err']}", flush=True)
        if "ns_per_step" in r:
            unit = {"decode_lanes": "lane step", "range_encode": "byte",
                    "range_decode": "byte"}.get(name, "symbol")
            print(f"  {name}: {r['ns_per_step']} ns per {unit}", flush=True)
        if "level3" in r:
            o = r["level3"]
            print(f"  {name}: the level 3 Writer's launch, shape {o['shape']}: "
                  f"{o['ms']:.4f} ms, bound {o['bound_ms']:.6f} ms ({o['bound_by']})",
                  flush=True)
        if "one_block" in r:
            print(f"  {name}: one block's lanes (the level 3 Reader's launch), shape "
                  f"{r['one_block']['shape']}: {r['one_block']['ms']:.4f} ms", flush=True)
        if "order1" in r:
            o = r["order1"]
            print(f"  {name} order 1: kernel {o['ms']:.4f} ms at shape "
                  f"{o['shape']}, bound {o['bound_ms']:.6f} ms ({o['bound_by']}); "
                  f"held against plain on one 32 KiB chunk, shape "
                  f"{o['held_on']}, plain {o['plain_ms']:.4f} ms", flush=True)
            if "ns_per_step" in o:
                print(f"  {name} order 1: {o['ns_per_step']} ns per symbol", flush=True)
    print(f"range coder chain, ns per byte: K7 range_encode "
          f"{results['range_encode']['ns_per_step']}, K8 range_decode "
          f"{results['range_decode']['ns_per_step']}", flush=True)
    # the SM clock, to turn ns per step into cycles
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"SM clock after the kernel phase (now, max): {clocks}", flush=True)
    phase_s["kernels"] = time.perf_counter() - t_phase

    # -- 3. the slice: Writer/Reader on the card --------------------------
    # runs of each path, device and host C++ in turns, so that the spread
    # shows beside the medians
    print("== slice", flush=True)
    t_phase = time.perf_counter()
    from kanzi_tpu_torch.entropy import ans_device, range_device
    posts_lz = transform_posts(native, kt, raw[:SHORT // BLOCK], "LZ", "RANGE")
    ans_device.counts["host_route"] = 0
    huff, ans, rng_k = ("pack_lanes", "decode_lanes"), ("ans_encode", "ans_decode"), \
        ("range_encode", "range_decode")
    short = corpus[:SHORT]
    main_launches = {k: 0 for k in K.KERNELS}
    # one launch a wide batch of blocks at jobs=4 (every block of these
    # paths has device chunks), one a block at jobs=1; RANGE: the longest
    # block's chunk count a wide batch (the 16 MiB are one batch of four
    # LZ blocks)
    batches4, batches1 = wide_batches(torch, CORPUS // BLOCK), CORPUS // BLOCK
    range_chunks = max(-(-len(p) // range_device._CHUNK) for p in posts_lz)
    for label, data, reps, kw, kernels, limits in (
            ("level 2", corpus, SLICE_REPS, dict(level=2, jobs=4), huff,
             {"decode_lanes": batches4}),
            ("level 3", corpus, SLICE_REPS, dict(level=3, jobs=1), huff,
             {"decode_lanes": batches1}),
            ("level 5", corpus, SLICE_REPS, dict(level=5, jobs=4), ans,
             {"ans_decode": batches4}),
            ("ANS1", short, SHORT_REPS, dict(transform="NONE", entropy="ANS1",
                                            block_size=BLOCK, jobs=4), ans,
             {"ans_decode": 1}),
            ("RANGE", short, SHORT_REPS, dict(transform="LZ", entropy="RANGE",
                                             block_size=BLOCK, jobs=4), rng_k,
             {"range_decode": range_chunks})):
        for k, v in run_path(torch, kt, K, label, data, reps, kw, kernels,
                             limits).items():
            main_launches[k] += v
    print(f"ANS host route (order-1 chunks of 2-3 bytes): "
          f"{ans_device.counts['host_route']} blocks", flush=True)
    phase_s["slice"] = time.perf_counter() - t_phase

    # -- 4. the CLI, the stream API and the host striping ------------------
    print("== cli", flush=True)
    t_phase = time.perf_counter()
    for k, v in cli_phase(torch, kt, K, corpus, short, range_chunks).items():
        main_launches[k] += v
    phase_s["cli"] = time.perf_counter() - t_phase

    # -- 5. compress_step on the real blocks and lanes ---------------------
    print("== compress_step", flush=True)
    t_phase = time.perf_counter()
    handles = engine.dispatch_many(posts4)
    writer_words, writer_nbits = handles[0][4].get()
    K.reset_counts()
    histos, ent, words, nbits, total = parallel.compress_step(
        raw, syms_np, lens_np, tidx_np, tables_np, device="cuda")
    torch.cuda.synchronize()
    step_launches = dict(K.launches)
    for k in ("histograms_u8", "entropy1024", "pack_lanes"):
        check(step_launches[k] > 0, f"compress_step: {k} never launched")
    # the block statistics: one fused launch, no K1 or K2 of their own
    check(step_launches["block_stats"] == step_launches["histograms_u8"]
          == step_launches["entropy1024"] == 1,
          f"compress_step: block statistics took launches {step_launches}, not one fused")
    want = np.stack([np.bincount(r, minlength=256) for r in raw])
    check(np.array_equal(histos.cpu().numpy(), want), "histograms != np.bincount")
    ent = ent.cpu().numpy()
    for i, r in enumerate(raw):
        ref = internal.first_order_entropy_1024(
            len(r), internal.compute_histogram_order0(r))
        check(abs(int(ent[i]) - ref) <= 8, f"block {i}: entropy {ent[i]} vs {ref}")
        check((ent[i] >= 973) == (ref >= 973), f"block {i}: gate disagrees")
    check(int(total.item()) == int(nbits.sum().item()), "total_bits != sum(nbits)")
    check(np.array_equal(words.cpu().numpy(), writer_words)
          and np.array_equal(nbits.cpu().numpy(), writer_nbits),
          "compress_step words != the Writer engine's")
    print(f"compress_step: {len(raw)} blocks, {len(nbits)} lanes, total_bits "
          f"{int(total.item())}, entropy1024 {ent.tolist()}, launches "
          f"{step_launches}", flush=True)

    phase_s["compress_step"] = time.perf_counter() - t_phase

    # -- 6. the device BWT and FPAQ entry points ---------------------------
    print("== bwt_fpaq", flush=True)
    t_phase = time.perf_counter()
    for k, v in bwt_fpaq(torch, K, native, raw, cuda, held, results).items():
        main_launches[k] += v
    phase_s["bwt_fpaq"] = time.perf_counter() - t_phase

    # -- 7. the mesh over cards --------------------------------------------
    print("== mesh", flush=True)
    t_phase = time.perf_counter()
    mesh_launches = mesh_phase(
        torch, kt, K, parallel, smi, corpus, short, raw,
        (syms_np, lens_np, tidx_np, tables_np),
        (histos, torch.from_numpy(ent), words, nbits, total))
    phase_s["mesh"] = time.perf_counter() - t_phase

    # -- 8. hostile and truncated streams: the decode contract ------------
    print("== robustness", flush=True)
    t_phase = time.perf_counter()
    robustness_phase(torch, kt, K, smi)
    phase_s["robustness"] = time.perf_counter() - t_phase

    # -- 9. the port's bench, small ----------------------------------------
    print("== bench", flush=True)
    t_phase = time.perf_counter()
    bench_phase(K, smi, results)
    phase_s["bench"] = time.perf_counter() - t_phase

    # -- 10. where the time of the device paths goes ----------------------
    print("== profile", flush=True)
    t_phase = time.perf_counter()
    profile_path(torch, kt, "level 2", corpus, dict(level=2, jobs=4))
    for entropy, transform in (("ANS1", "NONE"), ("RANGE", "LZ")):
        profile_path(torch, kt, entropy, short, dict(transform=transform, entropy=entropy,
                                                     block_size=BLOCK, jobs=4))
    phase_s["profile"] = time.perf_counter() - t_phase
    print(f"seconds per phase: {phase_s}", flush=True)

    kernels = []
    for name in K.KERNELS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": main_launches[name] + step_launches[name],
            "mesh_launches": mesh_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if "device_ms" in r:
            kernels[-1]["device_ms"] = r["device_ms"]
        check(kernels[-1]["launches"] > 0, f"{name}: no launch on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
