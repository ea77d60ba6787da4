"""Block data-parallelism over CUDA cards, the fused compress step, and the
host striping.

The counterpart of kanzi_tpu/parallel/__init__.py. One process drives every
card of a `Mesh`, as kanzi_tpu's single-controller jax Mesh does: the rows
of each launch split into contiguous shares, one a shard; the tables are
copied to every shard's card; each shard runs the ported kernel (K3-K8
through ops/) on its share, on a CUDA stream of its own; the outputs gather
to the host in row order, and the frames splice in block order, so a mesh
stream equals the single-card stream byte for byte at any card count.
`compress_step` runs per shard the fused block statistics
(ops.block_stats.block_stats, the counterpart of kanzi_tpu's
block_stats_pallas) and the Huffman lane pack, and reduces the per-card
payload bit totals onto the mesh's first card (kanzi_tpu's psum, the one
collective).

Three faults of kanzi_tpu's mesh are not copied: a RANGE Writer on the mesh
gets a launch of its own (kanzi_tpu installs the ANS launch and raises);
a failing mesh decode raises (kanzi_tpu's entropy.decode falls back to the
host decoder); and device_mesh raises when it cannot have the cards asked
for (kanzi_tpu shrinks the mesh).

compress_multiproc/decompress_multiproc (parallel.multiproc) and
parallel.multihost stripe blocks over processes and hosts on the host C++
engine, as kanzi_tpu's do; they take no device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..entropy import device_io
from ..ops import ans as ops_ans, block_stats, huffman as ops_huffman
from ..ops import range as ops_range
from ..ops.state import to_port_state


class NoDeviceEngine(RuntimeError):
    """No device entropy kernel exists for the requested entropy type
    (NONE and the bit-serial binary context models run on the host C++
    engine by design, as in kanzi_tpu)."""


def compress_multiproc(*args, **kwargs):
    """Multi-process block compression (see parallel.multiproc)."""
    from .multiproc import compress_multiproc as _impl
    return _impl(*args, **kwargs)


def decompress_multiproc(*args, **kwargs):
    """Multi-process block decompression (see parallel.multiproc)."""
    from .multiproc import decompress_multiproc as _impl
    return _impl(*args, **kwargs)


class Mesh:
    """A 1-D mesh over the 'blocks' axis: `devices`, one a shard, and
    `size`.

    Cards are "cuda:i" (a bare "cuda" is the current card). A card may be
    listed more than once: several shards on one card, each on its own
    stream, which runs the split and the gather with the real kernels on
    one card (a test aid: it makes no multi-card claim). "cpu" devices run
    the kernels' plain versions, for the tests."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            dev = _kernels.resolve_device(d)
            if dev is None:
                raise ValueError("a mesh device is a card ('cuda:i') or 'cpu'")
            if dev.type == "cuda":
                index = torch.cuda.current_device() if dev.index is None else dev.index
                if index >= torch.cuda.device_count():
                    raise RuntimeError(f"cuda:{index} was requested but "
                                       f"{torch.cuda.device_count()} card(s) are present")
                dev = torch.device("cuda", index)
            devs.append(dev)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh's devices are all cards or all 'cpu'")
        self.devices = tuple(devs)
        self.size = len(devs)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def shares(self, rows: int) -> list:
        """[lo, hi) of each shard's rows: contiguous shares of
        ceil(rows / size), the boundaries of kanzi_tpu's split of rows
        padded to the device count; the last shares may be short or
        empty."""
        share = -(-rows // self.size)
        return [(min(i * share, rows), min((i + 1) * share, rows))
                for i in range(self.size)]

    def streams(self) -> tuple:
        """A new CUDA stream for each shard (None for a 'cpu' device)."""
        return tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                     for d in self.devices)


def device_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh over the first `n_devices` cards (every card by default), or
    `n_devices` "cpu" devices (1 by default) for the tests. Raises when
    there is no card, or fewer cards than asked for: the mesh never
    shrinks."""
    dev = _kernels.resolve_device(device)
    if dev is None:
        raise ValueError("device_mesh needs a device: 'cuda' or 'cpu'")
    if dev.type == "cpu":
        n = 1 if n_devices is None else n_devices
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(f"a mesh of {n} cards was requested but "
                               f"{count} card(s) are present")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return Mesh([torch.device(dev.type, i) if dev.type == "cuda" else dev
                 for i in range(n)])


def _launch_rows(mesh: Mesh, streams, rows: dict, tables: dict,
                 kernel) -> device_io.MeshResult:
    """kernel(state) -> output tensors, once for each shard with rows, on
    its device and stream: the numpy `rows` split along their first axis
    and the numpy `tables` copied whole, carried there by to_port_state.
    A shard with no rows launches nothing. The result gathers the shards'
    outputs in row order."""
    n = len(next(iter(rows.values())))
    if n == 0:
        raise ValueError("a sharded launch needs at least one row")
    parts = []
    for dev, stream, (lo, hi) in zip(mesh.devices, streams, mesh.shares(n)):
        if lo == hi:
            continue

        def run(dev=dev, lo=lo, hi=hi):
            st = to_port_state({**{k: v[lo:hi] for k, v in rows.items()}, **tables}, dev)
            return st, kernel(st)

        parts.append(device_io.launch(stream, run))
    return device_io.MeshResult(parts)


def shard_pack_lanes(mesh: Mesh):
    """K3 over the mesh: fn(syms, lane_len, table_idx, tables) (numpy, as
    ops.huffman.pack_lanes takes them) -> MeshResult of (words, nbits).
    Lane rows split; the code tables are copied to every shard whole, and
    table_idx stays a global index into them (not rebased per shard). A
    lane's nbits -1 (the kernel's table index flag) gathers with its
    row."""
    streams = mesh.streams()

    def pack(syms, lane_len, table_idx, tables):
        return _launch_rows(
            mesh, streams, {"syms": syms, "lane_len": lane_len, "table_idx": table_idx},
            {"tables": tables},
            lambda st: ops_huffman.pack_lanes(st["syms"], st["lane_len"],
                                              st["table_idx"], st["tables"]))
    return pack


def shard_ans_encode(mesh: Mesh):
    """K5 over the mesh: fn(syms, ngroups, tables) (numpy, as
    ops.ans.encode_chunks takes them) -> MeshResult of (pairs, npairs,
    states). Chunk rows, with their group counts and tables, split."""
    streams = mesh.streams()

    def encode(syms, ngroups, tables):
        return _launch_rows(
            mesh, streams, {"ans_syms": syms, "ngroups": ngroups, "ans_tables": tables}, {},
            lambda st: ops_ans.encode_chunks(st["ans_syms"], st["ngroups"],
                                             st["ans_tables"]))
    return encode


def shard_range_encode(mesh: Mesh):
    """K7 over the mesh: fn(syms, nvalid, tables, shifts) (numpy, as
    ops.range.encode_chunks takes them) -> MeshResult of (words, nwords,
    lows). Chunk rows, with their lengths, tables and shifts, split.
    kanzi_tpu has no counterpart: its mesh Writer cannot encode RANGE."""
    streams = mesh.streams()

    def encode(syms, nvalid, tables, shifts):
        return _launch_rows(
            mesh, streams,
            {"rng_syms": syms, "nvalid": nvalid, "rng_tables": tables, "shifts": shifts},
            {}, lambda st: ops_range.encode_chunks(st["rng_syms"], st["nvalid"],
                                                   st["rng_tables"], st["shifts"]))
    return encode


def shard_huffman_decode(mesh: Mesh):
    """K4 over the mesh, as a Reader's Huffman hook: fn(batch) with a
    batch's stacked {lanes, table_idx, dtables} numpy rows -> (symbols,
    the kernel's table index flags) as numpy, in row order
    (huffman_device.decode_rows' contract). Lanes, their table indexes and
    their flags split; the decode tables are copied to every shard whole."""
    streams = mesh.streams()

    def run(st):
        bad = torch.empty(len(st["lanes"]), dtype=torch.int32, device=st["lanes"].device)
        return ops_huffman.decode_lanes(st["lanes"], st["table_idx"], st["dtables"],
                                        bad), bad

    def decode(batch):
        return _launch_rows(mesh, streams,
                            {"lanes": batch["lanes"], "table_idx": batch["table_idx"]},
                            {"dtables": batch["dtables"]}, run).get()
    return decode


def mesh_decode_hooks(mesh: Mesh) -> dict:
    """The mesh's decode launches for a Reader's ctx["deviceDecodeHooks"]:
    {"huffman": shard_huffman_decode(mesh), "ans": fn(batch, order, glen)
    -> (symbols, nread)}, K6 with the chunk rows (streams, byte counts,
    states, f2s, decode tables, group counts, logRanges) split, each
    shard's scratch sized for its own rows by the wrapper
    (ans_device.decode_rows' contract). The batched (jobs > 1) and the
    per-block Reader both take them. RANGE has no hook, as in kanzi_tpu:
    a mesh Reader decodes RANGE on its own card, the mesh's first. The
    hooks are per-Reader state with streams of their own, so concurrent
    mesh Readers in one process are independent. A hook that fails raises
    under its block's id; nothing is retried on the host."""
    streams = mesh.streams()

    def ans(batch, order, glen):
        return _launch_rows(
            mesh, streams, batch, {},
            lambda st: ops_ans.decode_chunks(st["bufs"], st["nbytes"], st["states0"],
                                             st["f2s"], st["dtabs"], st["ngroups"],
                                             st["lr"], order, glen, host=True)).get()

    return {"huffman": shard_huffman_decode(mesh), "ans": ans}


def mesh_writer(mesh: Mesh, **writer_kwargs):
    """A one-shot Writer (output None) on the mesh's first card whose
    device entropy engine launches over the mesh: each batch's lane or
    chunk rows split over the shards (one launch a shard with rows), the
    tables copied to every shard, the results gathered to the host for the
    ordered frame splice. The launch is chosen by the engine's class:
    HUFFMAN K3, ANS0 and ANS1 K5, RANGE K7. Raises NoDeviceEngine for an
    entropy type with no device engine."""
    from ..entropy.ans_device import DeviceANSEngine
    from ..entropy.huffman_device import DeviceHuffmanEngine
    from ..entropy.range_device import DeviceRangeEngine
    from ..kio import Writer

    w = Writer(None, device=mesh.devices[0], **writer_kwargs)
    eng = w._dev_engine
    if eng is None:
        raise NoDeviceEngine(
            f"no device engine for entropy {w.ctx['entropy']}")
    if isinstance(eng, DeviceHuffmanEngine):
        eng._launch = shard_pack_lanes(mesh)
    elif isinstance(eng, DeviceANSEngine):
        ans = shard_ans_encode(mesh)
        eng._launch = lambda b: ans(b["ans_syms"], b["ngroups"], b["ans_tables"])
    elif isinstance(eng, DeviceRangeEngine):
        rng = shard_range_encode(mesh)
        eng._launch = lambda b: rng(b["rng_syms"], b["nvalid"], b["rng_tables"],
                                    b["shifts"])
    else:
        raise TypeError(f"no mesh launch for {type(eng).__name__}")
    return w


def compress_multichip(data, mesh: Mesh, transform: str = "LZ",
                       entropy: str = "HUFFMAN", block_size: int = 1 << 20,
                       checksum: int = 0, **writer_kwargs) -> bytes:
    """Compress `data` with the entropy stage over the mesh (mesh_writer):
    host transforms and tables, sharded entropy kernels, ordered frame
    splice, byte-identical to the single-card and the host C++ streams.
    `jobs` (blocks a batch) defaults to the mesh's size. Entropy types with
    no device engine take the host C++ Writer with that many jobs instead,
    as in kanzi_tpu; that is the only route away from the mesh, and any
    failure of a card or a launch raises."""
    from ..kio import Writer

    kw = dict(transform=transform, entropy=entropy, block_size=block_size,
              checksum=checksum, file_size=len(data))
    kw.update(writer_kwargs)
    kw.setdefault("jobs", mesh.size)
    try:
        w = mesh_writer(mesh, **kw)
    except NoDeviceEngine:
        w = Writer(None, device=None, **kw)
    w.write(data)
    w.close()
    return w.getvalue()


def decompress_multichip(blob, mesh: Mesh) -> bytes:
    """Decode a KANZ stream with a Reader on the mesh's first card, `jobs`
    = the mesh's size, its HUFFMAN and ANS decodes through the mesh's hooks
    (mesh_decode_hooks); byte-identical to the single-card decode."""
    from ..kio import Reader

    r = Reader(bytes(blob), jobs=max(1, mesh.size), device=mesh.devices[0],
               ctx={"deviceDecodeHooks": mesh_decode_hooks(mesh)})
    try:
        return r.read_all()
    finally:
        r.close()


def _step_mesh(mesh: Mesh, named: dict):
    """compress_step over the mesh, on numpy inputs: per shard, the fused
    block statistics of its block rows and the lane pack of its lane rows
    (the code tables copied whole), each on its card and stream; then
    every card's current stream waits for its shards, the outputs gather
    on the mesh's first card in row order, and the per-shard int64 totals
    reduce onto it (torch.cuda.comm.reduce_add: NCCL across distinct
    cards; on the CPU a plain sum)."""
    nblocks, nlanes = len(named["blocks"]), len(named["syms"])
    if not (nblocks and nlanes):
        raise ValueError("compress_step on a mesh needs at least one block and one lane")
    dev0 = mesh.devices[0]
    parts = []
    for dev, stream, (b0, b1), (l0, l1) in zip(
            mesh.devices, mesh.streams(), mesh.shares(nblocks), mesh.shares(nlanes)):
        out = {}
        with device_io.on(stream):
            if b1 > b0:
                st = to_port_state({"blocks": named["blocks"][b0:b1]}, dev)
                out["histos"], out["ent"] = block_stats.block_stats(st["blocks"])
            if l1 > l0:
                st = to_port_state({"syms": named["syms"][l0:l1],
                                    "lane_len": named["lane_len"][l0:l1],
                                    "table_idx": named["table_idx"][l0:l1],
                                    "tables": named["tables"]}, dev)
                out["words"], out["nbits"] = ops_huffman.pack_lanes(
                    st["syms"], st["lane_len"], st["table_idx"], st["tables"])
                out["total"] = torch.sum(out["nbits"], dtype=torch.int64)
        if stream is not None and out:
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(stream)
            for t in out.values():
                t.record_stream(cur)
        parts.append(out)

    def gather(key):
        return torch.cat([o[key].to(dev0) for o in parts if key in o])

    totals = [o["total"] for o in parts if "total" in o]
    if dev0.type == "cuda":
        from torch.cuda import comm
        total = comm.reduce_add(totals, destination=dev0.index)
    else:
        total = torch.stack(totals).sum()
    return gather("histos"), gather("ent"), gather("words"), gather("nbits"), total


def compress_step(blocks, lane_syms, lane_len, table_idx, tables,
                  device="cuda", mesh: Mesh | None = None):
    """(blocks (B,N) u8, lane_syms (L,FRAG) u8/i32, lane_len (L,) i32,
    table_idx (L,) i32, tables (C,256) (len<<12)|code)
    -> (histos (B,256) i32, entropy1024 (B,) i32, words (L,nwords) i32,
    nbits (L,) i32, total_bits () i64), all on `device`.

    Numpy inputs are carried to `device` with to_port_state; tensors must
    already lie there in the kernels' dtypes. With a `mesh` (which takes
    the place of `device`) the inputs are numpy arrays, the block rows and
    the lane rows split over its shards, each shard makes one fused
    block-statistics launch and one lane-pack launch, and the outputs
    gather, and the total reduces, on the mesh's first device
    (_step_mesh). A table_idx outside [0, C) raises ValueError on either
    device (on the card, from the kernel's nbits -1, read once the step is
    done)."""
    named = {"blocks": blocks, "syms": lane_syms, "lane_len": lane_len,
             "table_idx": table_idx, "tables": tables}
    if mesh is not None:
        if not all(isinstance(v, np.ndarray) for v in named.values()):
            raise TypeError("compress_step on a mesh takes numpy arrays")
        histos, ent, words, nbits, total = _step_mesh(mesh, named)
    else:
        device = _kernels.resolve_device(device)
        if device is None:
            raise ValueError("compress_step runs on a device: pass 'cuda' or 'cpu'")
        host = {k: v for k, v in named.items() if isinstance(v, np.ndarray)}
        named.update(to_port_state(host, device))
        histos, ent = block_stats.block_stats(named["blocks"])
        words, nbits = ops_huffman.pack_lanes(named["syms"], named["lane_len"],
                                              named["table_idx"], named["tables"])
        total = torch.sum(nbits, dtype=torch.int64)
    if bool((nbits < 0).any()):
        raise ValueError(f"table_idx: values outside [0, {tables.shape[0]})")
    return histos, ent, words, nbits, total


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def _dryrun_corpus(n: int) -> bytes:
    rng = np.random.default_rng(7)
    text = (b"multi chip dry run: the quick brown fox jumps over the lazy "
            b"dog 0123456789 " * 64)
    parts = []
    while sum(map(len, parts)) < n:
        parts.append(text)
        parts.append(rng.integers(0, 256, 8192, dtype=np.uint8).tobytes())
        parts.append(rng.integers(0, 8, 16384, dtype=np.uint8).tobytes())
        parts.append(bytes(4096))
    return b"".join(parts)[:n]


# kanzi_tpu's six dry-run configs (label, transform, entropy, checksum
# bits): the level 1, 5 and 8 presets (fast LZ, BWT, a context model on the
# host engine inside the mesh Writer) and the device engines' HUFFMAN, ANS0
# and ANS1; and a seventh, RANGE, which kanzi_tpu's mesh cannot encode
DRYRUN_CONFIGS = (
    ("L1", "LZX", "NONE", 32),
    ("huffman-mesh", "LZ", "HUFFMAN", 32),
    ("ans0-mesh", "NONE", "ANS0", 32),
    ("ans1-mesh", "NONE", "ANS1", 32),
    ("L5", "TEXT+UTF+BWT+RANK+ZRLT", "ANS0", 64),
    ("L8", "EXE+RLT+TEXT+UTF+DNA", "TPAQ", 32),
    ("range-mesh", "LZ", "RANGE", 32),
)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-card compression path end to end on a mesh of `n_devices`
    (device_mesh(n_devices, device)): a mixed corpus of several blocks of
    256 KiB through compress_multichip in every config of DRYRUN_CONFIGS,
    each stream checked byte for byte against compress(..., device=None)
    (the host C++ stream) and decoded both by the host and through
    decompress_multichip; then compress_step on the mesh, its reduced
    total checked against the sum of its lane bit counts. Raises at the
    first difference."""
    import kanzi_tpu_torch as kt

    mesh = device_mesh(n_devices, device)
    corpus = _dryrun_corpus(max(n_devices, 4) * (1 << 18) + 12345)
    for label, transform, entropy, cksum in DRYRUN_CONFIGS:
        kw = dict(transform=transform, entropy=entropy, block_size=1 << 18,
                  checksum=cksum)
        blob = compress_multichip(corpus, mesh, **kw)
        _check(blob == kt.compress(corpus, device=None, **kw),
               f"{label} ({transform}&{entropy}): mesh stream != host stream")
        _check(kt.decompress(blob, device=None) == corpus, f"{label}: host decode != input")
        _check(decompress_multichip(blob, mesh) == corpus, f"{label}: mesh decode != input")
        print(f"dryrun_multichip[{label}]: {transform}&{entropy} byte-identical "
              f"both directions on {mesh}", flush=True)

    # the reduction (kanzi_tpu's psum over the mesh)
    B, N, frag = 2 * mesh.size, 1024, 256
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 64, (B, N), dtype=np.uint8)
    L = 4 * B
    syms = np.zeros((L, frag), dtype=np.int32)
    syms[:, :N // 4] = blocks.repeat(4, axis=0)[:, :N // 4]
    lane_len = np.full(L, N // 4, dtype=np.int32)
    table_idx = np.arange(L, dtype=np.int32) // 4 % 2
    tables = np.full((2, 256), (8 << 12) | 0x55, dtype=np.int32)
    *_, nbits, total = compress_step(blocks, syms, lane_len, table_idx, tables,
                                     mesh=mesh)
    _check(int(total) == int(nbits.sum()), "compress_step total != sum(nbits)")
    print(f"dryrun_multichip: compress_step total {int(total)} bits on {mesh}",
          flush=True)


def dryrun_multihost(world: int) -> None:
    """`world` OS processes through the multihost launcher (`python -m
    kanzi_tpu_torch.parallel.multihost`, one worker a rank, then the
    assembly): the spliced stream must equal compress(..., device=None)
    and decode both whole and in rank stripes; then the level 1, 5 and 8
    presets through compress_multihost/decompress_multihost in process.
    The host C++ path; raises at the first difference."""
    import os
    import subprocess
    import sys
    import tempfile

    import kanzi_tpu_torch as kt

    from . import multihost

    rng = np.random.default_rng(11)
    block_size = 65536
    n = block_size * 10 + 12345     # 11 blocks: uneven over 2, 4 or 8 ranks
    text = (b"multihost dryrun corpus -- mixed text segment. " * 4096)[: n // 2]
    data = text + rng.integers(0, 256, n - len(text), dtype=np.uint8).tobytes()
    cfg = dict(transform="LZ", entropy="HUFFMAN", block_size=block_size, checksum=32)
    single = kt.compress(data, device=None, **cfg)
    _check(multihost.compress_multihost(data, world=world, **cfg) == single,
           "in-process multihost stream != single-process stream")

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as td:
        inp, out = os.path.join(td, "input.bin"), os.path.join(td, "output.knz")
        with open(inp, "wb") as fh:
            fh.write(data)
        args = [sys.executable, "-m", "kanzi_tpu_torch.parallel.multihost",
                "-i", inp, "-o", out, "--transform", "LZ", "--entropy", "HUFFMAN",
                "--block-size", str(block_size), "--checksum", "32"]
        procs = [subprocess.Popen(args, cwd=root, env=dict(
            os.environ, KANZI_RANK=str(r), KANZI_WORLD=str(world))) for r in range(world)]
        rcs = [p.wait() for p in procs]
        _check(rcs == [0] * world, f"rank exit codes {rcs}")
        rc = subprocess.run(args + ["--assemble", "--world", str(world)],
                            cwd=root).returncode
        _check(rc == 0, f"assemble exit code {rc}")
        with open(out, "rb") as fh:
            spliced = fh.read()
    _check(spliced == single, "launcher multihost stream != single-process stream")
    _check(kt.decompress(spliced, device=None) == data, "multihost stream decode != input")
    _check(multihost.decompress_multihost(spliced, world=world) == data,
           "multihost decode stripes != input")
    print(f"dryrun_multihost({world}): {world} rank processes, 11 blocks, "
          "byte-identical both directions", flush=True)

    for level in (1, 5, 8):
        transform, entropy = kt.LEVEL_PRESETS[level]
        lcfg = dict(transform=transform, entropy=entropy, block_size=block_size,
                    checksum=32)
        lblob = multihost.compress_multihost(data, world=world, **lcfg)
        _check(lblob == kt.compress(data, device=None, **lcfg),
               f"L{level}: multihost stream != single-process stream")
        _check(multihost.decompress_multihost(lblob, world=world) == data,
               f"L{level}: multihost decode stripes != input")
        print(f"dryrun_multihost[L{level}]: {transform}&{entropy} byte-identical "
              f"both directions at world={world}", flush=True)
