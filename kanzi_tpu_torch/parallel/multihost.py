"""Multi-host (multi-controller) block striping — the distributed half of
the reference's P3 axis.

The reference scales compression with an in-process worker pool over
independent work units (v2/app/BlockCompressor.go:543-618); SURVEY §2.8
maps P3 across *hosts* as "files partitioned across hosts/processes" and
§7.1 step 9 as per-host file striping. The KANZ block statelessness
contract (v2/Definitions.go:50-52) makes that exact: every host can encode
a contiguous stripe of blocks knowing only (stripe bytes, config), and the
stream is reassembled by bit-splicing stripes in rank order behind a
header written once by rank 0 — byte-identical to a single-host Writer.

Two layers, so any launcher (mpirun, SLURM, k8s indexed jobs, or plain
subprocesses) can drive it:

- library: `stripe_range` / `encode_stripe` / `pack_stripe` /
  `unpack_stripe` / `assemble`. A rank ships its packed stripe (opaque
  bytes) to the assembler over any transport.
- CLI: `python -m kanzi_tpu_torch.parallel.multihost --rank R --world W ...`
  (rank/world may also come from KANZI_RANK / KANZI_WORLD env vars, the
  convention torchrun-style launchers provide) writes
  `<out>.stripe<R>`; `--assemble` splices `<out>.stripe*` into the final
  stream.

Stripes are interchangeable with kanzi_tpu's: the same KZST magic and
layout, so a stripe packed by either package assembles in the other.

This is the host-C++ path, as in kanzi_tpu: it takes no `device`, and its
Writers run with device=None. Blocks striped over CUDA cards (the mesh,
ROADMAP.md, section 1, item 3) compose with it per host.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import native
from ..kio import Writer

_STRIPE_MAGIC = b"KZST"  # stripe container: magic, version, frame count


def stripe_range(total_size: int, block_size: int, rank: int,
                 world: int) -> tuple[int, int]:
    """Byte range [start, end) of `rank`'s contiguous block stripe.

    Blocks are distributed as evenly as possible: the first
    (nblocks % world) ranks take one extra block, so a non-divisible block
    count never leaves a rank idle while another holds two spare blocks.
    """
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    nblocks = (total_size + block_size - 1) // block_size
    base, extra = divmod(nblocks, world)
    first = rank * base + min(rank, extra)
    count = base + (1 if rank < extra else 0)
    start = min(first * block_size, total_size)
    end = min((first + count) * block_size, total_size)
    return (start, max(start, end))


def encode_stripe(stripe: bytes | np.ndarray, transform: str, entropy: str,
                  block_size: int, checksum: int = 0,
                  ctx: dict | None = None) -> list[tuple[bytes, int]]:
    """Encode one rank's stripe into frames [(payload_bytes, bits), ...].

    `stripe` must start on a block boundary of the overall input (use
    `stripe_range`). Encodes through the Writer's own one-shot block
    method, so the frames are bit-identical to the ones a single-host run
    would produce for these blocks (one encode convention, one place).
    """
    if not native.available():
        raise RuntimeError("multi-host striping requires the native runtime")
    # a throwaway Writer resolves chain/entropy ids and normalized ctx
    # exactly like the single-host path (including bsVersion)
    w = Writer(None, transform=transform, entropy=entropy,
               block_size=block_size, checksum=checksum,
               ctx=dict(ctx) if ctx else None, device=None)
    w._size_slots(1)  # one scratch buffer, reused block after block
    data = np.frombuffer(stripe, dtype=np.uint8) \
        if not isinstance(stripe, np.ndarray) else stripe
    frames: list[tuple[bytes, int]] = []
    for off in range(0, len(data), block_size):
        block = np.ascontiguousarray(data[off:off + block_size])
        scratch, bits = w._encode_one_native(block)
        frames.append((scratch[: (bits + 7) >> 3].tobytes(), bits))
    return frames


def _norm_cfg(transform: str, entropy: str) -> tuple[str, str]:
    """Registry-normalized names, so worker and assembler spellings of the
    same config always compare equal."""
    from .. import entropy as entropy_mod
    from .. import transforms as transforms_mod
    return (transforms_mod.get_name(transforms_mod.get_type(transform)),
            entropy_mod.get_name(entropy_mod.get_type(entropy)))


def _pack_cfg(transform: str, entropy: str, block_size: int,
              checksum: int) -> bytes:
    transform, entropy = _norm_cfg(transform, entropy)
    t, e = transform.encode(), entropy.encode()
    return struct.pack("<IBH", block_size, checksum & 0xFF, len(t)) + t + \
        struct.pack("<H", len(e)) + e


def pack_stripe(frames: list[tuple[bytes, int]], transform: str = "NONE",
                entropy: str = "NONE", block_size: int = 0,
                checksum: int = 0) -> bytes:
    """Serialize a rank's frames into an opaque transportable blob. The
    codec config rides along so `assemble` can hard-fail on a worker/
    assembler mismatch instead of silently writing a stream whose header
    disagrees with its frames."""
    out = bytearray(_STRIPE_MAGIC)
    out += _pack_cfg(transform, entropy, block_size, checksum)
    out += struct.pack("<I", len(frames))
    for payload, bits in frames:
        out += struct.pack("<QI", bits, len(payload))
        out += payload
    return bytes(out)


def unpack_stripe(blob: bytes) -> tuple[list[tuple[bytes, int]], dict]:
    if blob[:4] != _STRIPE_MAGIC:
        raise ValueError("not a KZST stripe")
    pos = 4
    block_size, checksum, tl = struct.unpack_from("<IBH", blob, pos)
    pos += 7
    transform = blob[pos:pos + tl].decode()
    pos += tl
    (el,) = struct.unpack_from("<H", blob, pos)
    pos += 2
    entropy = blob[pos:pos + el].decode()
    pos += el
    (nframes,) = struct.unpack_from("<I", blob, pos)
    pos += 4
    frames = []
    for _ in range(nframes):
        bits, plen = struct.unpack_from("<QI", blob, pos)
        pos += 12
        frames.append((blob[pos:pos + plen], bits))
        pos += plen
    if pos != len(blob):
        raise ValueError("trailing bytes in stripe")
    return frames, {"transform": transform, "entropy": entropy,
                    "blockSize": block_size, "checksum": checksum}


def assemble(stripes: list[bytes], transform: str, entropy: str,
             block_size: int, total_size: int, checksum: int = 0,
             ctx: dict | None = None) -> bytes:
    """Splice packed stripes (in rank order) into the final stream.

    Rank 0's role: the header is written once here (with the full input
    size, so the header is identical to a single-host run), then every
    frame is bit-spliced in block order and the zero-length end marker
    closes the stream — the cross-host form of the reference's ordered
    append (P2, v2/io/CompressedStream.go:934-949).
    """
    w = Writer(None, transform=transform, entropy=entropy,
               block_size=block_size, checksum=checksum,
               file_size=total_size, ctx=dict(ctx) if ctx else None,
               device=None)
    nt, ne = _norm_cfg(transform, entropy)
    want = {"transform": nt, "entropy": ne,
            "blockSize": block_size, "checksum": checksum & 0xFF}
    w._write_header()
    nblocks = 0
    for rank, blob in enumerate(stripes):
        frames, cfg = unpack_stripe(blob)
        if cfg != want:
            raise ValueError(
                f"stripe {rank} was encoded with {cfg}, assemble invoked "
                f"with {want}: the stream header would disagree with its "
                f"frames")
        for payload, bits in frames:
            w._append_frame(np.frombuffer(payload, dtype=np.uint8), bits)
            nblocks += 1
    w._block_id = nblocks
    w.close()
    return w.getvalue()


def compress_multihost(data: bytes, transform: str = "NONE",
                       entropy: str = "NONE",
                       block_size: int = 4 * 1024 * 1024, world: int = 2,
                       checksum: int = 0, ctx: dict | None = None) -> bytes:
    """In-process reference implementation of the full rank protocol
    (every rank executed locally, in sequence). The tests and the
    subprocess dryrun both check against this AND against the
    single-process Writer."""
    stripes = []
    for rank in range(world):
        s, e = stripe_range(len(data), block_size, rank, world)
        stripes.append(pack_stripe(
            encode_stripe(data[s:e], transform, entropy, block_size,
                          checksum, ctx),
            transform, entropy, block_size, checksum))
    return assemble(stripes, transform, entropy, block_size, len(data),
                    checksum, ctx)


def decode_stripe(blob: bytes, rank: int, world: int) -> bytes:
    """Decode rank's contiguous frame span of a KANZ stream (the decode
    side of P3: every rank reads the whole stream's frame table — cheap,
    no payload work — then decodes only its stripe of blocks)."""
    from ..kio import frame_table

    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    frames, r = frame_table(blob)
    nblocks = len(frames)
    base, extra = divmod(nblocks, world)
    first = rank * base + min(rank, extra)
    count = base + (1 if rank < extra else 0)
    span = frames[first:first + count]
    src = np.frombuffer(blob, dtype=np.uint8)
    out = bytearray()
    dst = np.empty(r.block_size, dtype=np.uint8)
    for pos, _bid in span:
        n = native.block_decode(src, pos >> 3, pos & 7, r.transform_type,
                                r.entropy_type, dict(r.ctx), r.checksum_bits,
                                r.block_size, dst, 0, r.block_size)
        out += dst[:n].tobytes()
    return bytes(out)


def decompress_multihost(blob: bytes, world: int = 2) -> bytes:
    """In-process reference implementation of the decode rank protocol:
    every rank's stripe decoded locally, concatenated in rank order —
    byte-identical to the single-process Reader (tested)."""
    return b"".join(decode_stripe(blob, rank, world)
                    for rank in range(world))


def _env_int(name: str, default: int | None = None) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def main(argv: list[str] | None = None) -> int:
    """Launcher entry point.

    Worker mode (one invocation per rank, any process launcher):
        python -m kanzi_tpu_torch.parallel.multihost -i IN -o OUT \
            --rank R --world W [--transform T --entropy E --block-size B
                                --checksum C]
      (rank/world default to $KANZI_RANK / $KANZI_WORLD) → writes
      OUT.stripe{R:05d}

    Assemble mode (after all ranks finish, e.g. on rank 0 / shared fs):
        python -m kanzi_tpu_torch.parallel.multihost --assemble -i IN -o OUT ...
      → splices OUT.stripe* (rank order) into OUT.

    Decode striping (-d): each rank walks the frame table (serial, no
    payload work) and decodes its contiguous block span to
    OUT.dstripe{R:05d}; `-d --assemble` concatenates the stripes in rank
    order — byte-identical to the single-process Reader.
    """
    import argparse

    ap = argparse.ArgumentParser(prog="kanzi_tpu_torch.parallel.multihost")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("--rank", type=int, default=_env_int("KANZI_RANK"))
    ap.add_argument("--world", type=int, default=_env_int("KANZI_WORLD"))
    ap.add_argument("--assemble", action="store_true")
    ap.add_argument("--transform", default="NONE")
    ap.add_argument("--entropy", default="NONE")
    ap.add_argument("--block-size", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--checksum", type=int, default=0)
    args = ap.parse_args(argv)

    if args.decompress:
        if args.assemble:
            if args.world is None:
                raise SystemExit("--assemble requires --world (stripe count)")
            with open(args.output, "wb") as out_fh:
                for rank in range(args.world):
                    with open(f"{args.output}.dstripe{rank:05d}", "rb") as fh:
                        out_fh.write(fh.read())
            return 0
        if args.rank is None or args.world is None:
            raise SystemExit("worker mode requires --rank/--world "
                             "(or KANZI_RANK/KANZI_WORLD)")
        with open(args.input, "rb") as fh:
            blob = fh.read()
        stripe = decode_stripe(blob, args.rank, args.world)
        with open(f"{args.output}.dstripe{args.rank:05d}", "wb") as fh:
            fh.write(stripe)
        return 0

    total_size = os.path.getsize(args.input)
    if args.assemble:
        if args.world is None:
            raise SystemExit("--assemble requires --world (stripe count)")
        stripes = []
        for rank in range(args.world):
            path = f"{args.output}.stripe{rank:05d}"
            with open(path, "rb") as fh:
                stripes.append(fh.read())
        data = assemble(stripes, args.transform, args.entropy,
                        args.block_size, total_size, args.checksum)
        with open(args.output, "wb") as fh:
            fh.write(data)
        return 0

    if args.rank is None or args.world is None:
        raise SystemExit("worker mode requires --rank/--world "
                         "(or KANZI_RANK/KANZI_WORLD)")
    s, e = stripe_range(total_size, args.block_size, args.rank, args.world)
    with open(args.input, "rb") as fh:
        fh.seek(s)
        stripe = fh.read(e - s)
    frames = encode_stripe(stripe, args.transform, args.entropy,
                           args.block_size, args.checksum)
    with open(f"{args.output}.stripe{args.rank:05d}", "wb") as fh:
        fh.write(pack_stripe(frames, args.transform, args.entropy,
                             args.block_size, args.checksum))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
