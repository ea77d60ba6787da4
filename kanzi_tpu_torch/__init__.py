"""kanzi_tpu_torch — the kanzi_tpu codec on PyTorch and CUDA (NVIDIA Hopper).

Streams are byte-identical to kanzi_tpu's (KANZ bitstream v6). The layers:

- `kanzi_tpu_torch.ops`      — CUDA kernels (csrc/, built with nvcc for
                               sm_90a at first use) behind wrappers that
                               carry each kernel's plain PyTorch version
- `kanzi_tpu_torch.entropy`  — entropy registry; the device Huffman, rANS
                               (ANS0/ANS1) and range engines
- `kanzi_tpu_torch.parallel` — the fused device compress step
- `kanzi_tpu_torch.native`   — C++ host runtime for the bit-serial loops
                               (transforms, table prep, frame splice)
- `kanzi_tpu_torch.kio`      — the KANZ v6 stream container (Writer/Reader)

Every entry point takes `device`: "cuda" (the default) runs the kernels and
raises without a card, "cpu" runs their plain PyTorch versions, None runs
the host C++ engine throughout. The entropy stages of levels 2, 3 (HUFFMAN)
and 5 (ANS0), and the ANS1 and RANGE codecs, run on the device; the other
codecs run on the host C++ engine on every path.

    >>> import kanzi_tpu_torch
    >>> blob = kanzi_tpu_torch.compress(data, level=5)
    >>> assert kanzi_tpu_torch.decompress(blob) == data
"""

from __future__ import annotations

import io as _io


def _tune_allocator() -> None:
    """Keep large allocations in the (warm) heap instead of fresh mmaps.

    glibc serves blocks above M_MMAP_THRESHOLD from anonymous mmaps and
    munmaps them on free, so every multi-MB buffer (every `bytes` of a block,
    every numpy scratch) pays the full page-fault cost again. Raising the
    threshold and disabling trim makes the heap grow once and stay warm.
    """
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
        libc.mallopt(-2, 1 << 24)   # M_TOP_PAD
    except Exception:
        pass  # non-glibc platform: defaults apply


_tune_allocator()

from .core import KanziError  # noqa: E402,F401
from .kio import Reader, Writer  # noqa: E402,F401

__version__ = "0.5.0"  # keep in sync with pyproject.toml

# Level presets: level -> (transform chain, entropy codec)
# (reference: v2/app/BlockCompressor.go:665-700)
LEVEL_PRESETS = {
    0: ("NONE", "NONE"),
    1: ("LZX", "NONE"),
    2: ("DNA+LZ", "HUFFMAN"),
    3: ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN"),
    4: ("TEXT+UTF+EXE+PACK+MM+ROLZ", "NONE"),
    5: ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0"),
    6: ("TEXT+UTF+BWT+SRT+ZRLT", "FPAQ"),
    7: ("LZP+TEXT+UTF+BWT+LZP", "CM"),
    8: ("EXE+RLT+TEXT+UTF+DNA", "TPAQ"),
    9: ("EXE+RLT+TEXT+UTF+DNA", "TPAQX"),
}

# Default block sizes per level (reference: v2/app/BlockCompressor.go:188-201)
DEFAULT_BLOCK_SIZE = 4 * 1024 * 1024


def block_size_for_level(level: int) -> int:
    if level == 6:
        return 8 * 1024 * 1024
    if level in (7, 8):
        return 16 * 1024 * 1024
    if level == 9:
        return 32 * 1024 * 1024
    return DEFAULT_BLOCK_SIZE


def compress(data, level: int | None = None, transform: str | None = None,
             entropy: str | None = None, block_size: int | None = None,
             jobs: int = 1, checksum: int = 0, headerless: bool = False,
             skip: bool = False, device="cuda") -> bytes:
    """One-shot compression to a KANZ v6 stream.

    ``skip`` enables incompressible-block detection (the CLI's ``-s``:
    magic-typed or high-entropy blocks are stored as copies — reference
    BlockCompressor ``skipBlocks``)."""
    if level is not None:
        if not 0 <= level <= 9:
            raise KanziError(f"Invalid compression level: {level}")
        transform, entropy = LEVEL_PRESETS[level]
        if block_size is None:
            block_size = block_size_for_level(level)
    transform = transform or "NONE"
    entropy = entropy or "NONE"
    block_size = block_size or DEFAULT_BLOCK_SIZE
    w = Writer(None, transform=transform, entropy=entropy, block_size=block_size,
               jobs=jobs, checksum=checksum, file_size=len(data),
               headerless=headerless,
               ctx={"skipBlocks": True} if skip else None, device=device)
    if w._os is None and not w._use_native:
        w._os = _io.BytesIO()  # legacy path needs a sink
    w.write(data)
    w.close()
    if w._os is None:
        return w.getvalue()
    return w._os.getvalue()


def decompress(data, jobs: int = 1, headerless: bool = False,
               ctx: dict | None = None, device="cuda") -> bytes:
    """One-shot decompression of a KANZ stream."""
    r = Reader(data, jobs=jobs, headerless=headerless, ctx=ctx, device=device)
    try:
        return r.read_all()
    finally:
        r.close()


def entry(device="cuda"):
    """Returns (pack_lanes, example_args) for one lane-pack step at full
    lane width, shaped like __graft_entry__.py: entry(): 8 lanes of FRAG
    random symbols over 2 code tables, as tensors on `device`."""
    import numpy as np

    from .ops import huffman as ops_huffman
    from .ops.state import to_port_state

    rng = np.random.default_rng(7)
    L, C = 8, 2
    st = to_port_state({
        "syms": rng.integers(0, 256, (L, ops_huffman.FRAG), dtype=np.int32),
        "lane_len": np.full(L, ops_huffman.FRAG, dtype=np.int32),
        "table_idx": rng.integers(0, C, L, dtype=np.int32),
        # simple 8-bit identity-ish table: (len<<12)|code
        "tables": ((8 << 12) | np.arange(256, dtype=np.int32))[None, :].repeat(C, 0),
    }, device)
    return ops_huffman.pack_lanes, (st["syms"], st["lane_len"],
                                    st["table_idx"], st["tables"])
