"""The fused device compress step on one device, and the host striping.

The single-device form of kanzi_tpu/parallel/__init__.py: compress_step
(:79-107), which runs per block the histogram + incompressibility estimate
(the copy-block heuristic) and the Huffman lane pack, and sums the payload
bits across the mesh with a psum. On the card the block statistics are one
launch of the fused kernel (ops.block_stats.block_stats, the counterpart of
kanzi_tpu's block_stats_pallas), the lane pack another. On one card the psum
is a plain sum on the device. Sharding across cards is a later slice
(ROADMAP.md).

compress_multiproc/decompress_multiproc (parallel.multiproc) and
parallel.multihost stripe blocks over processes and hosts on the host C++
engine, as kanzi_tpu's do; they take no device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..ops import block_stats, huffman as ops_huffman
from ..ops.state import to_port_state


def compress_multiproc(*args, **kwargs):
    """Multi-process block compression (see parallel.multiproc)."""
    from .multiproc import compress_multiproc as _impl
    return _impl(*args, **kwargs)


def decompress_multiproc(*args, **kwargs):
    """Multi-process block decompression (see parallel.multiproc)."""
    from .multiproc import decompress_multiproc as _impl
    return _impl(*args, **kwargs)


def compress_step(blocks, lane_syms, lane_len, table_idx, tables,
                  device="cuda"):
    """(blocks (B,N) u8, lane_syms (L,FRAG) u8/i32, lane_len (L,) i32,
    table_idx (L,) i32, tables (C,256) (len<<12)|code)
    -> (histos (B,256) i32, entropy1024 (B,) i32, words (L,nwords) i32,
    nbits (L,) i32, total_bits () i64), all on `device`.

    Numpy inputs are carried to `device` with to_port_state; tensors must
    already lie there in the kernels' dtypes. A table_idx outside [0, C)
    raises ValueError on either device (on the card, from the kernel's
    nbits -1, read once the step is done)."""
    device = _kernels.resolve_device(device)
    if device is None:
        raise ValueError("compress_step runs on a device: pass 'cuda' or 'cpu'")
    named = {"blocks": blocks, "syms": lane_syms, "lane_len": lane_len,
             "table_idx": table_idx, "tables": tables}
    host = {k: v for k, v in named.items() if isinstance(v, np.ndarray)}
    named.update(to_port_state(host, device))
    histos, ent = block_stats.block_stats(named["blocks"])
    words, nbits = ops_huffman.pack_lanes(named["syms"], named["lane_len"],
                                          named["table_idx"], named["tables"])
    if bool((nbits < 0).any()):
        raise ValueError(f"table_idx: values outside [0, {named['tables'].shape[0]})")
    total = torch.sum(nbits, dtype=torch.int64)
    return histos, ent, words, nbits, total
