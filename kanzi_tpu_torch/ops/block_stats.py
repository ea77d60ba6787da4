"""Per-block statistics: order-0 histograms and the entropy gate.

The block scheduler's incompressibility test (first-order entropy x1024
>= 973 -> copy block, reference v2/io/CompressedStream.go:778-800) and the
fused device compress step (``parallel.compress_step``) read these.

Each function is a wrapper: a CUDA tensor goes through its kernel
(``csrc/block_stats.cu``) or the wrapper raises; a CPU tensor goes through
the plain PyTorch version beside it. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import _kernels as K

MAX_ROWS = 65535          # the launch grid's y dimension
MAX_LEN = (1 << 31) - 1   # an int32 count


def _check_blocks(blocks: torch.Tensor) -> str:
    route = K.route(blocks)
    K.check(blocks, "blocks", (torch.uint8,), 2, blocks.device)
    B, N = blocks.shape
    if route == "cuda" and (B > MAX_ROWS or N > MAX_LEN):
        raise ValueError(f"blocks: shape {(B, N)}, the kernel takes at most "
                         f"{MAX_ROWS} rows of at most {MAX_LEN} bytes")
    return route


def _histograms_plain(blocks: torch.Tensor) -> torch.Tensor:
    K.count_plain("histograms_u8")
    B = blocks.shape[0]
    out = torch.zeros(B, 256, dtype=torch.int64, device=blocks.device)
    out.scatter_add_(1, blocks.long(), torch.ones_like(blocks, dtype=torch.int64))
    return out.to(torch.int32)


def histograms_u8(blocks: torch.Tensor) -> torch.Tensor:
    """(B, N) uint8 -> (B, 256) int32 counts, for any N; rows may start at
    any alignment. On the card: the block_stats kernel without its entropy
    tail, one launch.

    Replaces kanzi_tpu/ops/pallas_kernels.py: histograms_pallas (Pallas)
    and kanzi_tpu/ops/histogram.py: histograms_u8 (XLA)."""
    if _check_blocks(blocks) == "plain":
        return _histograms_plain(blocks)
    B, N = blocks.shape
    out = torch.empty(B, 256, dtype=torch.int32, device=blocks.device)
    K.launch("histograms_u8", "kz_histograms_u8", blocks.device,
             blocks.data_ptr(), B, N, out.data_ptr())
    return out


def _entropy_plain(histos: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    K.count_plain("entropy1024")
    h = histos.to(torch.float32)
    n = torch.clamp(lengths.to(torch.float32), min=1.0)
    p = torch.where(h > 0, h / n[:, None], torch.ones_like(h))
    bits = -torch.sum(torch.where(h > 0, h * torch.log2(p), torch.zeros_like(h)),
                      dim=1)
    return (128.0 * bits / n).to(torch.int32)


def entropy1024(histos: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, 256) int32 histograms + (B,) int32 lengths -> (B,) int32 order-0
    entropy x1024, float32 log2 truncated to int (feeds the >= 973 gate;
    never a format-visible decision). Lengths are guarded with max(n, 1).
    On the card the body is block_stats' entropy tail, so both give the
    same value on the same histogram.

    Replaces kanzi_tpu/ops/pallas_kernels.py: entropy1024_pallas (Pallas)
    and kanzi_tpu/ops/histogram.py: entropy1024 (XLA)."""
    route = K.route(histos)
    dev = histos.device
    K.check(histos, "histos", (torch.int32,), 2, dev)
    K.check(lengths, "lengths", (torch.int32,), 1, dev)
    if histos.shape[1] != 256 or lengths.shape[0] != histos.shape[0]:
        raise ValueError(f"shapes {tuple(histos.shape)} and "
                         f"{tuple(lengths.shape)}, expected (B, 256) and (B,)")
    if route == "plain":
        return _entropy_plain(histos, lengths)
    B = histos.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=dev)
    K.launch("entropy1024", "kz_entropy1024", dev, histos.data_ptr(),
             lengths.data_ptr(), B, out.data_ptr())
    return out


def _block_stats_plain(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    K.count_plain("block_stats")
    h = _histograms_plain(blocks)
    lengths = torch.full((blocks.shape[0],), blocks.shape[1], dtype=torch.int32,
                         device=blocks.device)
    return h, _entropy_plain(h, lengths)


def block_stats(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram + entropy gate of every row of a (B, N) uint8 batch:
    ((B, 256) int32, (B,) int32). On the card one launch of the fused
    kernel, which also counts as a launch of histograms_u8 and entropy1024
    (it runs both bodies).

    Replaces kanzi_tpu/ops/pallas_kernels.py: block_stats_pallas."""
    if _check_blocks(blocks) == "plain":
        return _block_stats_plain(blocks)
    B, N = blocks.shape
    h = torch.empty(B, 256, dtype=torch.int32, device=blocks.device)
    e = torch.empty(B, dtype=torch.int32, device=blocks.device)
    K.launch(("block_stats", "histograms_u8", "entropy1024"), "kz_block_stats",
             blocks.device, blocks.data_ptr(), B, N, h.data_ptr(), e.data_ptr())
    return h, e
