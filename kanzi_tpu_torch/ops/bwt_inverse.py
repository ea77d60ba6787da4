"""BWT inverse by a batched LF-mapping walk.

B independent cursors (blocks or chunks) each walk the LF mapping of their
row, one dependent gather a step, and emit the last column's byte at every
step: the decoded text back to front. The batch axis is the only
parallelism the dependency admits. Signatures follow
kanzi_tpu/ops/bwt_inverse.py, with a `device` argument on
``bwt_inverse_device`` ("cuda" by default, "cpu" for the plain PyTorch
version; None raises: the scan has no host route).

``lf_walk`` is a wrapper: a CUDA tensor goes through K10
(``csrc/bwt_inverse.cu``) or the wrapper raises; a CPU tensor goes through
the plain version beside it. Where kanzi_tpu's gather would clamp an index
outside [0, N), the port refuses it: a start outside [0, N) raises
ValueError before the walk, and an LF entry outside [0, N) raises
ValueError after it (the kernel flags the row).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels as K


def build_lf(last_cols: torch.Tensor):
    """LF mapping of a batch of BWT last columns: LF[i] = C[last[i]] +
    rank(last[i], i), the inverse of the stable argsort permutation,
    computed on the tensor's device with a stable torch.sort (kanzi_tpu
    computes it on the host with numpy).

    last_cols: (B, N) uint8. Returns (lf (B, N) int32, counts (B, 256)
    int32).
    """
    B, N = last_cols.shape
    dev = last_cols.device
    order = torch.sort(last_cols, dim=1, stable=True).indices
    lf = torch.empty(B, N, dtype=torch.int32, device=dev)
    lf.scatter_(1, order, torch.arange(N, dtype=torch.int32, device=dev)
                .expand(B, N).contiguous())
    counts = torch.zeros(B, 256, dtype=torch.int32, device=dev)
    counts.scatter_add_(1, last_cols.long(), torch.ones_like(lf))
    return lf, counts


def _lf_walk_plain(last_cols, lf, starts, nsteps):
    K.plain_calls["lf_walk"] += 1
    N = last_cols.shape[1]
    K.check_index(lf, "lf", N)
    lf64 = lf.long()
    cur = starts.long()[:, None]
    out = torch.empty(last_cols.shape[0], nsteps, dtype=torch.uint8,
                      device=last_cols.device)
    for s in range(nsteps):
        out[:, s:s + 1] = torch.gather(last_cols, 1, cur)
        cur = torch.gather(lf64, 1, cur)
    return out


def lf_walk(last_cols: torch.Tensor, lf: torch.Tensor, starts: torch.Tensor,
            nsteps: int) -> torch.Tensor:
    """Walk the LF mapping `nsteps` times from `starts` (one cursor per
    row), emitting the decoded bytes in reverse text order.

    last_cols: (B, N) uint8; lf: (B, N) int32; starts: (B,) int32.
    Returns (B, nsteps) uint8. Raises ValueError for a start or an LF entry
    outside [0, N) (kanzi_tpu's gather would clamp it).
    Replaces kanzi_tpu/ops/bwt_inverse.py: lf_walk.
    """
    route = K.route(last_cols)
    dev = last_cols.device
    K.check(last_cols, "last_cols", (torch.uint8,), 2, dev)
    K.check(lf, "lf", (torch.int32,), 2, dev)
    K.check(starts, "starts", (torch.int32,), 1, dev)
    B, N = last_cols.shape
    if lf.shape != (B, N) or starts.shape[0] != B:
        raise ValueError(f"lf_walk: expected lf ({B}, {N}) and starts ({B},), got "
                         f"{tuple(lf.shape)}, {tuple(starts.shape)}")
    if nsteps < 0:
        raise ValueError(f"lf_walk: nsteps {nsteps} < 0")
    K.check_index(starts, "starts", N)
    if route == "plain":
        return _lf_walk_plain(last_cols, lf, starts, nsteps)
    out = torch.empty(B, nsteps, dtype=torch.uint8, device=dev)
    wide = N > (1 << 24)
    table = torch.empty(B * N * (8 if wide else 4), dtype=torch.uint8, device=dev)
    bad = torch.empty(B, dtype=torch.int32, device=dev)
    K.launch("lf_walk", "kz_lf_walk", dev, last_cols.data_ptr(), lf.data_ptr(),
             starts.data_ptr(), B, N, nsteps, table.data_ptr(), bad.data_ptr(),
             out.data_ptr())
    rows = torch.nonzero(bad).flatten().tolist()
    if rows:
        raise ValueError(f"lf_walk: rows {rows} hold an LF entry outside [0, {N})")
    return out


def bwt_inverse_device(last_cols: np.ndarray, primary: np.ndarray,
                       device="cuda") -> np.ndarray:
    """Batched BWT inverse (textbook layout: `last_cols[b]` is the BWT of
    a block whose sorted-rotation primary row is primary[b]), on `device`.
    Returns the decoded blocks (B, N) uint8."""
    dev = K.resolve_scan_device(device)
    last = torch.from_numpy(np.ascontiguousarray(last_cols, np.uint8)).to(dev)
    lf, _ = build_lf(last)
    starts = torch.from_numpy(np.asarray(primary).astype(np.int32)).to(dev)
    out = lf_walk(last, lf, starts, last.shape[1])
    # the walk emits the text back to front
    return torch.flip(out, [1]).cpu().numpy()
