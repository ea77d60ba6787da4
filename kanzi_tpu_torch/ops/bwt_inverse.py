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
the plain version beside it. K10 cuts each row's walk into segments of
2^k steps, whose starts come from a table of lf^(2^k) built by pointer
doubling (``jump_rounds`` picks k); ``_lf_walk_segmented_plain`` and its
three phases are that decomposition in plain PyTorch, for the tests.
Where kanzi_tpu's gather would clamp an index outside [0, N), the port
refuses it: a start outside [0, N) raises ValueError before the walk, and
an LF entry outside [0, N) raises ValueError after it (the kernel flags
the row).
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
    K.count_plain("lf_walk")
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


def jump_rounds(nsteps: int) -> int:
    """K10's doubling rounds k for a walk of `nsteps` (segments of 2^k
    steps): about half of log2(nsteps), so that the k rounds, the
    nsteps / 2^k checkpoint loads and the 2^k steps of a segment stay
    balanced; at most 12."""
    return min(12, nsteps.bit_length() // 2)


def _segments(nsteps: int, k: int) -> tuple[int, int]:
    """(L, S): K10's segment length and count a row; k = 0 is one segment."""
    L = 1 << k if k > 0 else max(nsteps, 1)
    return L, -(-nsteps // L)


def _lf_jump_plain(lf, k):
    """lf^(2^k) on each row, by k rounds of pointer doubling."""
    J = lf.long()
    for _ in range(k):
        J = torch.gather(J, 1, J)
    return J


def _lf_checkpoints_plain(J, starts, S):
    """(B, S): J^m(start) for m < S, one dependent gather a segment."""
    cur = starts.long()[:, None]
    out = []
    for _ in range(S):
        out.append(cur)
        cur = torch.gather(J, 1, cur)
    return torch.cat(out, dim=1)


def _lf_segments_plain(last_cols, lf, ckpt, L, nsteps):
    """Every (row, segment) cursor walks L steps from its checkpoint;
    segment m fills out[:, mL : mL + L), the last cut at nsteps."""
    B, S = ckpt.shape
    lf64 = lf.long()
    cur = ckpt.clone()
    out = torch.empty(B, S, L, dtype=torch.uint8, device=last_cols.device)
    for s in range(L):
        out[:, :, s] = torch.gather(last_cols, 1, cur)
        cur = torch.gather(lf64, 1, cur)
    return out.reshape(B, S * L)[:, :nsteps]


def _lf_walk_segmented_plain(last_cols, lf, starts, nsteps, k):
    """K10's decomposition in plain PyTorch (tests only): the jump table,
    the checkpoints, the segments. Equals the walk for any in-range lf."""
    B, N = last_cols.shape
    K.check_index(lf, "lf", N)
    if nsteps == 0:
        return torch.empty(B, 0, dtype=torch.uint8, device=last_cols.device)
    L, S = _segments(nsteps, k)
    J = _lf_jump_plain(lf, k) if S > 1 else lf.long()
    return _lf_segments_plain(last_cols, lf, _lf_checkpoints_plain(J, starts, S),
                              L, nsteps)


def lf_walk(last_cols: torch.Tensor, lf: torch.Tensor, starts: torch.Tensor,
            nsteps: int, jump: int | None = None) -> torch.Tensor:
    """Walk the LF mapping `nsteps` times from `starts` (one cursor per
    row), emitting the decoded bytes in reverse text order.

    last_cols: (B, N) uint8; lf: (B, N) int32; starts: (B,) int32.
    Returns (B, nsteps) uint8. Raises ValueError for a start or an LF entry
    outside [0, N) (kanzi_tpu's gather would clamp it). `jump` sets K10's
    doubling rounds (default ``jump_rounds(nsteps)``); the result does not
    depend on it, and the plain version ignores it.
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
    k = jump_rounds(nsteps) if jump is None else jump
    if not 0 <= k <= 30:
        raise ValueError(f"lf_walk: jump {k} outside [0, 30]")
    if route == "plain":
        return _lf_walk_plain(last_cols, lf, starts, nsteps)
    out = torch.empty(B, nsteps, dtype=torch.uint8, device=dev)
    wide = N > (1 << 24)
    table = torch.empty(B * N * (8 if wide else 4), dtype=torch.uint8, device=dev)
    S = _segments(nsteps, k)[1]
    # the two jump buffers (one for k = 1) and the checkpoints, when S > 1
    jump_buf = torch.empty(min(k, 2) * B * N if S > 1 else 0, dtype=torch.int32, device=dev)
    ckpt = torch.empty(B * S if S > 1 else 0, dtype=torch.int32, device=dev)
    bad = torch.empty(B, dtype=torch.int32, device=dev)
    K.launch("lf_walk", "kz_lf_walk", dev, last_cols.data_ptr(), lf.data_ptr(),
             starts.data_ptr(), B, N, nsteps, k, table.data_ptr(), jump_buf.data_ptr(),
             ckpt.data_ptr(), bad.data_ptr(), out.data_ptr())
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
