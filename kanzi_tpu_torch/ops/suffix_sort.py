"""Suffix sort by prefix doubling, and the BWT block payload built on it.

Manber-Myers prefix doubling: every round sorts the suffixes by the pair
(rank[i], rank[i + k]), relabels them with dense ranks and doubles k, until
every rank is distinct. The suffix array of a string is unique, so the BWT
payload equals the host engine's (SA-IS, native transform type 1) byte for
byte. Order semantics: positions past the end compare smaller than every
symbol, so a suffix that is a prefix of another sorts first.

Shapes, signatures and semantics follow kanzi_tpu/ops/suffix_sort.py, with
a `device` argument on the entry points ("cuda" by default, "cpu" for the
plain PyTorch version; None raises: the scan has no host route).
``prefix_double`` is a wrapper: a CUDA tensor goes through K9
(``csrc/suffix_sort.cu``) or the wrapper raises; a CPU tensor goes through
the plain version beside it. It also returns the number of rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels as K


def _bucket(n: int) -> int:
    size = 1024
    while size < n:
        size <<= 1
    return size


def _prefix_double_plain(padded: torch.Tensor, n_true: int):
    K.plain_calls["prefix_double"] += 1
    size = padded.shape[0]
    dev = padded.device
    idx = torch.arange(size, dtype=torch.int64, device=dev)
    rank = torch.where(idx < n_true, padded.long(), 256 + idx)
    # bits of one key half: r2 + 1 reaches size + 256 in the first round,
    # whose pad ranks are 256 + index
    b = (size + 256).bit_length()
    k, rounds = 1, 0
    while True:
        pos = idx + k
        r2 = torch.where(pos < n_true, rank[pos.clamp(max=size - 1)], -1)
        # two stable sorts: by the second key, then by the first
        o2 = torch.sort(r2, stable=True).indices
        order = o2[torch.sort(rank[o2], stable=True).indices]
        key = (rank << b) | (r2 + 1)
        sk = key[order]
        neq = torch.ones(size, dtype=torch.int64, device=dev)
        neq[1:] = (sk[1:] != sk[:-1]).long()
        new = torch.cumsum(neq, 0) - 1
        rank = torch.empty_like(rank)
        rank[order] = new
        k *= 2
        rounds += 1
        # the ranks are dense: the last sorted one is the largest
        if not (k < size and int(new[-1].item()) < size - 1):
            return order.to(torch.int32), rounds


def prefix_double(padded: torch.Tensor, n_true: int):
    """Suffix order of the first `n_true` symbols of `padded` by prefix
    doubling.

    padded: (size,) int32, symbols 0..255 below n_true (the rest is
            ignored); size a power of two >= 1024, as _bucket gives
    n_true: 0 <= n_true <= size

    Returns (order (size,) int32 with the entries >= n_true at the tail,
    rounds: the doubling rounds taken). Each round reads the largest rank
    back to the host (one synchronisation a round).
    Replaces kanzi_tpu/ops/suffix_sort.py: _prefix_double.
    """
    route = K.route(padded)
    dev = padded.device
    K.check(padded, "padded", (torch.int32,), 1, dev)
    size = padded.shape[0]
    if size < 1024 or size & (size - 1):
        raise ValueError(f"prefix_double: size {size} is not a power of two >= 1024")
    if not 0 <= n_true <= size:
        raise ValueError(f"prefix_double: n_true {n_true} outside [0, {size}]")
    if route == "plain":
        return _prefix_double_plain(padded, n_true)
    order = torch.empty(size, dtype=torch.int32, device=dev)
    rounds = torch.zeros(1, dtype=torch.int64)
    scratch = torch.empty(K.query("kz_prefix_double_scratch", size), dtype=torch.uint8,
                          device=dev)
    K.launch("prefix_double", "kz_prefix_double", dev, padded.data_ptr(), size,
             n_true, order.data_ptr(), rounds.data_ptr(), scratch.data_ptr(),
             scratch.numel())
    return order, int(rounds.item())


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), np.uint8)
    return np.asarray(data, np.uint8)


def suffix_array_device(data, device="cuda") -> np.ndarray:
    """Suffix array of `data` (bytes or a uint8 array), identical to the
    host sais.cpp order, computed on `device`."""
    dev = K.resolve_scan_device(device)
    arr = _as_u8(data)
    n = len(arr)
    if n <= 1:
        return np.zeros(n, np.int32)
    size = _bucket(n)
    padded = np.zeros(size, np.int32)
    padded[:n] = arr
    order = prefix_double(torch.from_numpy(padded).to(dev), n)[0].cpu().numpy()
    return order[order < n].astype(np.int32)


def bwt_forward_device(data, device="cuda") -> bytes:
    """BWT block payload (header + rotated bytes) from the device suffix
    array, byte-identical to native transform type 1 (bwt.cpp
    bwtBlockCodec); the header and the rotation are assembled on the host."""
    src = _as_u8(data)
    n = len(src)
    if n < 2:
        # pIndexSize would be 0: the native codec skips such blocks
        raise ValueError("block too small for the BWT block codec")
    sa = suffix_array_device(src, device)
    chunks = 1 if n < 256 else 8
    step = -(-n // chunks)
    indexes = np.zeros(8, np.uint32)
    sel = (sa % step) == 0
    indexes[sa[sel] // step] = np.nonzero(sel)[0] + 1
    p_idx = int(np.nonzero(sa == 0)[0][0])
    out = np.empty(n, np.uint8)
    out[0] = src[n - 1]
    out[1:p_idx + 1] = src[sa[:p_idx] - 1]
    out[p_idx + 1:] = src[sa[p_idx + 1:] - 1]
    indexes[0] = p_idx + 1
    # pIndexSize from ceil(log2(blockSize)), as bwt.cpp
    pis = ((n - 1).bit_length() + 7) >> 3
    mode = ((chunks.bit_length() - 1) << 2) | (pis - 1)
    header = bytearray([mode])
    for c in range(chunks):
        header += int(indexes[c] - 1).to_bytes(pis, "big")
    return bytes(header) + out.tobytes()
