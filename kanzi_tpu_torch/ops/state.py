"""Carry the device ops' state from numpy arrays into tensors.

The codec's device ops take state that the host C++ runtime builds (code
tables, decode tables, lane rows). ``to_port_state`` takes those numpy
arrays, as kanzi_tpu feeds them to its device ops, and returns tensors in
the dtypes the port's kernels take, on `device`. Every array is copied:
``native.huffman_dec_prepare`` returns views into a pooled scratch buffer
that the next prepare call overwrites.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels

# name -> (expected ndim, dtype the kernels take); None keeps u8/i32 symbols
_SPEC = {
    "tables": (2, torch.int32),      # (C, 256) (len<<12)|code, u16 or i32
    "dtables": (2, torch.int16),     # (C, 4096) u16 (sym<<8)|len, as i16 bits
    "syms": (2, None),               # (L, FRAG) uint8 or int32 lane symbols
    "lanes": (2, torch.uint8),       # (L, 6160) zero-padded lane bytes
    "lane_len": (1, torch.int32),    # (L,)
    "table_idx": (1, torch.int32),   # (L,)
    "blocks": (2, torch.uint8),      # (B, N) raw blocks
}


def _convert(name: str, arr, device: torch.device) -> torch.Tensor:
    ndim, dtype = _SPEC[name]
    a = np.asarray(arr)
    if a.ndim != ndim:
        raise ValueError(f"{name}: {a.ndim} dimensions, expected {ndim}")
    if name == "dtables":
        if a.dtype != np.uint16:
            raise TypeError(f"dtables: dtype {a.dtype}, expected uint16")
        a = a.view(np.int16)
    elif name == "syms":
        if a.dtype not in (np.uint8, np.int32):
            raise TypeError(f"syms: dtype {a.dtype}, expected uint8 or int32")
    elif dtype == torch.uint8:
        if a.dtype != np.uint8:
            raise TypeError(f"{name}: dtype {a.dtype}, expected uint8")
    else:
        a = a.astype(np.int32, copy=False)
    # one host copy (the source may be a read-only or pooled view), then
    # the transfer; on the CPU the copy is the result
    return torch.from_numpy(np.array(a, order="C")).to(device)


def to_port_state(arrays: dict, device) -> dict:
    """{name: numpy array} -> {name: tensor on `device`}, for the names
    tables, dtables, syms, lanes, lane_len, table_idx and blocks."""
    device = _kernels.resolve_device(device)
    if device is None:
        raise ValueError("to_port_state needs a device: 'cuda' or 'cpu'")
    unknown = set(arrays) - set(_SPEC)
    if unknown:
        raise KeyError(f"unknown state arrays: {sorted(unknown)}")
    return {name: _convert(name, arr, device) for name, arr in arrays.items()}
