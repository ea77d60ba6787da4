"""Carry the device ops' state from numpy arrays into tensors.

The codec's device ops take state that the host C++ runtime builds (code
tables, decode tables, lane rows, chunk symbol matrices, renorm streams).
``to_port_state`` takes those numpy arrays, as kanzi_tpu feeds them to its
device ops, and returns tensors in the dtypes the port's kernels take, on
`device`. Every array is copied, once: the host's decode prepares return
views into pooled scratch buffers that the next prepare call overwrites.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels

# name -> (expected ndim, dtype the kernels take); None keeps the symbol
# dtypes listed in _SYMS
_SPEC = {
    # Huffman (ops/huffman.py)
    "tables": (2, torch.int32),      # (C, 256) (len<<12)|code, u16 or i32
    "dtables": (2, torch.int16),     # (C, 4096) u16 (sym<<8)|len, as i16 bits
    "syms": (2, None),               # (L, FRAG) uint8 or int32 lane symbols
    "lanes": (2, torch.uint8),       # (L, 6160) zero-padded lane bytes
    "lane_len": (1, torch.int32),    # (L,)
    "table_idx": (1, torch.int32),   # (L,)
    "blocks": (2, torch.uint8),      # (B, N) raw blocks
    # rANS (ops/ans.py)
    "ans_syms": (3, None),           # (R, G, 4) uint8 (order 0) or u16 (order 1)
    "ngroups": (1, torch.int32),     # (R,) symbol groups per chunk
    "ans_tables": (3, torch.int32),  # (R, 5, S) xMax, bias, cmplFreq, invShift, invFreq
    "bufs": (2, torch.uint8),        # (R, S) renorm byte streams
    "nbytes": (1, torch.int32),      # (R,) bytes of each row's stream
    "nbits": (1, torch.int32),       # (R,) bits of each row's stream
    "bound": (1, torch.int32),       # (R,) the host decoder's slot table size
    "states0": (2, torch.int32),     # (R, 4) initial states, u32 bits
    "f2s": (2, torch.uint8),         # (R, F) freq slot -> symbol
    "dtabs": (3, torch.int32),       # (R, 2, T) freq, cumFreq
    "lr": (1, torch.int32),          # (R,) logRange per chunk, 8..16
    # range (ops/range.py)
    "rng_syms": (2, torch.uint8),    # (R, N) chunk bytes
    "nvalid": (1, torch.int32),      # (R,) valid bytes per chunk
    "rng_tables": (3, torch.int32),  # (R, 2, 256) cumFreq, freq
    "shifts": (1, torch.int32),      # (R,) logRange per chunk
}

# symbol arrays: numpy dtype -> the tensor dtype carrying its bits
_SYMS = {"syms": {np.dtype(np.uint8): np.uint8, np.dtype(np.int32): np.int32},
         "ans_syms": {np.dtype(np.uint8): np.uint8, np.dtype(np.uint16): np.int16}}


def _convert(name: str, arr, device: torch.device) -> torch.Tensor:
    ndim, dtype = _SPEC[name]
    a = np.asarray(arr)
    if a.ndim != ndim:
        raise ValueError(f"{name}: {a.ndim} dimensions, expected {ndim}")
    if name == "dtables":
        if a.dtype != np.uint16:
            raise TypeError(f"dtables: dtype {a.dtype}, expected uint16")
        a = a.view(np.int16)
    elif name in _SYMS:
        carry = _SYMS[name].get(a.dtype)
        if carry is None:
            raise TypeError(f"{name}: dtype {a.dtype}, expected one of "
                            f"{sorted(str(d) for d in _SYMS[name])}")
        a = a.view(carry)
    elif dtype == torch.uint8:
        if a.dtype != np.uint8:
            raise TypeError(f"{name}: dtype {a.dtype}, expected uint8")
    else:
        a = a.astype(np.int32, copy=False)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    # the transfer from pageable memory is the copy (it has finished when
    # .to returns); on the CPU a clone is
    t = torch.from_numpy(a)
    return t.to(device) if device.type == "cuda" else t.clone()


def to_port_state(arrays: dict, device) -> dict:
    """{name: numpy array} -> {name: tensor on `device`}, for the names of
    _SPEC."""
    device = _kernels.resolve_device(device)
    if device is None:
        raise ValueError("to_port_state needs a device: 'cuda' or 'cpu'")
    unknown = set(arrays) - set(_SPEC)
    if unknown:
        raise KeyError(f"unknown state arrays: {sorted(unknown)}")
    return {name: _convert(name, arr, device) for name, arr in arrays.items()}
