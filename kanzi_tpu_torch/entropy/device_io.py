"""Run a device entropy engine's kernel on the engine's own CUDA stream and
hand its outputs to the host without blocking the caller.

The Writer dispatches a batch, transforms the next one on the host while
the card works, and collects later: `launch` returns at once with pinned
host copies in flight and an event behind them; `HostResult.get` waits on
that event alone. On the CPU (the plain versions, for the tests) the call
runs to its end before `launch` returns. `encode_block` takes one block
through an engine's dispatch and collect.

A mesh (parallel.Mesh) runs one launch a shard, each on its own stream
and card: `MeshResult` holds the shards' HostResults and gathers their rows
in order once every shard's event has fired.

The Reader's batched decode goes through `each` (a per-block step on its
pool, a rejected block's exception kept as its result), `stack` (the
blocks' device rows as one launch's inputs) and `one` (a single block's
result, for the per-block path).

Only the data's errors are a block's result (`REJECTIONS`: the port's
KanziError, ValueError, and the host library's NativeError). An error of
the card raises DeviceFault (`_kernels.card_errors`, around every launch
and read-back here) and leaves the batch at once.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import _kernels, native
from ..core import KanziError

# the errors that reject a payload; anything else, DeviceFault first, is
# not the data's and propagates
REJECTIONS = (KanziError, ValueError, native.NativeError)


class HostResult:
    """Host copies of one launch's outputs, read once its event has fired."""

    __slots__ = ("_outs", "_event", "_keep", "_np")

    def __init__(self, outs, event, keep):
        self._outs, self._event, self._keep = outs, event, keep
        self._np = None

    def get(self) -> tuple:
        """The outputs as numpy arrays, in the order the launch gave them."""
        if self._np is None:
            if self._event is not None:
                with _kernels.card_errors("read-back"):
                    self._event.synchronize()
            self._np = tuple(o.numpy() for o in self._outs)
            self._keep = None
        return self._np


class MeshResult:
    """The HostResults of one launch a shard, in row order. Each shard's
    device tensors stay referenced until its own event has fired."""

    __slots__ = ("_parts", "_np")

    def __init__(self, parts):
        self._parts, self._np = list(parts), None

    def get(self) -> tuple:
        """Every shard's outputs, waited for one event at a time and
        concatenated along the rows, in the order the launch gave them."""
        if self._np is None:
            outs = [p.get() for p in self._parts]
            self._np = tuple(np.concatenate(col) for col in zip(*outs))
            self._parts = None
        return self._np


@contextlib.contextmanager
def on(stream):
    """Make `stream` and its card current (nothing on the CPU, where
    `stream` is None): the wrappers launch on the current stream of their
    tensors' card."""
    if stream is None:
        yield
        return
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def launch(stream, fn) -> HostResult:
    """Call fn() -> (inputs to keep alive, output tensors) on `stream`, or
    on the CPU where `stream` is None. On a CUDA stream the outputs are
    copied into pinned host tensors behind an event, and the device
    tensors stay referenced until the event has fired."""
    if stream is None:
        with _kernels.card_errors("launch"):
            _keep, outs = fn()
        return HostResult(outs, None, None)
    with _kernels.card_errors("launch"), on(stream):
        keep, outs = fn()
        hosts = []
        for o in outs:
            h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            h.copy_(o, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record(stream)
    return HostResult(hosts, event, (keep, outs))


def encode_block(engine, src: np.ndarray, slack: int) -> tuple[bytes, int]:
    """One block through an engine's dispatch and collect, the Writer's own
    path, into a buffer of 2*len(src) + slack bytes. Returns (payload,
    bits)."""
    dst = np.zeros(2 * len(src) + slack, dtype=np.uint8)
    bits = engine.collect(engine.dispatch(src), dst, 0)
    return dst[:(bits + 7) >> 3].tobytes(), bits


def each(map_fn, fn, items) -> list:
    """[fn(x) for x in items] through `map_fn` (a pool's map, or map); an
    item whose fn raises one of REJECTIONS gets that exception as its
    result, so one rejected block leaves the others of its batch decodable
    and the caller raises it under the block's id. Any other exception (a
    DeviceFault) propagates from the map at once."""
    def guarded(x):
        try:
            return fn(x)
        except REJECTIONS as e:
            return e
    return list(map_fn(guarded, items))


def one(results) -> bytes:
    """The bytes of a one-block batch decode; its exception is raised."""
    (r,) = results
    if isinstance(r, Exception):
        raise r
    return r.tobytes()


def stack(rows: list) -> dict:
    """Concatenate the {name: array} device rows of several blocks along
    the rows; 2-D arrays of different widths (byte streams, maps) are
    zero-padded to the widest, which no kernel reads past its row's own
    length."""
    out = {}
    for name in rows[0]:
        parts = [r[name] for r in rows]
        if parts[0].ndim == 2 and len({p.shape[1] for p in parts}) > 1:
            width = max(p.shape[1] for p in parts)
            padded = np.zeros((sum(len(p) for p in parts), width), parts[0].dtype)
            at = 0
            for p in parts:
                padded[at:at + len(p), :p.shape[1]] = p
                at += len(p)
            out[name] = padded
        else:
            out[name] = np.concatenate(parts)
    return out
