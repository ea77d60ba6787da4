"""Run a device entropy engine's kernel on the engine's own CUDA stream and
hand its outputs to the host without blocking the caller.

The Writer dispatches a batch, transforms the next one on the host while
the card works, and collects later: `launch` returns at once with pinned
host copies in flight and an event behind them; `HostResult.get` waits on
that event alone. On the CPU (the plain versions, for the tests) the call
runs to its end before `launch` returns. `encode_block` takes one block
through an engine's dispatch and collect.
"""

from __future__ import annotations

import numpy as np
import torch


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
                self._event.synchronize()
            self._np = tuple(o.numpy() for o in self._outs)
            self._keep = None
        return self._np


def launch(stream, fn) -> HostResult:
    """Call fn() -> (inputs to keep alive, output tensors) on `stream`, or
    on the CPU where `stream` is None. On a CUDA stream the outputs are
    copied into pinned host tensors behind an event, and the device
    tensors stay referenced until the event has fired."""
    if stream is None:
        _keep, outs = fn()
        return HostResult(outs, None, None)
    with torch.cuda.stream(stream):
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
