"""The program's own trace: named host ranges and work counters for a
``torch.profiler`` run.

Everything here acts only while the profiler runs
(``torch.autograd.profiler._is_profiler_enabled``). Otherwise each site
costs one bool test and builds nothing: no range, no autograd node, no
counter tensor.

- ``span(name)``: a ``record_function`` range around host code. Its
  kineto event lies on one clock with the kernels, so a trace places each
  device idle gap under the innermost range running at the time.
- ``backward_span(name)``: the range ``name`` over a layer's backward,
  which runs on autograd's thread. Identity markers on the layer's outputs
  open it when their gradient arrives; markers on its inputs that require
  grad close it when theirs is complete. A layer whose inputs need no
  gradient (the U-Net: its leaves are parameters) closes it at the end of
  the backward pass.
- Counters: ``add(name, n)`` adds to a host int; ``device_counters`` hands
  a kernel the int64 slots it adds its own data-dependent work to (one
  tensor a device, made at the first counted launch); ``counters()`` reads
  both, with one synchronize.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

# The counters kept on a device, in the order of its tensor: each kernel
# that counts its own work adds (pairs, bytes) there.
DEVICE_COUNTERS = ("composite_fwd.pairs", "composite_fwd.bytes",
                   "composite_bwd.pairs", "composite_bwd.bytes")

_host: Dict[str, int] = defaultdict(int)
_device: Dict[torch.device, torch.Tensor] = {}


def span(name: str):
    """``record_function(name)`` while the profiler runs, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return contextlib.nullcontext()


class _Off:
    """The backward span of an untraced call: marks nothing."""

    @staticmethod
    def inputs(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def outputs(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return xs


class BackwardSpan:
    """The range ``name`` over one call's backward (``backward_span``)."""

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.closers = 0

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` behind a marker whose gradient closes the range (none
        where ``x`` needs no gradient)."""
        if not x.requires_grad:
            return x
        self.closers += 1
        return _Close.apply(self, x)

    def outputs(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``xs`` behind one marker whose gradient opens the range."""
        if not any(x.requires_grad for x in xs):
            return xs
        return _Open.apply(self, *xs)

    def open(self):
        if self.range is None:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
            if not self.closers:
                torch.autograd.Variable._execution_engine.queue_callback(
                    self.close)

    def close(self):
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None


def backward_span(name: str):
    """A ``BackwardSpan`` while the profiler runs and autograd records,
    else one that marks nothing (the graph is then the untraced one)."""
    if _profiler._is_profiler_enabled and torch.is_grad_enabled():
        return BackwardSpan(name)
    return _Off


class _Open(torch.autograd.Function):
    """Identity; its backward opens the range."""

    @staticmethod
    def forward(ctx, bspan, *xs):
        ctx.bspan = bspan
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bspan.open()
        return (None, *grads)


class _Close(torch.autograd.Function):
    """Identity; its backward closes the range."""

    @staticmethod
    def forward(ctx, bspan, x):
        ctx.bspan = bspan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.bspan.close()
        return None, grad


def add(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while the profiler runs."""
    if _profiler._is_profiler_enabled:
        _host[name] += n


def device_counters(kernel: str, device: torch.device
                    ) -> Optional[torch.Tensor]:
    """While the profiler runs, the int64 [2] slots on ``device`` where
    ``kernel`` adds its (pairs, bytes); else None."""
    if not _profiler._is_profiler_enabled:
        return None
    buf = _device.get(device)
    if buf is None:
        # A plain tensor even inside inference_mode, so that later
        # launches outside it may add to it.
        with torch.inference_mode(False):
            buf = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64,
                              device=device)
        _device[device] = buf
    i = DEVICE_COUNTERS.index(f"{kernel}.pairs")
    return buf[i:i + 2]


def counters() -> Dict[str, int]:
    """Every counter that was added to: host and device, summed over the
    devices."""
    out = dict(_host)
    for buf in _device.values():
        for name, v in zip(DEVICE_COUNTERS, buf.tolist()):
            out[name] = out.get(name, 0) + v
    return out


def reset() -> None:
    """Forget every counter and its device tensors."""
    _host.clear()
    _device.clear()
