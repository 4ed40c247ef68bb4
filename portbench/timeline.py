"""The traced window: ``torch.profiler`` events reduced to device intervals,
named host spans and the host's work in each device idle gap.

Kept in memory: no trace file is written. The device's busy time is the
union of its kernel, memcpy and memset intervals (overlapping kernels
count once), clipped to the window the benchmark marks with its own
range ``portbench.window``.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "portbench.window"

Interval = Tuple[int, int]


def union(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of [start, end) intervals, clipped to [lo, hi), sorted
    and disjoint."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: List[Interval], lo: int, hi: int) -> int:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


@dataclass
class Timeline:
    """``device``: (start, end, name) of each kernel, memcpy and memset;
    ``spans``: (start, end, name) of each host range (``record_function``)
    on any thread; ``ops``: (start, end, name) of the host operators on
    any thread (autograd runs the backward on a thread of its own);
    ``window``: the traced window (ns, the profiler's clock)."""

    device: List[Tuple[int, int, str]] = field(default_factory=list)
    spans: List[Tuple[int, int, str]] = field(default_factory=list)
    ops: List[Tuple[int, int, str]] = field(default_factory=list)
    window: Interval = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        return covered([(s, e) for s, e, _ in self.device],
                       *self.window) * 1e-9

    def kernel_s(self, match) -> Tuple[float, int]:
        """Summed device seconds and count of the window's device
        operations whose name ``match`` accepts."""
        lo, hi = self.window
        picked = [(s, e) for s, e, n in self.device
                  if lo <= s < hi and match(n)]
        return sum(e - s for s, e in picked) * 1e-9, len(picked)

    def span_s(self, name: str) -> Tuple[float, int]:
        """Summed host seconds and count of the window's ranges ``name``."""
        lo, hi = self.window
        picked = [(s, e) for s, e, n in self.spans
                  if n == name and lo <= s < hi]
        return sum(e - s for s, e in picked) * 1e-9, len(picked)

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time, by name."""
        lo, hi = self.window
        total: Dict[str, int] = defaultdict(int)
        for s, e, n in self.device:
            if lo <= s < hi:
                total[n] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], t * 1e-9] for n, t in ranked]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Device idle time by what the host was doing in it: the
        latest-started range and host operator still running at each gap's
        midpoint (on any thread: autograd runs the backward on a thread of
        its own), summed by that label."""
        holes = gaps([(s, e) for s, e, _ in self.device], *self.window)
        total: Dict[str, int] = defaultdict(int)
        sweeps = [Sweep([m for m in self.spans if m[2] != WINDOW], "host"),
                  Sweep(self.ops, "python")]
        for s, e in holes:
            mid = (s + e) // 2
            span, op = (sw.at(mid) for sw in sweeps)
            total[f"{span}: {op}"] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], t * 1e-9] for n, t in ranked]


class Sweep:
    """The latest-started of (start, end, name) intervals that is still
    running at each of a rising sequence of instants."""

    def __init__(self, intervals, default: str):
        self.todo = sorted(intervals)
        self.next = 0
        self.heap: list = []
        self.default = default

    def at(self, t: int) -> str:
        while self.next < len(self.todo) and self.todo[self.next][0] <= t:
            s, e, name = self.todo[self.next]
            heapq.heappush(self.heap, (-s, e, name))
            self.next += 1
        while self.heap and self.heap[0][1] <= t:
            heapq.heappop(self.heap)
        # Ended intervals under the top are dropped when they surface.
        return self.heap[0][2] if self.heap else self.default


def from_profiler(prof) -> Timeline:
    """Reduce a stopped ``torch.profiler.profile`` (CPU and CUDA
    activities) to a ``Timeline``."""
    from torch.autograd import DeviceType

    tl = Timeline()
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not (ev.is_user_annotation()
                    or name.startswith("Activity Buffer")):
                tl.device.append((s, e, name))
            continue
        if ev.is_user_annotation():
            tl.spans.append((s, e, name))
            if name == WINDOW:
                tl.window = (s, e)
        else:
            tl.ops.append((s, e, name))
    return tl
