"""The traced window: device operations from ``torch.profiler`` and the
harness's own host spans, reduced to busy time, kernel time by name and the
longest idle gaps.

The profiler records device activity only (``ProfilerActivity.CUDA``), so a
window of tens of seconds stays small, and its raw events are read without
building the profiler's event tree. Their timestamps are Unix nanoseconds,
the clock of ``time.time_ns``, so device intervals are clipped to the
window the host measured. Busy time is the union of the device operations'
intervals (kernels, copies, sets), as ``fdgan_tpu_torch/tools/timing.py::
busy_profile`` takes it.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]


class Spans:
    """Host spans of the harness (name, start ns, end ns), kept in memory
    while tracing and dropped otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t, time.time_ns()))


def union(intervals: List[Interval]) -> List[Interval]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Device operations of one window: ``ops`` as (name, start ns, end ns),
    clipped to [t0, t1]."""

    def __init__(self, ops: List[Tuple[str, int, int]], t0: int, t1: int, spans: Optional[Spans] = None):
        self.t0, self.t1 = t0, t1
        self.ops = [(n, max(a, t0), min(b, t1)) for n, a, b in ops if b > t0 and a < t1]
        self.spans = spans.items if spans is not None else []
        self.busy = union([(a, b) for _, a, b in self.ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose names match ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.ops if rx.search(n)) / 1e9

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.ops if rx.search(n))

    def top_ops(self, k: int = 10) -> List[List]:
        """The ``k`` operation names that took the most device time, with
        their seconds."""
        by: Dict[str, float] = {}
        for n, a, b in self.ops:
            key = _short(n)
            by[key] = by.get(key, 0.0) + (b - a) / 1e9
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest idle gaps inside the window, each named by the
        host span that covers most of it (the harness's own phases), else by
        the device operation that ended before it."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        ends = sorted((b, n) for n, _, b in self.ops)
        out = []
        for a, b in gaps[:k]:
            best, cover = None, 0
            for name, s, e in self.spans:
                c = min(b, e) - max(a, s)
                if c > cover:
                    best, cover = name, c
            if best is None:
                i = bisect.bisect_right(ends, (a, chr(0x10FFFF)))
                best = f"after {_short(ends[i - 1][1])}" if i else "window start"
            out.append([best, (b - a) / 1e9])
        return out


def _short(name: str) -> str:
    """A kernel's name without its argument list and template noise."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()[:96] or name[:96]


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str = "cuda"):
    """A profiler of the device while enabled; yields a callable that, once
    the profiler has stopped, returns its device operations as (name, start
    ns, end ns). On the CPU (the tests) the CPU's operators stand in."""
    if not enabled:
        yield lambda: []
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device_type == "cuda"
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        yield lambda: [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events() if e.device_type() == want]
