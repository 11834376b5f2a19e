"""The program's own spans (``fdgan_tpu_torch/trace.py``) in a traced
window: what the per-layer metrics that read them share.

The port records its spans while a profile runs, on the clock of the
profiler's device events (``time.time_ns``), so they lie on the window's
``DeviceTrace`` as they are. A span belongs to the window it starts in. A
program without the recorder, or without the spans named, reads None in
every function here."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional

from harness.trace import Interval, union

_END = 1 << 63  # past any span's start


def window_spans(data: dict, name: str) -> Optional[list]:
    """The program's spans called ``name`` that start in the traced window,
    in order of start; None where there are none."""
    try:
        from fdgan_tpu_torch import trace
    except ImportError:  # a program without the recorder
        return None
    window = data["trace"]
    return trace.spans(window.t0, window.t1, name) or None


def _ms(spans) -> List[float]:
    return [(s.end - s.start) / 1e6 for s in spans]


def mean_ms(data: dict, name: str) -> Optional[float]:
    spans = window_spans(data, name)
    return statistics.fmean(_ms(spans)) if spans else None


def median_ms(data: dict, name: str) -> Optional[float]:
    spans = window_spans(data, name)
    return statistics.median(_ms(spans)) if spans else None


def per_step_ms(data: dict, names: Iterable[str]) -> Optional[float]:
    """The summed ms of the spans called any of ``names`` that are phases
    of the window's train steps (their parent a ``train.g_step`` or
    ``train.d_step`` span of the window, wherever they start), over the
    number of ``train.g_step`` spans in the window."""
    steps = window_spans(data, "train.g_step")
    if not steps:
        return None
    from fdgan_tpu_torch import trace

    parents = {s.id for s in steps + (window_spans(data, "train.d_step") or [])}
    parts = [s for name in names for s in trace.spans(data["trace"].t0, _END, name) if s.parent in parents]
    return sum(_ms(parts)) / len(steps) if parts else None


def share_pct(data: dict, name: str, key: str, value) -> Optional[float]:
    """The share, in %, of the window's spans called ``name`` whose
    attribute ``key`` is ``value``."""
    spans = window_spans(data, name)
    return 100.0 * sum(s.attrs.get(key) == value for s in spans) / len(spans) if spans else None


def _overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_pct(data: dict, names: Iterable[str]) -> Optional[float]:
    """The share of the window, in %, in which no operation ran on the
    device and the host was inside a span called any of ``names`` (their
    union, clipped to the window)."""
    window = data["trace"]
    spans = [s for name in names for s in window_spans(data, name) or []]
    if not spans or not window.ops or window.t1 <= window.t0:
        return None
    inside = union([(s.start, min(s.end, window.t1)) for s in spans])
    held = sum(b - a for a, b in inside)
    return 100.0 * (held - _overlap_ns(inside, window.busy)) / (window.t1 - window.t0)
