"""Arithmetic over whole windows: rates and percentiles.

A rate is all the work completed in the window over the window's length; a
percentile is over every request due in the window, a request that never
completed counting as the longest wait; nothing is taken from medians of
chunks.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def rate(done_times: Iterable[float], t0: float, t1: float) -> float:
    """Units completed in [t0, t1] per second of it."""
    if t1 <= t0:
        raise ValueError("an empty window")
    return sum(1 for t in done_times if t0 <= t <= t1) / (t1 - t0)


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q % of the values at or below it."""
    if len(values) == 0:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def latencies(due: Sequence[float], done: Sequence[Optional[float]], t0: float, t1: float,
              waited_until: float) -> List[float]:
    """The latency of every request due in [t0, t1], from its due time to
    its result; a request with no result (None) counts as waiting until
    ``waited_until``."""
    return [(d if d is not None else waited_until) - u for u, d in zip(due, done) if t0 <= u <= t1]
