"""Host spans of the port, on the clock of the device trace.

A span is a named interval of the host's work: ``time.time_ns()`` at its
start and end, its own id, the id of the span that encloses it in its
thread, and a few attributes. ``time.time_ns()`` is the Unix-nanosecond
clock that ``torch.profiler`` stamps its device events with, so a span lies
on the device trace as it is.

Spans are recorded exactly while a ``torch.profiler`` profile runs, in any
thread: the gate is ``torch.autograd.profiler._is_profiler_enabled``, which
the profiler sets for the whole process whatever its activities (the
profiler's own ``torch._C._autograd._profiler_enabled()`` is per thread,
and reads False in a thread started before the profile). Otherwise a span
costs the read of that flag. Recorded spans stay in memory, the newest
``LIMIT`` of them, and are read by window with :func:`spans`::

    with trace.span("engine.stage", batch=k, why="full") as sp:
        if sp:  # recording: attributes that cost something to build
            sp.attrs["items"] = [i for i, _ in items]
        ...

An interval measured across threads or calls is recorded afterwards from
two stamps: :func:`stamp` where it starts, :func:`record` where it ends.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional

import torch.autograd.profiler as _profiler

__all__ = ["LIMIT", "Span", "record", "span", "spans", "stamp"]

# spans kept. A 30 s traced window records ~3.4e3 in the bulk cell (4 a
# batch of 8 at ~28 batches/s), ~7e3 serving (4 a batch and 1 a request at
# ~154 requests/s) and ~750 training (10 a step at ~2.5 steps/s): ten times
# the largest
LIMIT = 1 << 16

_recorded: collections.deque = collections.deque(maxlen=LIMIT)
_ids = itertools.count(1)


class _Stack(threading.local):
    def __init__(self):
        self.open: List["Span"] = []


_local = _Stack()


class Span:
    """One recorded interval. ``parent`` is the id of the span open in the
    same thread when this one began (None at the top, and for intervals
    recorded from two stamps)."""

    __slots__ = ("name", "start", "end", "id", "parent", "attrs")

    def __init__(self, name: str, attrs: dict, start: int = 0, end: int = 0):
        self.name, self.attrs, self.start, self.end = name, attrs, start, end
        self.id = next(_ids)
        self.parent: Optional[int] = None

    def __enter__(self) -> "Span":
        stack = _local.open
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        stack = _local.open
        if stack and stack[-1] is self:
            stack.pop()
        _recorded.append(self)
        return False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.end - self.start} ns, id={self.id}, parent={self.parent}, {self.attrs})"


_OFF = contextlib.nullcontext()  # what span() returns while nothing records


def span(name: str, **attrs):
    """A context manager that records the span ``name`` while a profile
    runs; it binds the :class:`Span`, or None otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def stamp() -> int:
    """``time.time_ns()`` while spans are recorded, else 0: the start of an
    interval that :func:`record` closes elsewhere."""
    return time.time_ns() if _profiler._is_profiler_enabled else 0


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record the interval [``start_ns``, ``end_ns``) measured elsewhere,
    with no parent, if spans are being recorded."""
    if _profiler._is_profiler_enabled:
        _recorded.append(Span(name, attrs, start_ns, end_ns))


def spans(t0_ns: int, t1_ns: int, name: Optional[str] = None) -> List[Span]:
    """The recorded spans that start in [``t0_ns``, ``t1_ns``), in order of
    start; only those called ``name`` where given."""
    found = [s for s in _recorded.copy() if t0_ns <= s.start < t1_ns and (name is None or s.name == name)]
    found.sort(key=lambda s: s.start)
    return found
