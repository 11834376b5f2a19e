"""Timing and memory helpers shared by ``chip_smoke.py`` and the tools.

Imports only torch, so that ``tools/compare_trees.py`` can load this file by
path and still import the package of another checkout.
"""

from __future__ import annotations

import torch


def device_ms(fn, launches: int = 20) -> float:
    """ms per fn() on the device alone: the calls are queued behind products
    that keep the card busy for longer than the host takes to queue them
    (~20 ms against 20 × ~0.2 ms; behind ~5 ms, K2's wrapper, whose host work
    is ~0.2 ms, read up to 3x its time), so the time between the two events
    holds no wait for the host. What a small kernel costs when a forward has
    queued ahead; a time over the calls alone includes the wrapper's host
    time per launch."""
    fn()
    busy = torch.empty((8192, 8192), device="cuda", dtype=torch.bfloat16).normal_()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(12):
        busy @ busy
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def events_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """ms per fn(): CUDA events around ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def peak_gib(fn) -> float:
    """The device memory fn() allocates at its peak, above what was allocated
    before it, in GiB (``max_memory_allocated``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30
