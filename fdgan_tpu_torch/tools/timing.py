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


def busy_profile(fn) -> dict:
    """One fn() under ``torch.profiler`` with the card synchronised around
    it: its wall ms (host clock), the device's busy ms (the union of its
    kernels' intervals) and idle share, NCCL's kernels' ms and count (which
    also wait for the peers), and the kernels that take the most time."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (e.time_range.end - e.time_range.start) / 1000
    return {"wall_ms": 1000 * wall, "device_busy_ms": busy / 1000,
            "idle_share": 1.0 - busy / 1000 / (1000 * wall) if wall > 0 else None,
            "device_events": len(kernels), "nccl_ms": sum(e.time_range.end - e.time_range.start for e in nccl) / 1000,
            "nccl_kernels": len(nccl),
            "top_kernels": sorted(({"name": k, "ms": v} for k, v in by_name.items()), key=lambda r: -r["ms"])[:10]}
