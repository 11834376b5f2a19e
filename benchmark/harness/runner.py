"""One run of one cell: set-up, the measured window (traced or not), the
program freed, the check against the reference, and the result line."""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, Optional

import torch

from harness import cells, counts
from harness.specs import Specs
from harness.trace import DeviceTrace, Spans, profiled

FORBIDDEN = ("jax", "jaxlib", "flax", "fdgan_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's, a JAX library's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def judge(numbers: Dict[str, tuple], limits: Dict[str, float], log=None) -> tuple:
    """(correct, checks): every number the limits name at or under its
    limit. A named number missing or NaN fails, and so does a cell with no
    limits; numbers the limits do not name are readings, printed only."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value, where = numbers.get(name, (float("nan"), "not produced"))
        value = float(value)
        ok &= not math.isnan(value) and value <= limit
        checks[name] = {"value": value if math.isfinite(value) else str(value), "limit": limit, "at": where}
    for name in sorted(set(numbers) - set(limits)):
        if log is not None:
            print(f"reading {name}: {numbers[name][0]} (not compared; at {numbers[name][1]})", file=log)
    return ok, checks


def run_cell(specs: Specs, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, log=sys.stderr, numbers_out: Optional[dict] = None) -> dict:
    """The result line of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and ``checks`` last);
    ``numbers_out`` receives every number the check read, compared or not."""
    t_start = time.time() if t_start is None else t_start
    cell = specs.workload(workload)
    config, mix = specs.config(cell["config"]), specs.traffic(cell["traffic"])
    spans = Spans(trace)
    dev = torch.device(device)
    with cells.driver(config, mix, seed, dev, specs.family, spans) as drv:
        drv.setup()
        cells._sync(dev)
        # the harness's own set-up garbage (the FLOP count's meta graphs,
        # the checked steps' copies) collected before the window; the
        # program's collections inside the window are timed as it ships
        gc.collect()
        setup_s = time.time() - t_start
        with profiled(trace, dev.type) as device_ops:
            w = drv.window(seconds)
        ops = device_ops()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if hasattr(drv, "lateness"):
            print(f"generator lateness: p95 {w['late_p95_ms']:.3f} ms, max {w['late_max_ms']:.3f} ms over "
                  f"{w['offered']} requests at {w['rate']} /s", file=log)
        if hasattr(drv, "close"):
            drv.close()
        drv.free()
        numbers = drv.check()
        if numbers_out is not None:
            numbers_out.update(numbers)
        attempted, failed = drv.attempted, drv.failed
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"attempted": attempted, "failed": failed}
    if not trace:
        values = {**w, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in specs.end_to_end(workload)}
    else:
        dt = DeviceTrace(ops, int(w["t0"] * 1e9), int(w["t1"] * 1e9), spans)
        data = {**w, "trace": dt, "peaks": counts.PEAKS, "config": config, "mix": mix, "family": drv.family}
        metrics = {}
        for m in specs.per_layer(workload):
            value = specs.reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=dt.busy_s, window_s=dt.window_s)
        out["breakdown"] = {"device_ops": dt.top_ops(), "idle_gaps": dt.idle_gaps()}
    correct, checks = judge(numbers, specs.limits(workload), log)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']}; worst at {c['at']})", file=log)
    return {"correct": correct, **out, "metrics": metrics, "device": device_info, "checks": checks}
