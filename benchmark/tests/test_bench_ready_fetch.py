"""ready_fetch_pct.serve: its arithmetic on hand-made ``engine.fetch``
spans, None without them, and a traced CPU run of the serving cell (tiny
sizes) in which it reads a number."""

import pytest
import torch

import bench_util
from harness import runner
from harness.specs import Specs
from harness.trace import DeviceTrace

from fdgan_tpu_torch import trace

MS = 1_000_000
NAME = "ready_fetch_pct.serve"


def _read(data):
    return Specs(bench_util.ROOT).reader(NAME)(data)


def _window(base):
    return {"trace": DeviceTrace([("k", base, base + 40 * MS)], base, base + 100 * MS)}


def test_share_of_ready_fetches_on_hand_made_spans(monkeypatch):
    base = 5_000 * 10**9  # far from any span a real run records
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    for batch, (a, why) in enumerate([(-5, "depth"), (10, "ready"), (20, "depth"), (30, "ready"), (40, "ready"),
                                      (50, "idle"), (60, "ready"), (99, "end"), (120, "ready")]):
        trace.record("engine.fetch", base + a * MS, base + (a + 1) * MS, batch=batch, why=why)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    # the window [0, 100) ms holds 7 of them (not the one before, nor the one after): 4 ready
    assert _read(_window(base)) == pytest.approx(400.0 / 7)


def test_none_without_fetch_spans():
    assert _read(_window(6_000 * 10**9)) is None


def test_a_traced_serving_run_reads_it():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        # long enough that a batch's fetch starts inside the window on a
        # loaded host, where its CPU forward takes a good part of a second
        result = runner.run_cell(bench_util.tiny_specs(), "fdgan.serve.poisson", 2**31 + 13, 3.0, True, "cpu")
    finally:
        torch.set_num_threads(threads)
    # a CPU batch's result is back once dispatched: every fetch is made at the poll after it
    assert result["metrics"][NAME]["value"] == 100.0
