"""The per-layer metrics that read the program's own spans
(``harness/program_spans.py``): their arithmetic on hand-made spans and a
hand-made device trace, None where the program records no such span or has
no recorder, and a traced run of each FD-GAN cell (on the CPU, at tiny
sizes) in which they all read a number."""

import sys

import pytest
import torch

import bench_util
from harness import runner
from harness.specs import Specs
from harness.trace import DeviceTrace

from fdgan_tpu_torch import trace

MS = 1_000_000
SPAN_METRICS = {
    "fdgan.serve.poisson": ("queue_wait_ms.serve", "result_held_ms.serve", "batch_wait_ms.serve",
                            "aged_flush_pct.serve", "fetch_ms.serve", "idle_drain_pct.serve"),
    "fdgan.bulk.620x460": ("stage_ms.bulk", "device_idle_in_engine.bulk"),
    "fdgan.train.8x256": ("g_backward_host_ms.train", "adam_host_ms.train", "device_idle_backward.train",
                          "forward_host_ms.train"),
}
ALL = [m for names in SPAN_METRICS.values() for m in names]


def _read(name, data):
    return Specs(bench_util.ROOT).reader(name)(data)


def _window(base):
    """A 100 ms window at ``base`` ns, the device busy in its first and last
    40 ms: idle over [40, 60) ms."""
    ops = [("k", base, base + 40 * MS), ("k", base + 60 * MS, base + 100 * MS)]
    return {"trace": DeviceTrace(ops, base, base + 100 * MS)}


def _record(monkeypatch, base, spans):
    """Record (name, start ms, end ms, attrs[, parent]) relative to
    ``base`` as the program would while profiled; ``parent`` is the name of
    the latest span before it of that name, the step it is a phase of."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    latest = {}
    for name, a, b, attrs, *parent in spans:
        trace.record(name, base + int(a * MS), base + int(b * MS), **attrs)
        latest[name] = span = trace.spans(base + int(a * MS), base + int(a * MS) + 1, name)[-1]
        if parent:
            span.parent = latest[parent[0]].id
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def test_each_metric_on_hand_made_spans(monkeypatch):
    base = 1_000 * 10**9  # far from any span a real run records
    _record(monkeypatch, base, [
        ("frontend.queue", 1, 2, {"item": 0}), ("frontend.queue", 2, 4, {"item": 1}),
        ("frontend.queue", 3, 6, {"item": 2}), ("frontend.queue", 4, 14, {"item": 3}),
        ("engine.held", 10, 15, {"batch": 0}), ("engine.held", 20, 27, {"batch": 1}),
        ("engine.held", 0, 100, {"batch": 2}),
        ("engine.stage", -10, 5, {"batch": 3, "items": [9], "why": "full"}),  # starts before the window: not its
        ("engine.stage", 30, 50, {"batch": 4, "items": [0, 1, 2], "why": "aged"}),
        ("engine.stage", 70, 74, {"batch": 5, "items": [3, 4], "why": "full"}),  # item 4 was not traced
        ("engine.dispatch", 45, 55, {"batch": 4}),
        ("engine.fetch", 15, 16, {"batch": 0, "why": "depth"}), ("engine.fetch", 27, 30, {"batch": 1, "why": "idle"}),
        ("engine.fetch", 80, 82, {"batch": 4, "why": "depth"}), ("engine.fetch", 90, 94, {"batch": 5, "why": "end"}),
        ("train.g_step", -5, 45, {}), ("train.g_adam", -2, -1, {}, "train.g_step"),  # a step before the window
        ("train.g_step", 0, 50, {}), ("train.g_step", 50, 99, {}),
        ("train.g_forward", 0, 20, {}, "train.g_step"), ("train.g_loss", 20, 35, {}, "train.g_step"),
        ("train.g_backward", 35, 65, {}), ("train.g_backward", 70, 80, {}, "train.g_step"),
        ("train.d_step", 57, 70, {}), ("train.d_forward", 57, 58, {}, "train.d_step"),
        ("train.d_backward", 58, 62, {}),
        ("train.g_adam", 1, 3, {}, "train.g_step"), ("train.g_adam", 51, 53, {}, "train.g_step"),
        ("train.bn_fold", 53, 54, {}, "train.g_step"), ("train.d_adam", 62, 63, {}, "train.d_step"),
        ("train.d_adam", 98, 99, {}),  # no parent: not a phase of a step
    ])
    data = _window(base)
    got = {name: _read(name, data) for name in ALL}
    assert got["queue_wait_ms.serve"] == pytest.approx(2.5)  # median of 1, 2, 3, 10
    assert got["result_held_ms.serve"] == pytest.approx(7.0)  # median of 5, 7, 100
    assert got["stage_ms.bulk"] == pytest.approx(12.0)  # mean of 20 and 4
    # stage ∪ dispatch = [30, 55) ∪ [70, 74); idle [40, 60): 15 ms of 100
    assert got["device_idle_in_engine.bulk"] == pytest.approx(15.0)
    assert got["g_backward_host_ms.train"] == pytest.approx(5.0)  # 10 ms of a step's phase over 2 steps
    # the window's g_adam 2 ms (not the earlier step's) + 2, bn_fold 1, d_adam 1: 6 ms over 2 steps
    assert got["adam_host_ms.train"] == pytest.approx(3.0)
    assert got["forward_host_ms.train"] == pytest.approx(18.0)  # (20 + 15 + 1) ms over 2 steps
    assert got["batch_wait_ms.serve"] == pytest.approx(27.0)  # median of 28, 26, 24, 56
    assert got["aged_flush_pct.serve"] == pytest.approx(50.0)  # 1 of the window's 2 batches
    assert got["fetch_ms.serve"] == pytest.approx(2.5)  # median of 1, 3, 2, 4
    assert got["idle_drain_pct.serve"] == pytest.approx(25.0)  # 1 of 4 fetches
    # g ∪ d backward = [35, 65) ∪ [70, 80); idle [40, 60): 20 ms of 100
    assert got["device_idle_backward.train"] == pytest.approx(20.0)


def test_the_idle_share_clips_spans_to_the_window(monkeypatch):
    base = 2_000 * 10**9
    _record(monkeypatch, base, [("engine.stage", 50, 300, {"batch": 0})])
    data = _window(base)
    # idle [50, 60) of the window; the span's part past its end does not count
    assert _read("device_idle_in_engine.bulk", data) == pytest.approx(10.0)
    assert _read("stage_ms.bulk", data) == pytest.approx(250.0)


def test_none_without_spans(monkeypatch):
    data = _window(3_000 * 10**9)
    assert {name: _read(name, data) for name in ALL} == dict.fromkeys(ALL)
    _record(monkeypatch, 3_000 * 10**9, [("train.g_backward", 1, 2, {})])
    assert _read("g_backward_host_ms.train", data) is None  # no step to count it over
    _record(monkeypatch, 3_000 * 10**9, [("train.g_step", 5, 9, {}), ("train.g_forward", 6, 7, {})])
    assert _read("forward_host_ms.train", data) is None  # the step has no such phase


def test_none_from_a_program_without_the_recorder(monkeypatch):
    base = 4_000 * 10**9
    _record(monkeypatch, base, [("engine.stage", 50, 55, {"batch": 0})])
    monkeypatch.setitem(sys.modules, "fdgan_tpu_torch.trace", None)  # the import then fails
    monkeypatch.delattr(sys.modules["fdgan_tpu_torch"], "trace")
    assert _read("stage_ms.bulk", _window(base)) is None


@pytest.fixture(scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reads_every_span_metric(_threads, cell):
    # serving: long enough that a batch's fetch starts inside the window on
    # a loaded host, where its CPU forward takes a good part of a second
    seconds = 3.0 if cell == "fdgan.serve.poisson" else 1.0
    result = runner.run_cell(bench_util.tiny_specs(), cell, 2**31 + 11, seconds, True, "cpu")
    for name in SPAN_METRICS[cell]:
        assert result["metrics"][name]["value"] >= 0, name
