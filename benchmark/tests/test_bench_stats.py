"""Rates and percentiles over whole windows, with a stall inside one; the
device trace's reduction and K1's roofline arithmetic."""

import pytest

import bench_util
from harness import stats, trace


def test_rate_counts_the_whole_window():
    done = [0.5 * i for i in range(1, 41)]  # one every 0.5 s, 0.5 .. 20.0
    assert stats.rate(done, 0.0, 10.0) == pytest.approx(20 / 10.0)
    # a stall of 5 s in the window: the rate is of all the window, not of its busy chunks
    stalled = [t for t in done if t <= 4.0] + [t + 5.0 for t in done if 4.0 < t <= 5.0]
    assert stats.rate(stalled, 0.0, 10.0) == pytest.approx(10 / 10.0)


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(v[:20], 95) == 19


def test_latency_from_due_time_sees_a_stall():
    # 100 requests due every 10 ms, each served 5 ms after it is due, but a
    # 300 ms stall at t = 0.5 s holds every request due in it until 0.8 s
    due = [0.01 * i for i in range(100)]
    done = [max(u, 0.8) + 0.005 if 0.5 <= u < 0.8 else u + 0.005 for u in due]
    lat = stats.latencies(due, done, 0.0, 1.0, waited_until=61.0)
    assert len(lat) == 100
    assert stats.percentile(lat, 50) == pytest.approx(0.005)
    # 30 requests waited behind the stall: the p95 reads the stall, not the 5 ms service
    assert stats.percentile(lat, 95) > 0.2
    # a request that never completed counts as waiting until the drain's end
    done[3] = None
    assert max(stats.latencies(due, done, 0.0, 1.0, waited_until=61.0)) == pytest.approx(61.0 - 0.03)


def test_device_trace_busy_union_and_gaps():
    ops = [("k1", 100, 200), ("k2", 150, 250), ("k3", 400, 500), ("early", 0, 20), ("late", 950, 1200)]
    t = trace.DeviceTrace(ops, 50, 1000)
    assert t.busy == [(100, 250), (400, 500), (950, 1000)]
    assert t.busy_s == pytest.approx(300e-9)
    assert t.window_s == pytest.approx(950e-9)
    assert t.seconds("k[12]") == pytest.approx(200e-9) and t.count("k") == 3
    gaps = t.idle_gaps(2)
    assert [g[1] for g in gaps] == [pytest.approx(450e-9), pytest.approx(150e-9)]
    assert gaps[0][0] == "after k3"


def test_k1_bound_matches_the_kernel_table():
    from harness import counts

    # PERF.md's kernel table: K1 at 8×512×512×64 bf16 is bound by its operations at 0.191 ms
    assert counts.k1_bound_s({"pixels": 8 * 512 * 512, "c": 64}) == pytest.approx(0.191e-3, rel=2e-3)


def test_k1_roofline_reads_the_configuration_and_the_launch_shape():
    from harness import counts
    from harness.specs import Specs

    specs = Specs(bench_util.ROOT)
    config = specs.config("fdgan")
    bound = counts.k1_mean_bound_s(config, (8, 64, 64))
    n = sum(b["layers"] for b in config["dense_blocks"])
    ops = [(f"dense_layer_bf16_kernel {i}", 1000 * i, 1000 * i + 500) for i in range(n)] + [("other", 0, 10**6)]
    data = {"trace": trace.DeviceTrace(ops, 0, 10**6), "config": config, "launch_shape": (8, 64, 64)}
    read = specs.reader("k1_roofline.bulk")
    assert read(data) == pytest.approx(100.0 * n * bound / (n * 500e-9))
    assert read({**data, "launch_shape": None}) is None
    assert read({**data, "trace": trace.DeviceTrace([("other", 0, 10)], 0, 10**6)}) is None
