"""On the card: each cell of BENCHMARK.json runs through ``run.py`` with a
short window, prints one result line with the contract's keys, and comes
out correct. Skipped without a CUDA device (decided inside the fixture)."""

import json
import subprocess
import sys

import pytest

import bench_util
from harness.specs import Specs

CELLS = [c["name"] for c in Specs(bench_util.ROOT).doc["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", str(trace)], capture_output=True, text=True, timeout=900,
                         cwd=str(bench_util.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert "setup_s" in line["metrics"]
