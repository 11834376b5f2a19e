"""The control comes out as not correct: the plain reference computed in
fp8 (the next precision below the configuration's bf16), put in the
program's place, fails one of each cell's numbers against the cell's own
limits. Here at a size a CPU test run holds; PERF.md gives the readings at
the cells' own sizes on the card."""

import pytest
import torch

import bench_util
from harness import cells, runner


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["fdgan.bulk.620x460", "fdgan.serve.poisson", "dcpdn.bulk.512",
                                  "fdgan.train.8x256"])
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_control_fails(cell, seed):
    specs = bench_util.tiny_specs()
    entry = specs.workload(cell)
    config, mix = specs.config(entry["config"]), specs.traffic(entry["traffic"])
    with cells.driver(config, mix, seed, torch.device("cpu"), specs.family) as drv:
        numbers = drv.control(2)
    correct, checks = runner.judge(numbers, specs.limits(cell))
    assert not correct, checks
