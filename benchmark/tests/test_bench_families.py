"""Model families found by name (``models/<model>.py``, ``Specs.family``).

The readings are pinned to those of the harness before its per-model code
moved into family files (commit 73a1eea), taken on the CPU with 2 threads:
each family's weight layout (names, shapes, init ranges), the FLOP counts
that ``mfu.bulk`` and ``mfu.train`` divide by, and the check numbers of
one run of each cell at tiny sizes. A whole benchmark of a model family
that the repository does not have, built from files alone, comes out
correct, and not correct with one weight's sign flipped."""

import hashlib
import json
import math
import os
import time

import pytest
import torch

import bench_util
from harness import cells, counts, runner, weights
from harness.specs import Specs

SEED = 2**31 + 7

# (leaves, elements, sha256 of the JSON list of [name, shape, centre, half width])
LAYOUTS = {
    "fdgan": (657, 14072211, "7b52efbe5efa6bbc59a85f33bca98bff757aafe6e18b6ead97282e2b192544ec"),
    "fdgan_d": (19, 2773569, "55c609441d8038bd863246ec08a7c97d529eaa45da06e224d30308b58cb4e121"),
    "dcpdn": (690, 66966186, "48ed3f2eaacbb55fada472ad92cf862bb7a01012ffa052c90e583a4131352ce8"),
}
# counts.forward_flops at each image cell's count_hw, one image
FORWARD_FLOPS = {"fdgan.bulk.620x460": 600669069312, "fdgan.serve.poisson": 600669069312,
                 "dcpdn.bulk.512": 58773377024}
# counts.train_step_flops at the training cell's tiny (2×32²) and own (8×256²) sizes
TRAIN_FLOPS = {(2, 32): 13961134080, (8, 256): 3678073257984}
# every number the check read; the bulk windows on a clock that moves on
# 50 ms at every reading, so that they hold the same answers however fast
# the CPU runs (the open loop's requests and its sample are fixed by the seed)
CHECKS = {
    "fdgan.bulk.620x460": {"rms_gap_ratio": 1.1651706713174892, "rms_gap_levels": 0.6666331743239351,
                           "answers_missing": 0},
    "dcpdn.bulk.512": {"rms_gap_ratio": 1.178556857883998, "rms_gap_levels": 0.473796578424397,
                       "answers_missing": 0},
    "fdgan.train.8x256": {
        "loss_gap": 0.02477323921826124, "loss_gap.step1": 0.008428798722020112,
        "grad_gap.g": 0.18978759998969572, "grad_gap.g.median": 0.010898528435708587,
        "change_gap.g": 0.0820627977089906, "change_gap.g.median": 0.010353586709370402,
        "stats_gap.g": 0.006937282617273713, "stats_gap.g.median": 0.0009857577962072385,
        "grad_gap.d": 0.04814779413344002, "grad_gap.d.median": 0.008836035693874237,
        "change_gap.d": 0.03581786874463306, "change_gap.d.median": 0.009585384650581067},
    "fdgan.serve.poisson": {"rms_gap_ratio": 1.187555244152672, "rms_gap_levels": 0.770546073268765,
                            "answers_missing": 0},
}
SECONDS = {"fdgan.bulk.620x460": 1.0, "dcpdn.bulk.512": 1.0, "fdgan.train.8x256": 0.5, "fdgan.serve.poisson": 1.5}


class _SteppedClock:
    """``time.time()`` that moves on by ``step`` seconds at every call; the
    rest of ``time`` as it is."""

    def __init__(self, step: float):
        self.now, self.step = time.time(), step

    def time(self) -> float:
        self.now += self.step
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _layout(specs, model):
    init = specs.config(model).get("init", {}) if model != "fdgan_d" else {}
    return weights.spec(specs.family(model).template(), {k: tuple(v) for k, v in init.items()})


@pytest.mark.parametrize("model", sorted(LAYOUTS))
def test_layouts_are_pinned(model):
    layout = _layout(Specs(bench_util.ROOT), model)
    digest = hashlib.sha256(json.dumps([[n, list(s), c, h] for n, s, c, h in layout]).encode()).hexdigest()
    assert (len(layout), sum(math.prod(s) for _, s, _, _ in layout), digest) == LAYOUTS[model]


def test_flop_counts_are_pinned():
    specs = Specs(bench_util.ROOT)
    for cell, want in FORWARD_FLOPS.items():
        entry = specs.workload(cell)
        config, mix = specs.config(entry["config"]), specs.traffic(entry["traffic"])
        mult = config["multiple"]
        hw = (-(-mix["image_h"] // mult) * mult, -(-mix["image_w"] // mult) * mult)
        assert counts.forward_flops(specs.family(config["model"]), _layout(specs, config["model"]), 1, *hw) == want
    lw = specs.traffic("train.8x256")["loss_weights"]
    g, d = _layout(specs, "fdgan"), _layout(specs, "fdgan_d")
    for (batch, size), want in TRAIN_FLOPS.items():
        assert counts.train_step_flops(g, d, batch, size, size, lw) == want


@pytest.mark.parametrize("cell", sorted(CHECKS))
def test_check_numbers_are_pinned(monkeypatch, cell):
    specs = bench_util.tiny_specs()
    if cell.split(".")[1] == "bulk":
        monkeypatch.setattr(cells, "time", _SteppedClock(0.05))
    numbers = {}
    with open(os.devnull, "w") as log:
        runner.run_cell(specs, cell, SEED, SECONDS[cell], False, "cpu", log=log, numbers_out=numbers)
    assert {k: v for k, (v, _) in numbers.items()} == CHECKS[cell]


# --- a model family the repository does not have, from files alone ----------------------------

TOY = '''"""A two-convolution dehazer: the program's module and forward, and its
plain reference."""

import torch
from torch import nn

from harness import reference as plain
from harness.cells import DTYPES

SIGN = {sign}  # -1: the program's second convolution runs with its weight negated


class Toy(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(8, 3, 3, padding=1, device=device)

    def forward(self, x):
        return torch.tanh(self.conv2(torch.relu(self.conv1(x.permute(0, 3, 1, 2))))).permute(0, 2, 3, 1)


def template():
    return Toy(device="meta")


def program(weights, device, mix):
    model = Toy(device="meta")
    model.load_state_dict({{**weights, "conv2.weight": SIGN * weights["conv2.weight"]}}, assign=True)
    return model.eval()


def forward(prog, x, mix):
    return prog(x.float().div(255.0).to(DTYPES[mix["precision"]]))


def reference(p, x, bn_mode="running", q=plain.identity):
    net = plain.Net(p, bn_mode, q)
    h = torch.relu(net.conv(x.permute(0, 3, 1, 2).float(), "conv1", padding=1))
    return torch.tanh(net.conv(h, "conv2", padding=1)).permute(0, 2, 3, 1)


def ops(batch, h, w):
    """2 per multiply-add of the two convolutions."""
    return 2 * batch * h * w * 9 * (3 * 8 + 8 * 3)
'''


def _toy_benchmark(root):
    bench = root / "bench"
    files = {
        "configs/toy.json": json.dumps({"model": "toy", "multiple": 4}),
        "models/toy.py": TOY.format(sign=1),
        "workloads/toy.bulk.json": json.dumps({
            "kind": "bulk_forward", "image_h": 16, "image_w": 20, "distinct_images": 4, "batch": 2, "in_flight": 2,
            "precision": "bf16", "bn_mode": "running", "check_images": 8}),
        "limits/toy.bulk.json": json.dumps({"limits": {"rms_gap_ratio": 5.0, "answers_missing": 0}}),
        "metrics/toy_gflop.bulk.py": "def read(data):\n    return data['family'].ops(*data['launch_shape']) / 1e9\n",
    }
    for name, text in files.items():
        (bench / name).parent.mkdir(parents=True, exist_ok=True)
        (bench / name).write_text(text)
    (root / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "toy", "file": "bench/configs/toy.json"}],
        "workloads": [{"name": "toy.bulk", "config": "toy", "traffic": "toy.bulk", "chips": 1}],
        "end_to_end": [{"name": "img_s", "unit": "img/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "toy_gflop.bulk", "unit": "GFLOP", "moves": "img_s"}],
    }))
    return Specs(root, bench)


def _repository_files():
    out = {}
    for top, dirs, names in os.walk(bench_util.ROOT):
        dirs[:] = [d for d in dirs if d not in (".git", "__pycache__")]
        for n in names:
            st = os.stat(os.path.join(top, n))
            out[os.path.join(top, n)] = (st.st_mtime_ns, st.st_size)
    return out


def test_a_new_family_is_files_alone(tmp_path):
    before = _repository_files()
    specs = _toy_benchmark(tmp_path)
    with open(os.devnull, "w") as log:
        sound = runner.run_cell(specs, "toy.bulk", SEED, 0.5, True, "cpu", log=log)
        assert sound["correct"] is True, sound["checks"]
        assert all(math.isfinite(c["value"]) for c in sound["checks"].values()), sound["checks"]
        # the reader took the operations from the family file
        assert sound["metrics"]["toy_gflop.bulk"]["value"] == 2 * 2 * 16 * 20 * 9 * 48 / 1e9
        (tmp_path / "bench" / "models" / "toy.py").write_text(TOY.format(sign=-1))
        flipped = runner.run_cell(specs, "toy.bulk", SEED, 0.5, False, "cpu", log=log)
    assert flipped["correct"] is False, flipped["checks"]
    assert _repository_files() == before


def test_a_missing_family_is_named():
    with pytest.raises(KeyError, match="no model family 'dehazeformer_b'"):
        Specs(bench_util.ROOT).family("dehazeformer_b")
