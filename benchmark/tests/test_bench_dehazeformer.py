"""The DehazeFormer-B configuration on the CPU: the family's plain reference
against the published code's mirror (``tests/dehazeformer_oracle.py``), the
configuration's ``init`` names, the window attention kernel's least time by
hand, and one run of ``dehazeformer_b.bulk.620x460`` at a tiny mix of its
own: correct, and not correct with the Q half of one block's QK weight
negated (which turns that block's attention scores around)."""

import importlib.util
import math
import os

import pytest
import torch

import bench_util
from harness import counts, runner
from harness.specs import Specs

CELL = "dehazeformer_b.bulk.620x460"
TINY = dict(image_h=44, image_w=60, distinct_images=4, bucket=4, batch_sizes=[1, 2], depth=2, check_images=3)
SEED = 2**31 + 7


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _oracle():
    path = bench_util.ROOT / "tests" / "dehazeformer_oracle.py"
    spec = importlib.util.spec_from_file_location("dehazeformer_oracle", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _family():
    specs = Specs(bench_util.ROOT)
    return specs, specs.family(specs.config("dehazeformer_b")["model"])


def test_reference_matches_the_published_code():
    oracle = _oracle()
    _, family = _family()
    torch.manual_seed(0)
    ref = oracle.DehazeFormer(depths=(4, 2, 4, 2, 2)).eval()
    g = torch.Generator().manual_seed(1)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in ref.state_dict().items()
             if not k.endswith("relative_positions")}
    ref.load_state_dict(state, strict=False)
    x = torch.rand((2, 38, 46, 3), generator=g)  # reflect-padded to 40x48 by both
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2) * 2 - 1).clamp(-1, 1).permute(0, 2, 3, 1)
        got = family.reference(state, x, "running")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_every_init_name_is_a_weight():
    specs, family = _family()
    config = specs.config("dehazeformer_b")
    names = family.template().state_dict()
    assert set(config["init"]) <= set(names)
    assert sum(v.numel() for v in names.values()) == config["parameters"]
    # every block's convs are named, and every RLN's six leaves
    assert sum(k.endswith("norm1.meta1.bias") for k in config["init"]) == 24
    assert sum(k.endswith("mlp.mlp.2.weight") for k in config["init"]) == sum(config["depths"])


def test_wattn_bound_by_hand():
    specs, family = _family()
    config = specs.config("dehazeformer_b")
    # 8x460x620: stage 1 at 460x620 (padded 464x624), 4 blocks, C 24; stage 2 at
    # 230x310 (232x312), 8 blocks, C 48; stage 3 at 115x155 (120x160), 12 blocks, C 96
    per_stage = []
    for c, h, w, hp, wp, blocks in ((24, 460, 620, 464, 624, 4), (48, 230, 310, 232, 312, 8),
                                    (96, 115, 155, 120, 160, 12)):
        ops = 4 * 64 * c * 8 * hp * wp
        nbytes = 2 * 4 * c * 8 * h * w
        assert family.wattn_ops_bytes(c, 8, h, w) == (ops, nbytes)
        per_stage.append(blocks * max(ops / 989e12, nbytes / 3.35e12))
    want = sum(per_stage) / 24
    assert family.wattn_mean_bound_s(config, (8, 460, 620)) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(1.43843e-3 / 24, rel=1e-4)  # bytes-bound: 1.44 ms a batch of 8
    assert counts.PEAKS["bf16_flops"] == 989e12 and counts.PEAKS["hbm_bytes_s"] == 3.35e12


def _specs(negate_q=False):
    specs = Specs(bench_util.ROOT)
    full = specs.traffic
    specs.traffic = lambda name: {**full(name), **TINY}
    if negate_q:
        load = specs.family

        def family(model):
            module = load(model)
            program = module.program

            def broken(weights, device, mix):
                prog = program(weights, device, mix)
                qk = prog.layer3.blocks[4].attn.QK.weight
                with torch.no_grad():
                    qk[:qk.shape[0] // 2].neg_()
                return prog

            module.program = broken
            return module

        specs.family = family
    return specs


def test_a_tiny_run_is_correct_and_a_negated_query_is_not():
    with open(os.devnull, "w") as log:
        sound = runner.run_cell(_specs(), CELL, SEED, 1.0, True, "cpu", log=log)
        broken = runner.run_cell(_specs(negate_q=True), CELL, SEED, 1.0, False, "cpu", log=log)
    assert sound["correct"] is True, sound["checks"]
    assert all(math.isfinite(c["value"]) for c in sound["checks"].values()), sound["checks"]
    assert {"mfu.bulk", "device_idle.bulk", "forward_host_ms.bulk"} <= set(sound["metrics"]), sound["metrics"]
    assert "wattn_roofline.bulk" not in sound["metrics"]  # the CPU runs no kernel
    assert broken["correct"] is False, broken["checks"]
