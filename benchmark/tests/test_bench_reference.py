"""The plain reference against the port's plain path, at tiny sizes on the
CPU, on the benchmark's own seeded weights: the generator in both BN modes,
the fusion discriminator, the training steps and DCPDN."""

import pytest
import torch

import bench_util
from harness import check, reference, traffic, weights
from harness.specs import Specs

SEED = 2**31 + 41


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(model, overrides=None, salt=0):
    return weights.make(weights.spec(Specs(bench_util.ROOT).family(model).template(), overrides), SEED, "cpu",
                        salt=salt)


@pytest.mark.parametrize("bn_mode", ["running", "batch"])
def test_generator_matches_the_port(bn_mode):
    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.models.fdgan import FDGAN

    p = _weights("fdgan")
    g = FDGAN(device="cpu")
    g.load_state_dict(p)
    x, _ = traffic.hazy_scenes(SEED, 2, 32, 48, "cpu")
    with torch.no_grad():
        want = fdgan_fast.apply(g, x, bn_mode=bn_mode, impl="plain")
        got = reference.fdgan_generator(p, x, bn_mode)
    assert got.std() > 0.1  # the seeded weights give an image, not a constant
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_discriminator_matches_the_port():
    from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator, fusion_apply

    p = _weights("fdgan_d", salt=1)
    d = NLayerDiscriminator(input_nc=9, device="cpu")
    d.load_state_dict(p)
    x, _ = traffic.hazy_scenes(SEED, 2, 40, 40, "cpu")
    with torch.no_grad():
        want = fusion_apply(d, x, impl="plain")
        got = reference.discriminator(p, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_dcpdn_matches_the_port():
    from fdgan_tpu_torch.models.dcpdn import DehazePhysical

    ov = {"tran_dense.refine3.weight": (0.0, 0.01), "tran_dense.refine3.bias": (1.0, 0.1)}
    p = _weights("dcpdn", ov)
    m = DehazePhysical(device="meta")
    m.load_state_dict(p, assign=True)
    x, _ = traffic.hazy_scenes(SEED, 1, 256, 256, "cpu")
    with torch.no_grad():
        want = m(x, bn_mode="running", impl="plain")[0]
        got = reference.dehaze_physical(p, x, "running")
    assert got.std() > 0.1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_training_steps_match_the_port():
    """Three fp32 steps of the port's cli/train step (plain path, ImagePool
    in its fill phase) against the reference's: losses, first gradients and
    changes by the check's own numbers."""
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps
    from fdgan_tpu_torch.train.pool import ImagePool

    gp, dp = _weights("fdgan"), _weights("fdgan_d", salt=1)
    haze, gt = traffic.train_batches(SEED, 3, 2, 32, "cpu")
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    state.g.load_state_dict(gp)
    state.d.load_state_dict(dp)
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0), None, torch.float32, impl="plain")
    pool = ImagePool(50, seed=0)
    leaves = lambda m: {k: v.detach().clone() for k, v in m.state_dict().items()}  # noqa: E731
    before = {"g": leaves(state.g), "d": leaves(state.d)}
    losses, grads = [], None
    for j in range(3):
        h, y = torch.from_numpy(haze[j]), torch.from_numpy(gt[j])
        state, gm, x_hat = g_step(state, h, y)
        state, dm = d_step(state, pool.query(x_hat), y)
        losses.append((float(gm["g_total"]), float(dm["d_total"])))
        if grads is None:
            grads = {part: {n: opt.state[p]["exp_avg"] / 0.5 for n, p in mod.named_parameters() if p in opt.state}
                     for part, mod, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt))}
    prog = {"losses": losses, "grads": grads,
            "change": {k: {n: v - before[k][n] for n, v in leaves(m).items()} for k, m in (("g", state.g),
                                                                                           ("d", state.d))}}
    g, d = {k: v.clone() for k, v in gp.items()}, {k: v.clone() for k, v in dp.items()}
    cfg = {"lr": 2e-4, "betas": (0.5, 0.999), "bn_momentum": 0.1,
           "loss_weights": {"adv": 1.0, "pixel": 100.0, "ssim": 1.0}}
    rl, first = reference.train_steps(g, d, [(torch.from_numpy(haze[j]), torch.from_numpy(gt[j])) for j in range(3)],
                                      cfg)
    ref = {"losses": rl, "grads": first,
           "change": {"g": {k: g[k] - gp[k] for k in g}, "d": {k: d[k] - dp[k] for k in d}}}
    # the first step's losses agree to fp32's rounding; later steps and the
    # gradients by less: the L1 term's sign flips where x̂ ≈ gt within
    # rounding, and Adam's first steps move each weight by ~lr·sign(g)
    for (pg, pd), (rg, rd) in zip(losses[:1], rl[:1]):
        assert pg == pytest.approx(rg, rel=1e-5) and pd == pytest.approx(rd, rel=1e-5)
    # (a small leaf's change, D's 64 first biases, moves by a few elements' flips)
    for name, (value, where) in check.train_numbers(prog, ref).items():
        assert value < (5e-2 if name.startswith("change") else 1e-2), (name, value, where)
