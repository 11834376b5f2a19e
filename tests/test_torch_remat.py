"""Gradient accumulation and rematerialisation in the port's train step.

``accum_steps=2`` against JAX ``make_train_step(accum_steps=2)`` (its
``lax.scan`` over microbatches, ``fdgan_tpu/train/loop.py:162-194``): one
fp32 step at 2×32², the losses, the gradients handed to Adam, the updated
parameters and the folded running statistics, at ``tests/test_torch_train.py``'s
tolerances but for G's per-tensor gradient bound (single-image microbatches;
measured, in its test). The JAX state is the port's seed-0 state carried onto
``jax.eval_shape`` trees, so no ``fdgan.init`` runs; the JAX step is
compiled once per module. Then ``remat`` True and ``"stages"`` against no
remat in both impls: the same losses, gradients and folded statistics.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fdgan_tpu.io.torch_import import FDGAN_TRANSPOSED, convert_state_dict
from fdgan_tpu.losses.composite import LossWeights as JLossWeights
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models.discriminators import nlayer_init
from fdgan_tpu.train import loop as jloop
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.models import fdgan_fast
from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

LR = 2e-4
METRICS = ["g_adv", "g_pixel", "g_ssim", "g_total", "d_total", "d_real", "d_fake"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module. The port's CPU steps at 32² gain
    nothing from more, and beside the suite's other workers their thread
    barriers cost far more than the work: a step that takes ~1 s alone took
    100-200 s in the parallel tier-1 run with torch's default threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(b=2, size=32, seed=0):
    gt = np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)
    return np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32), gt


def _sd(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _capture_grads():
    """An optax stage that keeps the updates it passes on as its state."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def seed0():
    """The port's seed-0 train state and transforms; each step runs on a copy."""
    return create_train_state(0, device="cpu")


def _port_step(seed0, impl="kernels", remat=False, accum_steps=1, b=2):
    """One fp32 step of the port from a copy of the seed-0 state on b
    images: (state, metrics, the gradients handed to G's and D's Adam)."""
    state, tx_g, tx_d = copy.deepcopy(seed0[0]), seed0[1], seed0[2]
    grads = {"g": {}, "d": {}}
    for net, opt in (("g", state.g_opt), ("d", state.d_opt)):
        names = {p: n for n, p in getattr(state, net).named_parameters()}

        def hook(optimizer, args, kwargs, into=grads[net], names=names):
            into.update({names[p]: p.grad.clone() for group in optimizer.param_groups for p in group["params"]
                         if p.grad is not None})

        opt.register_step_pre_hook(hook)
    haze, gt = _batch(b)
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), impl=impl, remat=remat, accum_steps=accum_steps)
    state, metrics = step(state, torch.from_numpy(haze), torch.from_numpy(gt))
    return state, {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def accum(seed0):
    state = seed0[0]
    g0 = {k: v.numpy() for k, v in state.g.state_dict().items()}
    d0 = {k: v.numpy() for k, v in state.d.state_dict().items()}
    key = jax.random.PRNGKey(0)
    g_params = convert_state_dict(g0, jax.eval_shape(jfdgan.init, key), transposed=FDGAN_TRANSPOSED)
    d_params = convert_state_dict(d0, jax.eval_shape(lambda k: nlayer_init(k, input_nc=9), key))
    # create_train_state's Adam (loop.py:62-65), behind a stage that keeps the raw gradients
    tx_g, tx_d = (optax.chain(_capture_grads(), optax.adam(LR, b1=0.5, b2=0.999)) for _ in range(2))
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                              g_opt=tx_g.init(g_params), d_opt=tx_d.init(d_params))
    haze, gt = _batch()
    jstep = jloop.make_train_step(tx_g, tx_d, JLossWeights(perceptual=0.0), accum_steps=2)
    jnew, jmetrics = jstep(jstate, jnp.asarray(haze), jnp.asarray(gt), jax.random.PRNGKey(1))
    want = {"metrics": {k: float(v) for k, v in jmetrics.items()}, "g": _sd(jnew.g_params),
            "d": _sd(jnew.d_params), "grads": {"g": _sd(jnew.g_opt[0]), "d": _sd(jnew.d_opt[0])}}
    state, metrics, grads = _port_step(seed0, accum_steps=2)
    return {"g0": {k: torch.from_numpy(v.copy()) for k, v in g0.items()}, "state": state, "metrics": metrics,
            "grads": grads, "want": want}


@pytest.mark.parametrize("name", METRICS)
def test_accum_metrics_match_jax(accum, name):
    got, want = accum["metrics"][name], accum["want"]["metrics"][name]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("net", ["g", "d"])
def test_accum_gradients_match_jax(accum, net):
    """As tests/test_torch_train.py: D every tensor within 1e-4 relative L2,
    G over all of G within 2e-2. G per tensor is worse conditioned than at
    batch 2, since each microbatch is one 32² image and the deepest BNs
    see 16 pixels. Measured: 4.5e-3 over all of G (the port's own gradient
    moves 4.4e-3 when the input moves by 1e-7, JAX's 1.8e-3); 8 of 282
    tensors beyond 2e-2, the largest 4.2e-2 (trans_block1.norm.bias), and
    conv_refine4.bias, whose gradient under batch BN is rounding noise around
    0, at 1.4. Held per tensor at 5e-2 on all but 2 % of the tensors. A
    wrong scale shows far beyond: the sum instead of the mean reads 1.0."""
    want, got = accum["want"]["grads"][net], accum["grads"][net]
    want = {k: w for k, w in want.items() if "running" not in k}
    assert {k for k, w in want.items() if not w.any()} == set(want) - set(got)
    sq = {k: (((got[k].double() - w.double()) ** 2).sum().item(), (w.double() ** 2).sum().item())
          for k, w in want.items() if k in got}
    errs = {k: np.sqrt(d / max(n, 1e-300)) for k, (d, n) in sq.items()}
    total = np.sqrt(sum(d for d, _ in sq.values()) / sum(n for _, n in sq.values()))
    if net == "d":
        assert max(errs.values()) <= 1e-4, errs
    else:
        assert total <= 2e-2, total
        worst = sorted(errs, key=errs.get, reverse=True)
        assert sum(errs[k] > 5e-2 for k in worst) <= 0.02 * len(errs), [(k, errs[k]) for k in worst[:10]]


@pytest.mark.parametrize("net", ["g", "d"])
def test_accum_parameters_match_jax(accum, net):
    """Adam's first step: ≤ 2·lr everywhere, ≤ 1e-6 on all but 0.5 %."""
    sd = getattr(accum["state"], net).state_dict()
    n = off = 0
    for k, want in accum["want"][net].items():
        if "running" in k:
            continue
        diff = (sd[k] - want).abs()
        assert float(diff.max()) <= 2 * LR + 1e-6, k
        n, off = n + diff.numel(), off + int((diff > 1e-6).sum())
    assert off / n < 5e-3, (off, n)


def test_accum_folds_the_mean_of_the_microbatch_moments_as_jax(accum):
    sd = accum["state"].g.state_dict()
    moved = 0
    for k, want in accum["want"]["g"].items():
        if "running" in k:
            torch.testing.assert_close(sd[k], want, atol=1e-6, rtol=1e-6, msg=k)
            moved += int(not torch.equal(want, accum["g0"][k]))
    assert moved > 0


def test_accum_rejects_a_batch_it_does_not_divide(seed0):
    state, tx_g, tx_d = copy.deepcopy(seed0[0]), seed0[1], seed0[2]
    haze, gt = (torch.from_numpy(a) for a in _batch(b=3, size=16))
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), accum_steps=2)
    with pytest.raises(ValueError, match="not divisible by accum_steps 2"):
        step(state, haze, gt)
    assert state.step == 0


@pytest.fixture(scope="module")
def no_remat(seed0):
    return {impl: _port_step(seed0, impl, b=1) for impl in ("kernels", "plain")}


@pytest.mark.parametrize("impl", ["kernels", "plain"])
@pytest.mark.parametrize("remat", [True, "stages"])
def test_remat_changes_nothing(seed0, no_remat, impl, remat):
    """The recompute runs the same fp32 arithmetic: losses, the gradients
    handed to Adam and the folded running statistics as without remat (one
    32² image)."""
    state, metrics, grads = _port_step(seed0, impl, remat, b=1)
    ref_state, ref_metrics, ref_grads = no_remat[impl]
    np.testing.assert_allclose([metrics[k] for k in METRICS], [ref_metrics[k] for k in METRICS], rtol=0, atol=1e-6)
    for net in ("g", "d"):
        assert grads[net].keys() == ref_grads[net].keys()
        for k, g in grads[net].items():
            torch.testing.assert_close(g, ref_grads[net][k], rtol=0, atol=1e-6, msg=k)
    got, want = state.g.state_dict(), ref_state.g.state_dict()
    for k in (k for k in want if "running" in k):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)


def test_remat_rejects_an_unknown_mode(seed0):
    with pytest.raises(ValueError, match="remat must be"):
        fdgan_fast.apply(seed0[0].g, torch.zeros(1, 16, 16, 3), remat="layers")
