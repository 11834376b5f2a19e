"""The port's adversarial train step (fdgan_tpu_torch.train) against the JAX
package's, and the two repairs it needed: K1/K2 as autograd Functions, and
fp32 parameters under bf16 activations.

The JAX reference is one fp32 step of ``make_train_step`` at its default
``impl="xla"``, whose G forward is ``fdgan_fast.apply``, as the port's step
runs ``models/fdgan_fast.py``, at 2×32², computed once per module. G and D cross from ``create_train_state``'s JAX trees; both
sides start from fresh Adam state.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fdgan_tpu.losses.composite import LossWeights as JLossWeights
from fdgan_tpu.models import densenet as jdensenet
from fdgan_tpu.ops import pallas_dense as jpd
from fdgan_tpu.train import loop as jloop
from fdgan_tpu.train.pool import ImagePool as JImagePool
from fdgan_tpu.train.schedule import linear_decay_schedule as jschedule
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.models.densenet import DenseBlock
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.nn.layers import BatchNorm
from fdgan_tpu_torch.ops import dense
from fdgan_tpu_torch.train.loop import clip_grad, create_train_state, make_gd_steps, make_train_step
from fdgan_tpu_torch.train.meters import AverageMeter, MetricLogger
from fdgan_tpu_torch.train.pool import ImagePool
from fdgan_tpu_torch.train.schedule import adjust_learning_rate, linear_decay_schedule

LR = 2e-4
METRICS = ["g_adv", "g_pixel", "g_ssim", "g_total", "d_total", "d_real", "d_fake"]
DEAD = ("conv0.", "dense_block31.", "dense_norm31.", "dense_block4.bn", "dense_block5.bn", "dense_block6.bn",
        "trans_block4.bn", "trans_block5.bn", "trans_block6.bn")


def _batch(b=2, size=32, seed=0):
    """gt uniform, haze = clip(0.6·gt + 0.3), as tests/test_pallas_dense.py:152-153."""
    gt = np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)
    return np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32), gt


def _sd(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _capture_grads():
    """An optax stage that passes the updates on unchanged and keeps them as
    its state: chained ahead of Adam, the step's state then holds the raw
    gradients of the step."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))


def _record_grads(net, opt, into):
    """Keep the gradients that ``opt`` is about to apply, by parameter name."""
    names = {p: n for n, p in net.named_parameters()}

    def hook(optimizer, args, kwargs):
        into.update({names[p]: p.grad.clone() for group in optimizer.param_groups for p in group["params"]
                     if p.grad is not None})

    opt.register_step_pre_hook(hook)


@pytest.fixture(scope="module")
def parity():
    jstate, jtx_g, jtx_d = jloop.create_train_state(jax.random.PRNGKey(0))
    jtx_g, jtx_d = optax.chain(_capture_grads(), jtx_g), optax.chain(_capture_grads(), jtx_d)
    jstate = jloop.TrainState(step=jstate.step, g_params=jstate.g_params, d_params=jstate.d_params,
                              g_opt=jtx_g.init(jstate.g_params), d_opt=jtx_d.init(jstate.d_params))
    g0, d0 = _sd(jstate.g_params), _sd(jstate.d_params)
    haze, gt = _batch()
    jstep = jloop.make_train_step(jtx_g, jtx_d, JLossWeights(perceptual=0.0))
    jnew, jmetrics = jstep(jstate, jnp.asarray(haze), jnp.asarray(gt), jax.random.PRNGKey(1))
    want = {"metrics": {k: float(v) for k, v in jmetrics.items()},
            "g": _sd(jnew.g_params), "d": _sd(jnew.d_params),
            "grads": {"g": _sd(jnew.g_opt[0]), "d": _sd(jnew.d_opt[0])}}

    state, tx_g, tx_d = create_train_state(0, device="cpu")
    state.g.load_state_dict(g0, strict=True)
    state.d.load_state_dict(d0, strict=True)
    grads = {"g": {}, "d": {}}
    _record_grads(state.g, state.g_opt, grads["g"])
    _record_grads(state.d, state.d_opt, grads["d"])
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0))
    state, metrics = step(state, torch.from_numpy(haze), torch.from_numpy(gt))
    return {"g0": g0, "state": state, "metrics": {k: float(v) for k, v in metrics.items()}, "want": want,
            "grads": grads}


@pytest.mark.parametrize("name", METRICS)
def test_step_metrics_match_jax(parity, name):
    # fp32 on both sides; the sums differ only in order (measured ≤ 4e-7 relative)
    got, want = parity["metrics"][name], parity["want"]["metrics"][name]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _sq_err(got, want):
    return ((got.double() - want.double()) ** 2).sum().item(), (want.double() ** 2).sum().item()


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_gradients_match_jax(parity, net):
    """The gradients the step hands to Adam, against those JAX's step hands
    to optax. Adam's first step hides their size, so this is the check on it.

    D: every tensor within 1e-4 relative L2 (measured ≤ 6e-6). G is
    ill-conditioned at 2×32²: relu kinks and batch BN over few samples in
    the deep blocks. The port's own fp32 gradient moves by 1.4e-3 (relative
    L2, over all of G) when the input moves by 1e-7, and lies 7e-4 from its
    fp64 gradient; against JAX's impl="xla" step it is 4.1e-3 over all of
    G, with 4 of the 282 tensors that have a gradient beyond 1e-2 per
    tensor (conv biases under batch BN, whose gradient is rounding noise
    around 0, the worst). Held at 2e-2 over all of G and
    per tensor on all but 2 % of the tensors. A gradient scaled wrongly
    shows far beyond that: BN statistics detached from the graph read 1.55,
    the adversarial term weighted 1.05 instead of 1 read 3.8e-2."""
    want, got = parity["want"]["grads"][net], parity["grads"][net]
    want = {k: w for k, w in want.items() if "running" not in k}
    # a parameter without a gradient in the port has an all-zero one in JAX
    assert {k for k, w in want.items() if not w.any()} == set(want) - set(got)
    sq = {k: _sq_err(got[k], w) for k, w in want.items() if k in got}
    errs = {k: np.sqrt(d / max(n, 1e-300)) for k, (d, n) in sq.items()}
    total = np.sqrt(sum(d for d, _ in sq.values()) / sum(n for _, n in sq.values()))
    if net == "d":
        assert max(errs.values()) <= 1e-4, errs
    else:
        assert total <= 2e-2, total
        worst = sorted(errs, key=errs.get, reverse=True)
        assert sum(errs[k] > 2e-2 for k in worst) <= 0.02 * len(errs), [(k, errs[k]) for k in worst[:10]]


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_parameters_match_jax(parity, net):
    """Adam's first step moves every parameter by lr·g/(|g| + ε), ±lr where
    |g| ≫ ε whatever |g| is. Where g is rounding noise around 0 (conv biases
    under batch BN, whose true gradient is 0), the two sides' noise can
    differ in sign: a difference of up to 2·lr. Everywhere else the sides
    agree to 1e-6; the noisy share is 0.12 % of G's parameters and 0.003 %
    of D's (measured), held here below 0.5 %."""
    sd = getattr(parity["state"], net).state_dict()
    n = off = 0
    for k, want in parity["want"][net].items():
        if "running" in k:
            continue
        diff = (sd[k] - want).abs()
        assert float(diff.max()) <= 2 * LR + 1e-6, k
        n, off = n + diff.numel(), off + int((diff > 1e-6).sum())
    assert off / n < 5e-3, (off, n)


def test_step_folds_running_stats_as_jax(parity):
    sd = parity["state"].g.state_dict()
    moved = 0
    for k, want in parity["want"]["g"].items():
        if "running" in k:
            torch.testing.assert_close(sd[k], want, atol=1e-6, rtol=1e-6, msg=k)
            moved += int(not torch.equal(want, parity["g0"][k]))
    assert moved > 0
    for k, want in parity["want"]["d"].items():  # D's BN is never folded
        if "running" in k:
            torch.testing.assert_close(parity["state"].d.state_dict()[k], want, rtol=0, atol=0)


def test_dead_parameters_do_not_move(parity):
    """Dead G parameters get no gradient: torch's Adam skips them, optax
    moves them by 0 (tests/test_train.py:53-59)."""
    sd = parity["state"].g.state_dict()
    dead = [k for k in sd if k.startswith(DEAD)]
    assert dead and any(k.startswith("conv0.") for k in dead)
    for k in dead:
        torch.testing.assert_close(sd[k], parity["g0"][k], rtol=0, atol=0, msg=k)
    assert parity["state"].step == 1 and parity["state"].d_updates == 1


def test_gd_steps_with_image_pool():
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0))
    pool = ImagePool(pool_size=2, seed=0)
    haze, gt = (torch.from_numpy(a) for a in _batch(b=1))
    d_before = state.d.model["0"].weight.detach().clone()
    for _ in range(3):
        state, g_metrics, x_hat = g_step(state, haze, gt)
        assert not x_hat.requires_grad
        state, d_metrics = d_step(state, pool.query(x_hat), gt)
        assert np.isfinite(float(g_metrics["g_total"])) and np.isfinite(float(d_metrics["d_total"]))
    assert (state.step, state.d_updates, pool.num_imgs) == (3, 3, 2)
    assert not torch.equal(d_before, state.d.model["0"].weight)


def test_contextual_raises_until_ported():
    _, tx_g, tx_d = create_train_state(0, device="cpu")
    with pytest.raises(NotImplementedError, match="contextual"):
        make_train_step(tx_g, tx_d, LossWeights(contextual=1.0))


# --- schedule, clip, pool, meters -------------------------------------------

@pytest.mark.parametrize("start", [0, 5])
def test_linear_decay_schedule_matches_jax(start):
    port, ref = linear_decay_schedule(2e-4, every=10, start_step=start), jschedule(2e-4, every=10, start_step=start)
    for count in (0, 3, 5, 10, 15, 40):
        assert port(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)


def test_schedule_is_evaluated_at_the_update_count():
    """As tests/test_train.py checks for optax: with decay_every=4 and
    decay_start=2 the lr of the first three updates is 1e-3, the fourth's
    0.75e-3; Adam of a constant gradient moves a weight by lr."""
    _, tx_g, _ = create_train_state(0, lr_g=1e-3, decay_every=4, decay_start=2, device="cpu")
    w = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.Adam([w], lr=1.0, betas=(0.5, 0.999), eps=1e-8)
    moves = []
    for count in range(4):
        before = w.detach().clone()
        w.grad = torch.ones(4)
        tx_g.apply(opt, count)
        moves.append(float((before - w.detach()).abs().mean()))
    np.testing.assert_allclose(moves, [1e-3, 1e-3, 1e-3, 0.75e-3], rtol=1e-3)


def test_adjust_learning_rate():
    lr = adjust_learning_rate(2e-4, 2e-4, 10)
    assert lr == pytest.approx(1.8e-4)
    for _ in range(20):
        lr = adjust_learning_rate(lr, 2e-4, 10)
    assert lr == 0.0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_grad(params + [torch.nn.Parameter(torch.zeros(2))], max_norm)  # a grad-less one too
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_image_pool_draws_as_jax():
    port, ref = ImagePool(pool_size=2, seed=7), JImagePool(pool_size=2, seed=7)
    for i in range(12):
        assert port.query(i) == ref.query(i)
    assert ImagePool(pool_size=0).query("x") == "x"


def test_average_meter():
    m = AverageMeter()
    m.update(2.0)
    m.update(4.0, n=3)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 14.0, 4, 3.5)


def test_metric_logger_writes_jsonl(tmp_path, capsys):
    log = MetricLogger(str(tmp_path / "log" / "train.jsonl"), print_every=2)
    log.log(1, {"g_total": torch.tensor(1.5)})
    log.log(2, {"g_total": 2.5, "note": "x"})
    log.close()
    recs = [json.loads(line) for line in (tmp_path / "log" / "train.jsonl").read_text().splitlines()]
    assert [(r["step"], r["g_total"]) for r in recs] == [(1, 1.5), (2, 2.5)] and recs[1]["note"] == "x"
    assert "step=2" in capsys.readouterr().out


# --- repair: K1 and K2 are differentiable -----------------------------------

def test_k1_k2_outputs_carry_their_functions():
    rng = np.random.default_rng(4)
    c = 32
    args = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (
        rng.uniform(size=(1, 8, 8, c)), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c),
        rng.standard_normal((c, 128)) / np.sqrt(c), rng.uniform(0.5, 1.5, 128), rng.normal(0, 0.3, 128),
        rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128))]
    f = dense.fused_dense_layer(*args)
    m, v = dense.h_batch_stats(*args[:4])
    assert type(f.grad_fn).__name__ == "_FusedLayerBackward"
    assert type(m.grad_fn).__name__ == type(v.grad_fn).__name__ == "_HStatsBackward"
    (f.square().sum() + m.sum() + v.sum()).backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in args)


def test_dense_block_gradients_match_jax_grad():
    """A 2-layer block in batch mode: gradients of every parameter and of x
    against jax.grad through the Pallas kernels (interpret) and their
    custom VJPs. Tighter than tests/test_pallas_dense.py:105's atol 2e-2,
    rtol 1e-3: fp32 on both sides, measured ≤ 1.8e-5 at gradients up to 32."""
    c, layers = 32, 2
    params = jax.tree.map(np.asarray, jdensenet.dense_block_init(jax.random.PRNGKey(5), c, layers))
    x = np.random.default_rng(6).uniform(size=(1, 8, 8, c)).astype(np.float32)
    ct = np.random.default_rng(7).standard_normal((1, 8, 8, c + 32 * layers)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jpd.dense_block_fused(p, xx, mode="batch", interpret=True) * ct)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    want = _sd(g_params)

    block = DenseBlock(c, layers)
    block.load_state_dict(_sd(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    stats = {}
    y, _ = dense.dense_block_fused(list(block.children()), xt, mode="batch", stats_out=stats)
    (y * torch.from_numpy(ct)).sum().backward()
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **tol)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **tol)
    assert sorted(stats) == [f"denselayer{i}.norm{k}" for i in (1, 2) for k in (1, 2)]


# --- repair: fp32 parameters run bf16 activations ---------------------------

@pytest.fixture(scope="module")
def generators():
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    copy = FDGAN(dtype=torch.bfloat16)
    copy.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(8).uniform(size=(2, 16, 16, 3)).astype(np.float32)).bfloat16()
    return model, copy, x


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_fp32_model_runs_bf16_like_its_bf16_copy(generators, mode):
    """At init every BN parameter (1, 0, 0, 1) is exact in bf16, so the fp32
    model, casting each weight at its use, computes what the bf16 copy does."""
    model, copy, x = generators
    with torch.no_grad():
        got, want = model(x, bn_mode=mode), copy(x, bn_mode=mode)
    assert got.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in model.parameters())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fp32_model_with_random_running_stats_runs_bf16(generators):
    """With running statistics that bf16 does not hold exactly, the fp32
    model folds BN from the fp32 statistics and the copy from rounded ones:
    a relative change of up to 2^-9 in each BN's scale and shift, through
    ~60 layers in bf16. Held at a few bf16 steps near |y| = 1 (2^-7):
    atol 3e-2, and a mean difference below 2e-3."""
    _, _, x = generators
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(1.0 + 0.1 * torch.rand(m.running_var.shape, generator=gen))
        copy = FDGAN(dtype=torch.bfloat16)
        copy.load_state_dict(model.state_dict())
        got, want = model(x, bn_mode="running").float(), copy(x, bn_mode="running").float()
    diff = (got - want).abs()
    assert float(diff.max()) <= 3e-2 and float(diff.mean()) <= 2e-3, (float(diff.max()), float(diff.mean()))
