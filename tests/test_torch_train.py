"""The port's adversarial train step (fdgan_tpu_torch.train) against the JAX
package's, and the two repairs it needed: K1/K2 as autograd Functions, and
fp32 parameters under bf16 activations.

The JAX reference is one fp32 step of ``make_train_step`` at its default
``impl="xla"``, whose G forward is ``fdgan_fast.apply``, as the port's step
runs ``models/fdgan_fast.py``, at 2×32², computed once per module, without
and with the contextual term. G and D cross from ``create_train_state``'s
JAX trees; both sides start from fresh Adam state.

The same JAX step, without the contextual term, is also the reference of
the port's data-parallel step: two gloo ranks in subprocesses
(``tests/torch_dist_worker.py``), each on one 1×32² row of the batch, held
at this file's tolerances, with and without remat; and, as the negative
control, the same two ranks with per-rank batch statistics, which must fail
them. Its post-step ``TrainState``, written by JAX's ``save_checkpoint``,
is the JAX checkpoint that ``io/checkpoint.load_jax_checkpoint`` reads and
``cli/train`` resumes from.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fdgan_tpu.io import checkpoint as jcheckpoint
from fdgan_tpu.losses.composite import LossWeights as JLossWeights
from fdgan_tpu.models import densenet as jdensenet
from fdgan_tpu.models import vgg16 as jvgg16
from fdgan_tpu.ops import pallas_dense as jpd
from fdgan_tpu.train import loop as jloop
from fdgan_tpu.train.pool import ImagePool as JImagePool
from fdgan_tpu.train.schedule import linear_decay_schedule as jschedule
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.io import msgpack
from fdgan_tpu_torch.io.checkpoint import (jax_train_state_leaves, load_jax_checkpoint, save_jax_checkpoint,
                                           save_params)
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.models.densenet import DenseBlock
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.models.vgg16 import VGG16
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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 300  # a rank that hangs in a collective fails the test
RANK_ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
# the data-parallel step and the JAX checkpoint are held against the step without the contextual term
NO_VGG = pytest.mark.parametrize("parity", ["no_vgg"], indirect=True)
# batch statistics combined over the ranks in one step's forwards: G's 3 block inputs, 42 new 32-channel
# slices and 42 K2 outputs; D's 3 BNs in each of its 3 forwards
STATS_SITES = 3 + 42 + 42 + 3 * 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_remat.py's fixture): beside the
    suite's other workers, torch's default threads cost the 32² CPU steps
    far more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(scope="module", params=["no_vgg", "contextual"])
def parity(request):
    """One step on each side. ``contextual``: the CX term (weight 1) on
    relu3_3 of a VGG16 from JAX ``vgg16.init``, so that its gradients (amax,
    exp and normalisation over the cosine distances) reach Adam."""
    cx = request.param == "contextual"
    weights = dict(perceptual=0.0, contextual=1.0 if cx else 0.0)
    jvgg = jax.tree.map(np.asarray, jvgg16.init(jax.random.PRNGKey(2))) if cx else None
    jstate, jtx_g, jtx_d = jloop.create_train_state(jax.random.PRNGKey(0))
    jtx_g, jtx_d = optax.chain(_capture_grads(), jtx_g), optax.chain(_capture_grads(), jtx_d)
    jstate = jloop.TrainState(step=jstate.step, g_params=jstate.g_params, d_params=jstate.d_params,
                              g_opt=jtx_g.init(jstate.g_params), d_opt=jtx_d.init(jstate.d_params))
    g0, d0 = _sd(jstate.g_params), _sd(jstate.d_params)
    haze, gt = _batch()
    jstep = jloop.make_train_step(jtx_g, jtx_d, JLossWeights(**weights), jvgg)
    jnew, jmetrics = jstep(jstate, jnp.asarray(haze), jnp.asarray(gt), jax.random.PRNGKey(1))
    want = {"metrics": {k: float(v) for k, v in jmetrics.items()},
            "g": _sd(jnew.g_params), "d": _sd(jnew.d_params),
            "grads": {"g": _sd(jnew.g_opt[0]), "d": _sd(jnew.d_opt[0])}}

    vgg = None
    if cx:
        vgg = VGG16()
        vgg.load_state_dict(state_dict_from_jax(jvgg), strict=True)
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    state.g.load_state_dict(g0, strict=True)
    state.d.load_state_dict(d0, strict=True)
    grads = {"g": {}, "d": {}}
    _record_grads(state.g, state.g_opt, grads["g"])
    _record_grads(state.d, state.d_opt, grads["d"])
    step = make_train_step(tx_g, tx_d, LossWeights(**weights), vgg)
    state, metrics = step(state, torch.from_numpy(haze), torch.from_numpy(gt))
    # JAX's post-step TrainState without the capture stages: create_train_state's own optimiser states
    jax_state = jloop.TrainState(step=jnew.step, g_params=jnew.g_params, d_params=jnew.d_params,
                                 g_opt=jnew.g_opt[1], d_opt=jnew.d_opt[1])
    return {"g0": g0, "d0": d0, "state": state, "tx": (tx_g, tx_d), "want": want, "grads": grads,
            "metrics": {k: float(v) for k, v in metrics.items()}, "jax_state": jax_state}


@pytest.mark.parametrize("name", METRICS + ["g_contextual"])
def test_step_metrics_match_jax(parity, name):
    # fp32 on both sides; the sums differ only in order (measured ≤ 4e-7 relative, g_contextual 1.2e-6)
    if name not in parity["want"]["metrics"]:  # the term is reported only where it is weighted
        assert name not in parity["metrics"]
        return
    _check_metric(parity["metrics"][name], parity["want"]["metrics"][name])


def _check_metric(got, want):
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
    per tensor on all but 2 % of the tensors. With the contextual term G
    reads 4.2e-3 over all of G, 2 tensors beyond 2e-2, and D 5.2e-6 per
    tensor (measured). A gradient scaled wrongly
    shows far beyond that: BN statistics detached from the graph read 1.55,
    the adversarial term weighted 1.05 instead of 1 read 3.8e-2."""
    _check_gradients(parity["grads"][net], parity["want"]["grads"][net], net)


def _check_gradients(got, want, net):
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
    _check_parameters(getattr(parity["state"], net).state_dict(), parity["want"][net])


def _check_parameters(sd, want_sd):
    n = off = 0
    for k, want in want_sd.items():
        if "running" in k:
            continue
        diff = (sd[k] - want).abs()
        assert float(diff.max()) <= 2 * LR + 1e-6, k
        n, off = n + diff.numel(), off + int((diff > 1e-6).sum())
    assert off / n < 5e-3, (off, n)


def test_step_folds_running_stats_as_jax(parity):
    _check_running_stats(parity["state"].g.state_dict(), parity["state"].d.state_dict(), parity)


def _check_running_stats(g_sd, d_sd, parity):
    moved = 0
    for k, want in parity["want"]["g"].items():
        if "running" in k:
            torch.testing.assert_close(g_sd[k], want, atol=1e-6, rtol=1e-6, msg=k)
            moved += int(not torch.equal(want, parity["g0"][k]))
    assert moved > 0
    for k, want in parity["want"]["d"].items():  # D's BN is never folded
        if "running" in k:
            torch.testing.assert_close(d_sd[k], want, rtol=0, atol=0)


def test_dead_parameters_do_not_move(parity):
    """Dead G parameters get no gradient: torch's Adam skips them, optax
    moves them by 0 (tests/test_train.py:53-59)."""
    sd = parity["state"].g.state_dict()
    dead = [k for k in sd if k.startswith(DEAD)]
    assert dead and any(k.startswith("conv0.") for k in dead)
    for k in dead:
        torch.testing.assert_close(sd[k], parity["g0"][k], rtol=0, atol=0, msg=k)
    assert parity["state"].step == 1 and parity["state"].d_updates == 1


# --- the data-parallel step: two gloo ranks, one row each -------------------

@pytest.fixture(scope="module")
def dp(parity, tmp_path_factory):
    """Two ranks of tests/torch_dist_worker.py from the parity step's state,
    rank r on row r of its batch. Returns each rank's runs ("global",
    "remat", "local")."""
    tmp = tmp_path_factory.mktemp("dp")
    haze, gt = _batch()
    torch.save({"g": parity["g0"], "d": parity["d0"], "haze": torch.from_numpy(haze), "gt": torch.from_numpy(gt)},
               tmp / "in.pt")
    mesh.run_local_ranks([sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"), str(tmp / "in.pt"),
                          str(tmp)], 2, WORKER_TIMEOUT, env=RANK_ENV)
    runs = [torch.load(tmp / f"rank{pid}.pt", weights_only=True)["runs"] for pid in range(2)]
    shutil.rmtree(tmp)
    return runs


@NO_VGG
@pytest.mark.parametrize("run", ["global", "remat"])
@pytest.mark.parametrize("name", METRICS)
def test_dp_step_metrics_match_jax(parity, dp, run, name):
    """Rank 0's metrics (averaged over the ranks) are JAX's on the whole
    batch, at the single-process step's tolerance."""
    _check_metric(dp[0][run]["metrics"][name], parity["want"]["metrics"][name])


@NO_VGG
@pytest.mark.parametrize("run", ["global", "remat"])
@pytest.mark.parametrize("net", ["g", "d"])
def test_dp_step_gradients_match_jax(parity, dp, run, net):
    """The gradients handed to Adam, averaged over the ranks: JAX's on the
    whole batch at test_step_gradients_match_jax's tolerances."""
    _check_gradients(dp[0][run]["grads"][net], parity["want"]["grads"][net], net)


@NO_VGG
@pytest.mark.parametrize("run", ["global", "remat"])
@pytest.mark.parametrize("net", ["g", "d"])
def test_dp_step_parameters_match_jax(parity, dp, run, net):
    _check_parameters(dp[0][run][net], parity["want"][net])


@NO_VGG
@pytest.mark.parametrize("run", ["global", "remat"])
def test_dp_step_folds_running_stats_as_jax(parity, dp, run):
    """The folded statistics are the global batch's, with the global count
    behind each unbiased variance."""
    _check_running_stats(dp[0][run]["g"], dp[0][run]["d"], parity)


@NO_VGG
def test_dp_ranks_hold_one_state_and_issue_their_collectives(parity, dp):
    """Both ranks end each run with the same bits; each took one row. Per
    step: one flattened gradient all-reduce per model, one metrics
    all-reduce per update, and one statistics all-reduce per BN site in the
    forwards (``STATS_SITES``), each with its all-reduce of the cotangents
    in the backward; under remat the backward recomputes the 42 K2 outputs,
    and combines them again (its backward's collectives stay those of the
    first forward)."""
    for run in ("global", "remat"):
        a, b = dp[0][run], dp[1][run]
        assert a["rows"] == b["rows"] == 1
        for net in ("g", "d"):
            assert all(torch.equal(a[net][k], b[net][k]) for k in a[net]), (run, net)
        assert a["collectives"] == b["collectives"]
    c = dp[0]["global"]["collectives"]
    assert c == {"forward": STATS_SITES, "backward": STATS_SITES, "grads": 2, "metrics": 2}
    assert dp[0]["remat"]["collectives"] == c | {"forward": STATS_SITES + 42}
    assert dp[0]["local"]["collectives"] == c | {"forward": 0, "backward": 0}


@NO_VGG
def test_dp_step_with_per_rank_statistics_fails_the_tolerances(parity, dp):
    """The negative control: the same two ranks with per-rank batch
    statistics (torch DDP without SyncBatchNorm) miss JAX's step. The
    metrics and the folded statistics fail the tolerances above."""
    local = dp[0]["local"]
    rel = max(abs(local["metrics"][k] - w) / max(abs(w), 1e-6) for k, w in parity["want"]["metrics"].items())
    assert rel > 1e-4, rel
    with pytest.raises(AssertionError):
        _check_running_stats(local["g"], local["d"], parity)
    with pytest.raises(AssertionError):
        _check_gradients(local["grads"]["g"], parity["want"]["grads"]["g"], "g")


# --- the JAX TrainState checkpoint ------------------------------------------

def _jax_leaves_equal(path, state, tx):
    """The live state, as JAX leaves, against the file's: bit for bit."""
    with open(path, "rb") as f:
        file = msgpack.unpack_leaves(f.read())
    live = jax_train_state_leaves(state, *tx)
    return len(file) == len(live) and all(torch.equal(t.contiguous(), f) for (_, t), f in zip(live, file))


@pytest.fixture(scope="module")
def jax_ckpt(parity, tmp_path_factory):
    """JAX's post-step TrainState through JAX's own save_checkpoint (~200 MB,
    removed after the module)."""
    path = jcheckpoint.save_checkpoint(str(tmp_path_factory.mktemp("jax_ckpt")), parity["jax_state"], step=1)
    yield path
    os.remove(path)


@NO_VGG
def test_jax_checkpoint_loads_as_the_port_step(parity, jax_ckpt):
    """A fresh port state loads JAX's post-step TrainState: every leaf bit
    for bit as JAX wrote it, and the port's own post-step state at this
    file's step tolerances: parameters, running statistics, counts, and the
    Adam moments (mu = (1−β1)·g, sqrt(nu) = sqrt(1−β2)·|g|: the gradients'
    tolerances)."""
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    load_jax_checkpoint(jax_ckpt, state, tx_g, tx_d)
    jleaves = jax.tree.leaves(parity["jax_state"])
    live = jax_train_state_leaves(state, tx_g, tx_d)
    assert len(live) == len(jleaves)
    for (path, t), want in zip(live, jleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want), err_msg=path)
    port = parity["state"]
    assert (state.step, state.d_updates) == (port.step, port.d_updates) == (1, 1)
    for net in ("g", "d"):
        _check_parameters(getattr(state, net).state_dict(), getattr(port, net).state_dict())
        opt, port_opt = getattr(state, f"{net}_opt").state, getattr(port, f"{net}_opt").state
        port_params = dict(getattr(port, net).named_parameters())
        got, want = {}, {}
        for name, p in getattr(state, net).named_parameters():
            q = port_params[name]
            if q not in port_opt:  # no gradient in the port's step: none in JAX's either
                assert not opt[p]["exp_avg"].any() and not opt[p]["exp_avg_sq"].any(), name
                continue
            assert float(opt[p]["step"]) == float(port_opt[q]["step"]) == 1.0
            for key, f in (("exp_avg", torch.clone), ("exp_avg_sq", torch.sqrt)):
                got[f"{key}.{name}"], want[f"{key}.{name}"] = f(opt[p][key]), f(port_opt[q][key])
        _check_gradients(got, want, net)
    _check_running_stats(state.g.state_dict(), state.d.state_dict(), parity)


@NO_VGG
def test_port_jax_checkpoint_round_trip_is_bit_for_bit(parity, tmp_path):
    """Port → .msgpack → port: every tensor, Adam moment and count the same
    bits; a parameter without Adam state comes back with zero moments, and
    the second file is byte for byte the first."""
    port, (tx_g, tx_d) = parity["state"], parity["tx"]
    first = save_jax_checkpoint(str(tmp_path), port, tx_g, tx_d, step=port.step)
    assert first == str(tmp_path / "ckpt_1.msgpack")
    state, tx_g2, tx_d2 = create_train_state(0, device="cpu")
    load_jax_checkpoint(first, state, tx_g2, tx_d2)
    assert (state.step, state.d_updates) == (port.step, port.d_updates)
    for net in ("g", "d"):
        a, b = getattr(state, net), getattr(port, net)
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        opt_a, opt_b = getattr(state, f"{net}_opt").state, getattr(port, f"{net}_opt").state
        for name, p in pa.items():
            entry = opt_b.get(pb[name])
            for key in ("exp_avg", "exp_avg_sq"):
                want = entry[key] if entry else torch.zeros_like(p)
                assert torch.equal(opt_a[p][key], want), (net, name, key)
            assert float(opt_a[p]["step"]) == (float(entry["step"]) if entry else port.step if net == "g"
                                               else port.d_updates)
    second = save_jax_checkpoint(str(tmp_path / "again.msgpack"), state, tx_g2, tx_d2)
    assert open(first, "rb").read() == open(second, "rb").read()
    for path in (first, second):  # ~200 MB each
        os.remove(path)


@pytest.mark.parametrize("schedule", [False, True])
def test_jax_load_checkpoint_reads_the_port_file(tmp_path, schedule):
    """JAX's load_checkpoint reads the port's file against a
    jax.eval_shape(create_train_state) template, every leaf bit for bit.
    With a decaying learning rate (``--annealEvery`` > 0, a start > 0) each
    optimiser holds a schedule's count as well, and both counts round-trip."""
    kw = dict(decay_every=10, decay_start=5) if schedule else {}
    state, tx_g, tx_d = create_train_state(0, device="cpu", **kw)
    state.step, state.d_updates = 7, 6
    path = save_jax_checkpoint(str(tmp_path), state, tx_g, tx_d, step=state.step)
    template = jax.eval_shape(lambda k: jloop.create_train_state(k, **kw)[0], jax.random.PRNGKey(0))
    loaded = jcheckpoint.load_checkpoint(path, template)
    jleaves = jax.tree.leaves(loaded)
    live = jax_train_state_leaves(state, tx_g, tx_d)
    assert len(jleaves) == len(live) == len(jax.tree.leaves(template))
    for (name, t), want in zip(live, jleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want), err_msg=name)
    assert [int(x) for x in jax.tree.leaves((loaded.step, loaded.g_opt, loaded.d_opt)) if np.ndim(x) == 0] == (
        [7, 7, 7, 6, 6] if schedule else [7, 7, 6])
    fresh, fg, fd = create_train_state(0, device="cpu", **kw)
    load_jax_checkpoint(path, fresh, fg, fd)
    assert (fresh.step, fresh.d_updates) == (7, 6) and _jax_leaves_equal(path, fresh, (fg, fd))
    if schedule:  # a file with the schedule's counts does not load where there is no schedule
        plain, pg, pd = create_train_state(0, device="cpu")
        # the schedule's count of G's optimiser stands where D's count is due, and D's count where D's mu begins
        with pytest.raises(ValueError, match=r"leaf d_opt.mu.model.0.bias has shape \(\)"):
            load_jax_checkpoint(path, plain, pg, pd)
    os.remove(path)  # ~200 MB


@pytest.fixture(scope="module")
def fresh_state():
    """A fresh port state with its transforms, and its JAX leaves."""
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    return state, tx_g, tx_d, jax_train_state_leaves(state, tx_g, tx_d)


@pytest.mark.parametrize("case", ["family", "shape", "dtype", "count"])
def test_wrong_jax_checkpoint_raises_naming_the_leaf(fresh_state, tmp_path, case):
    """The leaves are checked in order, so each wrong file holds the state's
    own leaves up to the wrong one: a discriminator's params file (its first
    leaf a kernel where ``step`` is due), a kernel of another shape, a
    ``step`` of another dtype, and a file of one leaf."""
    state, tx_g, tx_d, order = fresh_state
    leaves = [t for _, t in order]
    i = [p for p, _ in order].index("g_params.conv_refin1.kernel")
    path = str(tmp_path / f"{case}.msgpack")
    if case == "family":
        save_params(path, state.d, frozenset())
    else:
        wrong = {"shape": leaves[:i] + [torch.zeros(3, 3, 3, 8)], "dtype": [torch.tensor(0.0)],
                 "count": leaves[:1]}[case]
        with open(path, "wb") as f:
            f.write(msgpack.pack_leaves(wrong))
    match = {"family": r"leaf step has shape", "shape": r"leaf g_params.conv_refin1.kernel has shape \(3, 3, 3, 8\)",
             "dtype": r"leaf step has dtype torch.float32",
             "count": rf"1 leaves, the train state expects {len(order)}"}[case]
    with pytest.raises(ValueError, match=match):
        load_jax_checkpoint(path, state, tx_g, tx_d)


@NO_VGG
def test_cli_resumes_from_a_jax_checkpoint(parity, jax_ckpt, tmp_path, capsys, monkeypatch):
    """cli/train in an exp dir that holds JAX's ckpt_1.msgpack resumes from
    it (the loaded state bit for bit the file's), takes one step on one
    batch and writes ckpt_2.pt; a newer .pt wins over it after that."""
    import h5py

    from fdgan_tpu_torch.cli import train as cli

    ds, exp = tmp_path / "ds", tmp_path / "exp"
    ds.mkdir()
    exp.mkdir()
    haze, gt = _batch()
    for i in range(2):
        with h5py.File(ds / f"{i}.h5", "w") as f:
            f.create_dataset("gt", data=gt[i])
            f.create_dataset("haze", data=haze[i])
    (exp / "ckpt_1.msgpack").write_bytes(open(jax_ckpt, "rb").read())
    loaded = []

    def check(orig):
        def wrapped(path, state, tx_g, tx_d):
            res = orig(path, state, tx_g, tx_d)
            loaded.append((path, _jax_leaves_equal(path, state, (tx_g, tx_d))))
            return res
        return wrapped

    monkeypatch.setattr(cli, "load_jax_checkpoint", check(cli.load_jax_checkpoint))
    args = ["--dataroot", str(ds), "--exp", str(exp), "--imageSize", "32", "--batchSize", "2", "--epochs", "1",
            "--poolSize", "0", "--lambdaPerceptual", "0", "--logEvery", "1", "--device", "cpu"]
    state = cli.main(args)
    assert f"resumed from {exp / 'ckpt_1.msgpack'} at step 1" in capsys.readouterr().out
    assert loaded == [(str(exp / "ckpt_1.msgpack"), True)]
    assert (state.step, state.d_updates) == (2, 2) and (exp / "ckpt_2.pt").exists()
    cli.main(args)
    assert f"resumed from {exp / 'ckpt_2.pt'} at step 2" in capsys.readouterr().out and len(loaded) == 1
    shutil.rmtree(exp)  # three train states of ~200 MB


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
    """Ported now, so a step with ``contextual > 0`` and a VGG16 runs: its
    ``g_contextual`` is ``contextual_loss`` of relu3_3 on the step's own G
    output (rtol 1e-6), the total counts it, and G and D move."""
    from fdgan_tpu_torch.losses.contextual import contextual_loss
    from fdgan_tpu_torch.models.vgg16 import VGG16

    state, tx_g, tx_d = create_train_state(0, device="cpu")
    vgg = VGG16(generator=torch.Generator().manual_seed(2))
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0, contextual=1.0), vgg)
    haze, gt = (torch.from_numpy(a) for a in _batch())
    g_before = state.g.conv_refin3.weight.clone()
    state, metrics, x_hat = g_step(state, haze, gt)
    state, d_metrics = d_step(state, x_hat, gt)
    with torch.no_grad():
        want = contextual_loss(vgg((x_hat + 1.0) * 0.5)[2], vgg(gt)[2])
    torch.testing.assert_close(metrics["g_contextual"], want, rtol=1e-6, atol=0)
    assert all(torch.isfinite(v) for v in list(metrics.values()) + list(d_metrics.values()))
    assert not torch.equal(g_before, state.g.conv_refin3.weight) and state.d_updates == 1


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
    assert type(f.grad_fn).__name__ == "GeneratedBackwardFor_fdgan_fused_dense_layer_defaultBackward"
    assert type(m.grad_fn).__name__ == type(v.grad_fn).__name__ == "GeneratedBackwardFor_fdgan_h_batch_stats_defaultBackward"
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
