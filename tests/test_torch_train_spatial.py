"""Training with H sharded (``make_train_step(mesh=)``, ``cli/train
--spatialShards``) and the pieces it needs, on the CPU.

In one process: K3's twin with halo rows (``ops.filters.frequency_fuse(halo=)``,
what ``ops.freq.frequency_fuse(halo=)`` runs on the CPU) on 1, 2 and 3 bands
of an image, stitched, against JAX ``fdgan_tpu.ops.filters`` on the whole
image at ``tests/test_torch_filters.py``'s tolerances and bit for bit against
the twin on the whole image, with the gradients of the bands and their halo
rows against the whole image's VJP; K1's twin with halo rows under autograd
(``ops.dense``'s halo Function), x's, the rows' and the weights' gradients
against the whole image's VJP.

On gloo ranks (``tests/torch_spatial_worker.py``, one launch per world size,
each rank on one intra-op thread; the launches run in threads while this
process computes the references): the discriminator's two 4×4 stride-1 tail convs
(``conv2d_halo_sharded``, whose last shard drops the row past the global
output) and SSIM with its halo on 2 and 3 uneven bands against ``F.conv2d``
and ``ssim`` on the whole image; on 1×2, one fp32 train step at full width
(FDGAN, ``NLayerDiscriminator(input_nc=9)``) at 2×64² with
``remat="stages"``, against JAX's ``both`` of
``tests/test_dist.py::test_train_step_sp_grad_parity`` on one device (random
trees over ``jax.eval_shape``, ``tests/zoo_params.py``) at that test's gate,
and against the port's step on the whole batch at a tighter one; the same
step with the halo rows' backward sends dropped, which must fail the gate;
the same 1×2 step with the contextual term (weight 1, a VGG16 of random
weights over ``jax.eval_shape`` of JAX's ``vgg16.init``, no remat) against
JAX's ``both`` with the term on one device and the port's step on the whole
batch, at the same gates, and with each band's term taken alone (no gather,
a local max), which must fail them; the term's collectives alone
(``halo_exchange.gather_rows`` and ``group_amax`` on 2 and 3 uneven bands,
ties included) against the whole tensor's and its gradients; and
``cli/train --spatialShards 2 --lambdaCX 1`` on 2 ranks, whose first logged
step is the port's step on the whole batch.
"""

import concurrent.futures
import json
import os
import shutil
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fdgan_tpu.losses.composite import LossWeights as JLossWeights
from fdgan_tpu.losses.composite import discriminator_loss as jdiscriminator_loss
from fdgan_tpu.losses.composite import generator_loss as jgenerator_loss
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models import fdgan_fast as jfast
from fdgan_tpu.models import vgg16 as jvgg16
from fdgan_tpu.models.discriminators import nlayer_init
from fdgan_tpu.ops import filters as jfilters
from fdgan_tpu.ops.pallas_filters import frequency_fuse_pallas
from fdgan_tpu_torch.data import get_loader
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.losses.contextual import contextual_loss
from fdgan_tpu_torch.models.vgg16 import VGG16
from fdgan_tpu_torch.ops import dense, filters
from fdgan_tpu_torch.ops.ssim import ssim
from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_spatial_worker import CX_FEATURES, collective_inputs, cx_inputs, ssim_inputs, tail_conv, tail_inputs  # noqa: E402,E501
from zoo_params import random_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 300  # a rank that hangs in a collective fails the test
RANK_ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
STEP = (2, 64)     # the train step's batch and image size
CLI = (2, 48)      # cli/train's: the smallest image whose two bands the discriminator's tail takes
F32_TOL = dict(atol=2e-4, rtol=0)  # tests/test_torch_filters.py
NO_VGG = dict(perceptual=0.0)
CX = dict(perceptual=0.0, contextual=1.0)  # the contextual term alone beside the step's other terms
K3_H, K3_W = 40, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_remat.py's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(b, size, seed=0):
    """gt uniform, haze = clip(0.6·gt + 0.3), as tests/test_torch_train.py."""
    gt = np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)
    return np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32), gt


def _write_h5(root, n, size, seed):
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        gt = rng.uniform(size=(size, size, 3)).astype(np.float32)
        with h5py.File(os.path.join(root, f"{i}.h5"), "w") as f:
            f.create_dataset("gt", data=gt)
            f.create_dataset("haze", data=np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32))
    return root


def _workers(tmp, world, extra):
    """The worker on ``world`` ranks: each rank's results."""
    d = tmp / f"w{world}"
    d.mkdir()
    mesh.run_local_ranks([sys.executable, os.path.join(ROOT, "tests", "torch_spatial_worker.py"), str(tmp / "in.pt"),
                          str(d)] + extra, world, WORKER_TIMEOUT, env=RANK_ENV)
    return [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _cli(tmp):
    """cli/train --spatialShards 2 --lambdaCX 1 (a seed-0 VGG16 .pth) on 2
    ranks: rank 0's log, the ranks' output, the data, the VGG16 and what
    rank 1 wrote."""
    ds = _write_h5(str(tmp / "ds"), 4, CLI[1], 0)
    vgg = str(tmp / "vgg16.pth")
    torch.save(VGG16(generator=torch.Generator().manual_seed(0)).state_dict(), vgg)
    exps = [tmp / "exp0", tmp / "exp1"]
    logs = mesh.run_local_ranks(lambda pid: [
        sys.executable, "-m", "fdgan_tpu_torch.cli.train", "--dataroot", ds, "--imageSize", str(CLI[1]),
        "--batchSize", str(CLI[0]), "--epochs", "1", "--exp", str(exps[pid]), "--logEvery", "1",
        "--lambdaPerceptual", "0", "--lambdaCX", "1", "--vggWeights", vgg, "--workers", "0", "--device", "cpu",
        "--spatialShards", "2"],
        2, WORKER_TIMEOUT, env=RANK_ENV, cwd=ROOT)
    with open(exps[0] / "train_log.jsonl") as f:
        return {"log": [json.loads(line) for line in f], "stdout": logs, "ds": ds, "vgg": vgg,
                "exp1": sorted(os.listdir(exps[1]))}


@pytest.fixture(scope="module")
def trees():
    """G's and D's parameters as JAX trees (random, over jax.eval_shape of
    the inits) and as the port's state dicts."""
    gp = random_params(lambda: jfdgan.init(jax.random.PRNGKey(0)), 0)
    dp = random_params(lambda: nlayer_init(jax.random.PRNGKey(1), input_nc=9), 1)
    vp = random_params(lambda: jvgg16.init(jax.random.PRNGKey(2)), 2)
    return {"gp": gp, "dp": dp, "vp": vp, "g": state_dict_from_jax(gp), "d": state_dict_from_jax(dp),
            "vgg": state_dict_from_jax(vp)}


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    """The launches of :func:`_launch`, started in a thread: the ranks run
    beside this process's JAX reference."""
    tmp = tmp_path_factory.mktemp("spatial")
    haze, gt = _batch(*STEP)
    torch.save({"g": trees["g"], "d": trees["d"], "vgg": trees["vgg"], "haze": torch.from_numpy(haze),
                "gt": torch.from_numpy(gt)}, tmp / "in.pt")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        yield {2: pool.submit(_workers, tmp, 2, ["--step"]), 3: pool.submit(_workers, tmp, 3, []),
               "cli": pool.submit(_cli, tmp)}
    shutil.rmtree(tmp)


@pytest.fixture(scope="module")
def launched(ranks, jax_both, port_whole, jax_both_cx, port_whole_cx):
    """The ranks' results, waited for after this process's references."""
    return {k: f.result() for k, f in ranks.items()}


def _jax_both(trees, weights, vgg=None):
    """JAX's G and D losses and gradients on one device, as
    tests/test_dist.py::test_train_step_sp_grad_parity computes them, but
    without JAX's remat, which changes no value there (its note: remat exact
    to 6e-8) and would add ~10 s of compilation to this file's critical path."""
    haze, gt = _batch(*STEP)

    def g_loss_fn(gp, dp, vp, h, g):
        x_hat = jfast.apply(gp, h, stats_out={})
        loss, _ = jgenerator_loss(dp, x_hat, g, JLossWeights(**weights), vp)
        return loss, x_hat

    def both(gp, dp, vp, h, g):
        (g_loss, x_hat), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(gp, dp, vp, h, g)
        d_loss_v, d_grads = jax.value_and_grad(
            lambda d: jdiscriminator_loss(d, jax.lax.stop_gradient(x_hat), g)[0])(dp)
        return g_loss, d_loss_v, g_grads, d_grads

    gl, dl, gg, dg = jax.jit(both)(trees["gp"], trees["dp"], vgg, jnp.asarray(haze), jnp.asarray(gt))
    return {"g_total": float(gl), "d_total": float(dl),
            "grads": {"g": state_dict_from_jax(jax.tree.map(np.asarray, gg)),
                      "d": state_dict_from_jax(jax.tree.map(np.asarray, dg))}}


@pytest.fixture(scope="module")
def jax_both(trees, ranks):
    return _jax_both(trees, NO_VGG)


@pytest.fixture(scope="module")
def jax_both_cx(trees, ranks):
    """:func:`_jax_both` with the contextual term on JAX's VGG16 tree."""
    return _jax_both(trees, CX, trees["vp"])


@pytest.fixture(scope="module")
def port_whole(trees, ranks):
    """The port's step on the whole batch, in this process."""
    return _port_step(trees, *_batch(*STEP))


@pytest.fixture(scope="module")
def port_whole_cx(trees, ranks):
    """The port's step with the contextual term on the whole batch, as the
    ranks run theirs (no remat)."""
    return _port_step(trees, *_batch(*STEP), remat=False, weights=CX)


def _vgg(state_dict):
    vgg = VGG16()
    vgg.load_state_dict(state_dict, strict=True)
    return vgg


def _port_step(trees, haze, gt, **kwargs):
    """One port step; ``kwargs``: ``remat`` ("stages"), ``weights``
    (:data:`NO_VGG`) and ``vgg`` (a state dict; default the trees')."""
    state, tx_g, tx_d = create_train_state(0, device="cpu")
    if trees is not None:
        state.g.load_state_dict(trees["g"], strict=True)
        state.d.load_state_dict(trees["d"], strict=True)
    grads = {"g": {}, "d": {}}
    for net in ("g", "d"):
        names = {p: n for n, p in getattr(state, net).named_parameters()}

        def keep(opt, args, kw, into=grads[net], names=names):
            into.update({names[p]: p.grad.clone() for group in opt.param_groups for p in group["params"]
                         if p.grad is not None})

        getattr(state, f"{net}_opt").register_step_pre_hook(keep)
    weights = kwargs.get("weights", NO_VGG)
    vgg = None
    if weights.get("contextual"):
        vgg = _vgg(kwargs["vgg"] if "vgg" in kwargs else trees["vgg"])
    step = make_train_step(tx_g, tx_d, LossWeights(**weights), vgg, remat=kwargs.get("remat", "stages"))
    _, metrics = step(state, torch.from_numpy(haze), torch.from_numpy(gt))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads}


def _vector(grads, names):
    """The gradients by name as one float64 vector in ``names``' order, zeros
    for a parameter without one (the port's dead parameters)."""
    return torch.cat([torch.as_tensor(grads[k]).double().reshape(-1) if k in grads else
                      torch.zeros(shape, dtype=torch.float64).reshape(-1) for k, shape in names])


def _gate(got, want, net, trees):
    """(relative L2 error, cosine) of two gradients by name, over the whole
    vector of the net's parameters."""
    names = [(k, tuple(v.shape)) for k, v in trees[net].items() if "running" not in k]
    g, w = _vector(got, names), _vector(want, names)
    return float((g - w).norm() / w.norm()), float(g @ w / (g.norm() * w.norm()))


# --- K3's twin with halo rows -----------------------------------------------

def _bands(n):
    return mesh.spatial_rows(K3_H, n)


def _halo(x, start, stop, rows):
    """The ``rows`` rows of x above and below its band [start, stop), None at
    the image's ends."""
    return (x[:, start - rows:start] if start else None, x[:, stop:stop + rows] if stop < x.shape[1] else None)


@pytest.fixture(scope="module")
def k3_refs():
    x = np.random.default_rng(3).uniform(0, 1, (2, K3_H, K3_W, 3)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    # the Pallas kernel runs in fp32 on the bf16 values (tests/test_torch_filters.py)
    return {"x": x, "xla": np.asarray(jfilters.frequency_fuse(jnp.asarray(x))),
            "bf16": np.asarray(frequency_fuse_pallas(jnp.asarray(xb), interpret=True))}


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_twin_with_halo_rows_matches_jax(k3_refs, dtype, n):
    """Bands of 40 rows (40; 24 + 16; 16 + 16 + 8), each with the 7 rows a
    side of its neighbours: stitched, the whole image's bits, and JAX's."""
    x = torch.from_numpy(k3_refs["x"]).to(dtype)
    got = torch.cat([filters.frequency_fuse(x[:, a:b], halo=_halo(x, a, b, filters.BLUR_PAD)) for a, b in _bands(n)],
                    dim=1)
    torch.testing.assert_close(got, filters.frequency_fuse(x), rtol=0, atol=0)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), k3_refs["xla"], **F32_TOL)
    else:  # tests/test_torch_filters.py::test_bf16_matches_pallas_interpreter
        ref = torch.from_numpy(k3_refs["bf16"].copy())
        torch.testing.assert_close(got[..., :3].float(), ref[..., :3], rtol=0, atol=0)
        torch.testing.assert_close(got[..., 6:], ref[..., 6:].bfloat16(), rtol=0, atol=0)
        torch.testing.assert_close(got[..., 3:6].float(), ref[..., 3:6], rtol=0, atol=2.5e-2)


@pytest.mark.parametrize("n", [2, 3])
def test_k3_twin_halo_rows_carry_their_gradients(k3_refs, n):
    """d(sum fuse · ct) of every band and of its halo rows, added where the
    rows belong, is the whole image's VJP, also at the rows beside each
    seam."""
    x = torch.from_numpy(k3_refs["x"])
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal((2, K3_H, K3_W, 9)).astype(np.float32))
    xw = x.clone().requires_grad_(True)
    (filters.frequency_fuse(xw) * ct).sum().backward()
    got = torch.zeros_like(x)
    for a, b in _bands(n):
        band = x[:, a:b].clone().requires_grad_(True)
        top, bottom = (None if r is None else r.clone().requires_grad_(True) for r in _halo(x, a, b, 7))
        (filters.frequency_fuse(band, halo=(top, bottom)) * ct[:, a:b]).sum().backward()
        got[:, a:b] += band.grad
        if top is not None:
            got[:, a - 7:a] += top.grad
        if bottom is not None:
            got[:, b:b + 7] += bottom.grad
    torch.testing.assert_close(got, xw.grad, atol=1e-5, rtol=1e-5)
    for _, seam in _bands(n)[:-1]:
        torch.testing.assert_close(got[:, seam - 8:seam + 8], xw.grad[:, seam - 8:seam + 8], atol=1e-5, rtol=1e-5)


# --- K1's twin with halo rows under autograd --------------------------------

K1_SEAMS = [0, 8, 24, 32, 40]  # tests/test_torch_halo_exchange.py's bands


def test_k1_halo_backward_matches_the_whole_image():
    """``fused_dense_layer(halo=)`` with grad: every band's dx, its halo
    rows' gradients (added to their owners' rows) and the sums of the
    weights' gradients against the whole image's VJP, at atol 1e-5 (rtol
    1e-5 and atol 1e-5 of the largest entry for the weights' sums over
    2·40·24 pixels)."""
    rng = np.random.default_rng(5)
    b, h, w, c = 2, K1_SEAMS[-1], 24, 64

    def t(a):
        return torch.tensor(a, dtype=torch.float32)

    x = t(rng.uniform(size=(b, h, w, c)))
    args = [t(rng.uniform(0.5, 1.5, c)), t(rng.normal(0, 0.3, c)), t(rng.standard_normal((c, 128)) / np.sqrt(c)),
            t(rng.uniform(0.5, 1.5, 128)), t(rng.normal(0, 0.3, 128)),
            t(rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128))]
    ct = t(rng.standard_normal((b, h, w, 32)))
    xw, aw = x.clone().requires_grad_(True), [a.clone().requires_grad_(True) for a in args]
    (dense.layer_reference(xw, *aw) * ct).sum().backward()
    dx, dws = torch.zeros_like(x), [torch.zeros_like(a) for a in args]
    for start, stop in zip(K1_SEAMS, K1_SEAMS[1:]):
        band = x[:, start:stop].clone().requires_grad_(True)
        rows = [(x[:, start - 1:start] if start else torch.zeros(b, 1, w, c)).requires_grad_(True),
                (x[:, stop:stop + 1] if stop < h else torch.zeros(b, 1, w, c)).requires_grad_(True)]
        xs, top, bottom = dense._HaloPack.apply(1, band, *rows)  # x and its rows in one halo_buffer
        ab = [a.clone().requires_grad_(True) for a in args]
        f = dense.fused_dense_layer(xs, *ab, halo=(top if start else None, bottom if stop < h else None))
        (f * ct[:, start:stop]).sum().backward()
        dx[:, start:stop] += band.grad
        if start:
            dx[:, start - 1:start] += rows[0].grad
        if stop < h:
            dx[:, stop:stop + 1] += rows[1].grad
        for acc, a in zip(dws, ab):
            acc += a.grad
    torch.testing.assert_close(dx, xw.grad, atol=1e-5, rtol=1e-5)
    for seam in K1_SEAMS[1:-1]:
        torch.testing.assert_close(dx[:, seam - 1:seam + 1], xw.grad[:, seam - 1:seam + 1], atol=1e-5, rtol=1e-5)
    for got, a in zip(dws, aw):  # sums over 1,920 pixels, in another order: 1e-5 of the tensor's largest entry
        torch.testing.assert_close(got, a.grad, atol=1e-5 * float(a.grad.abs().max()), rtol=1e-5)


# --- on gloo ranks ------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
def test_tail_convs_keep_the_global_rows(launched, world):
    """The two 4×4 stride-1 tail convs over 40 rows in uneven bands (24 +
    16; 16 + 16 + 8): stitched, F.conv2d's 38 rows (the last band yields one
    row fewer at each conv), one exchange a conv each way; x's gradient
    stitched and the weights' summed against F.conv2d's."""
    res = [r["tail"] for r in launched[world]]
    x, w1, b1, w2, b2, ct = (torch.from_numpy(a) for a in tail_inputs())
    xw = x.permute(0, 3, 1, 2).requires_grad_(True)
    ws = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    y = tail_conv(xw, *ws)
    (y * ct.permute(0, 3, 1, 2)).sum().backward()
    got = torch.cat([r["y"] for r in res], dim=1)
    assert got.shape == (x.shape[0], x.shape[1] - 2, x.shape[2] - 2, 4)
    torch.testing.assert_close(got, y.detach().permute(0, 2, 3, 1), atol=1e-6, rtol=0)
    assert all(r["forward_exchanges"] == 2 and r["exchanges"] == 4 for r in res)
    torch.testing.assert_close(torch.cat([r["dx"] for r in res], dim=1), xw.grad.permute(0, 2, 3, 1), atol=1e-5,
                               rtol=1e-5)
    for i, wt in enumerate(ws):
        torch.testing.assert_close(sum(r["dw"][i] for r in res), wt.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 3])
def test_ssim_with_its_halo_adds_up_to_the_whole_image(launched, world):
    """The ranks' SSIM shares add up to ``ssim`` on the whole image; their
    gradients, stitched, are its gradient. One exchange forward and one
    backward, one count all-reduce."""
    res = [r["ssim"] for r in launched[world]]
    a, b = (torch.from_numpy(t) for t in ssim_inputs())
    aw = a.clone().requires_grad_(True)
    s = ssim(aw, b)
    s.backward()
    torch.testing.assert_close(sum(r["share"] for r in res), s.detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.cat([r["da"] for r in res], dim=1), aw.grad, atol=1e-6, rtol=0)
    assert all(r["collectives"]["exchanges"] == 2 and r["collectives"]["counts"] == 1 for r in res)


@pytest.mark.parametrize("name", ["g_total", "d_total"])
def test_spatial_step_losses_match_jax(launched, jax_both, name):
    """The 1×2 step's losses against JAX's on one device: rel 1e-5 (JAX's
    own test_train_step_sp_grad_parity gate); both ranks report them."""
    for r in launched[2]:
        assert r["step"]["metrics"][name] == pytest.approx(jax_both[name], rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("net", ["g", "d"])
def test_spatial_step_gradients_match_jax(launched, jax_both, trees, net):
    """The gradients the sharded step hands to Adam against JAX's: relative
    L2 < 1e-2 and cosine > 0.9999 over the whole vector, JAX's gate for its
    own sharded step (G is ill-conditioned at this size:
    tests/test_torch_train.py measures 1.4e-3 from an input moved by 1e-7)."""
    rel, cos = _gate(launched[2][0]["step"]["grads"][net], jax_both["grads"][net], net, trees)
    assert rel < 1e-2 and cos > 0.9999, (rel, cos)


@pytest.mark.parametrize("net", ["g", "d"])
def test_spatial_step_matches_the_port_step_on_the_whole_batch(launched, port_whole, trees, net):
    """Against the port's own step on the whole batch, tighter: the losses
    at rel 1e-5; D's gradient at relative L2 1e-5 (measured 3e-6), G's at
    5e-3 and cosine 0.99999 (measured 2.6e-3 and 0.9999967: the same
    conditioning, every sum over the bands in another order; against JAX
    4.0e-3 and 0.999992)."""
    step = launched[2][0]["step"]
    for k in ("g_total", "d_total", "g_adv", "g_pixel", "g_ssim", "d_real", "d_fake"):
        assert step["metrics"][k] == pytest.approx(port_whole["metrics"][k], rel=1e-5, abs=1e-6), k
    rel, cos = _gate(step["grads"][net], port_whole["grads"][net], net, trees)
    if net == "d":
        assert rel < 1e-5, rel
    else:
        assert rel < 5e-3 and cos > 0.99999, (rel, cos)


def test_dropped_halo_cotangents_fail_the_gate(launched, jax_both, trees):
    """The negative control: with every halo row's cotangent kept on the rank
    that read it (not sent back to its owner), the forward is the same, and
    G's gradient fails JAX's gate (measured: relative L2 0.40, cosine 0.92)."""
    step, control = launched[2][0]["step"], launched[2][0]["control"]
    assert control["metrics"] == step["metrics"]
    rel, cos = _gate(control["grads"]["g"], jax_both["grads"]["g"], "g", trees)
    assert not (rel < 1e-2 and cos > 0.9999), (rel, cos)


def test_spatial_step_collectives_and_d_rows(launched):
    """Every rank issues the same collectives (so none waits on another), one
    gradient all-reduce per model and one for each update's metrics; D's
    output rows over the bands are the whole image's H/8 − 2."""
    colls = [r["step"]["collectives"] for r in launched[2]]
    assert colls[0] == colls[1] and colls[0]["grads"] == 2 and colls[0]["metrics"] == 2
    assert colls[0]["exchanges"] > 0 and colls[0]["counts"] == 7  # 7 global means: pixel, SSIM, BCE ×3, d_real/fake
    assert sum(r["d_rows"] for r in launched[2]) == STEP[1] // 8 - 2


def test_cli_spatial_shards_first_step_is_the_port_step(launched):
    """cli/train --spatialShards 2 --lambdaCX 1 on 2 gloo ranks (the
    contextual term, once refused with H sharded, now runs): rank 0 logs the
    global values, and its first logged step equals one port step with the
    term (the same seed-0 state and VGG16) on the loader's first whole
    batch, rtol 1e-5; rank 1 writes nothing."""
    cli = launched["cli"]
    assert "spatial sharding: H axis over 2 processes (mesh 1x2); this process holds rows 24:48" in cli["stdout"][1]
    haze, gt = next(iter(get_loader("pix2pix", cli["ds"], 286, CLI[1], batch_size=CLI[0], workers=0, seed=0)))
    want = _port_step(None, np.asarray(haze), np.asarray(gt), remat=False, weights=CX,
                      vgg=torch.load(cli["vgg"], weights_only=True))["metrics"]
    logged = next(r for r in cli["log"] if "g_total" in r)
    assert logged["step"] == 1
    for k in ("g_total", "g_adv", "g_pixel", "g_ssim", "g_contextual", "d_total", "d_real", "d_fake"):
        assert logged[k] == pytest.approx(want[k], rel=1e-5), k
    assert cli["exp1"] == []


# --- the contextual term with H sharded ------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
def test_cx_collectives_match_the_whole_tensor(launched, world):
    """``gather_rows`` of uneven bands is the whole tensor on every rank, and
    a band's gradient the sum of every rank's cotangent on its rows;
    ``group_amax`` over bands is ``torch.amax`` of the whole on every rank,
    and its gradient ``torch.amax``'s VJP of the ranks' summed cotangents,
    ties (values on 4 levels) split evenly across bands, exactly. Two
    gathers (forward and backward) and two max reductions a rank."""
    res = [r["collectives"] for r in launched[world]]
    g, a, ct_g, ct_a = collective_inputs(world)
    g, a = torch.from_numpy(g), torch.from_numpy(a)
    ct_g, ct_a = [torch.from_numpy(c) for c in ct_g], [torch.from_numpy(c) for c in ct_a]
    aw = a.clone().requires_grad_(True)
    (torch.amax(aw, dim=1) * sum(ct_a)).sum().backward()
    assert aw.grad.count_nonzero() > a.shape[0] * a.shape[2]  # more positions than columns: ties are split
    for r in res:
        torch.testing.assert_close(r["gathered"], g, rtol=0, atol=0)
        torch.testing.assert_close(r["amax"], torch.amax(a, dim=1), rtol=0, atol=0)
        assert r["counts"]["gathers"] == 2 and r["counts"]["max_reduces"] == 2
    torch.testing.assert_close(torch.cat([r["dg"] for r in res], dim=1), sum(ct_g), atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.cat([r["da"] for r in res], dim=1), aw.grad, atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", [2, 3])
def test_cx_on_bands_adds_up_to_the_whole_image(launched, world):
    """``contextual_loss`` on bands of two feature maps (N = 240 positions,
    C = 8): the ranks' shares add up to the term on the whole maps, the
    image's and the target's gradients stitched are the whole term's, and
    no tensor the term saves for the backward spans more than its band's
    image positions by the N target positions (the (B, N, N) matrix of the
    whole image is never built; the widest it saves holds N/world of its
    rows, for uneven bands the band's own)."""
    res = [r["cx_alone"] for r in launched[world]]
    img, tgt = (torch.from_numpy(f).requires_grad_(True) for f in cx_inputs())
    whole = contextual_loss(img, tgt)
    whole.backward()
    torch.testing.assert_close(sum(r["share"] for r in res), whole.detach(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(torch.cat([r["di"] for r in res], dim=1), img.grad, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(torch.cat([r["dt"] for r in res], dim=1), tgt.grad, atol=1e-6, rtol=1e-5)
    b, h, w, c = CX_FEATURES
    n = h * w
    for (r0, r1), r in zip(mesh.spatial_rows(h, world), res):
        spanning = [s for s in r["saved"] if s[-1] == n]
        assert spanning and max(s[-2] for s in spanning) == (r1 - r0) * w, r["saved"]
        assert max(np.prod(s) for s in r["saved"]) == b * (r1 - r0) * w * n
        assert r["counts"]["gathers"] == 2 and r["counts"]["max_reduces"] == 2


def _cx_step_ok(step, want, trees, gate):
    """(losses within rel 1e-5 of ``want``'s, G's and D's gradient gates):
    ``gate`` (rel, cos) for both nets."""
    ref = want.get("metrics", want)
    losses = all(step["metrics"][k] == pytest.approx(ref[k], rel=1e-5, abs=1e-5) for k in ("g_total", "d_total"))
    grads = [_gate(step["grads"][net], want["grads"][net], net, trees) for net in ("g", "d")]
    return losses, all(rel < gate[0] and cos > gate[1] for rel, cos in grads), grads


@pytest.mark.parametrize("net", ["g", "d"])
def test_spatial_cx_step_matches_jax(launched, jax_both_cx, trees, net):
    """The 1×2 step with the contextual term against JAX's ``both`` with the
    term on one device: losses at rel 1e-5 on both ranks, the gradients at
    relative L2 < 1e-2 and cosine > 0.9999, JAX's own sharded-step gate."""
    for r in launched[2]:
        for k in ("g_total", "d_total"):
            assert r["cx"]["metrics"][k] == pytest.approx(jax_both_cx[k], rel=1e-5, abs=1e-5), k
    rel, cos = _gate(launched[2][0]["cx"]["grads"][net], jax_both_cx["grads"][net], net, trees)
    assert rel < 1e-2 and cos > 0.9999, (rel, cos)


@pytest.mark.parametrize("net", ["g", "d"])
def test_spatial_cx_step_matches_the_port_step_on_the_whole_batch(launched, port_whole_cx, trees, net):
    """Against the port's step with the term on the whole batch: every loss
    term (the contextual one too: the shares of the two bands add up to the
    whole image's CX) at rel 1e-5; D's gradient at relative L2 1e-5, G's at
    5e-3 and cosine 0.99999 (the gates of the step without the term)."""
    step = launched[2][0]["cx"]
    for k in ("g_total", "g_adv", "g_pixel", "g_ssim", "g_contextual", "d_total", "d_real", "d_fake"):
        assert step["metrics"][k] == pytest.approx(port_whole_cx["metrics"][k], rel=1e-5, abs=1e-6), k
    rel, cos = _gate(step["grads"][net], port_whole_cx["grads"][net], net, trees)
    if net == "d":
        assert rel < 1e-5, rel
    else:
        assert rel < 5e-3 and cos > 0.99999, (rel, cos)


def test_band_local_cx_fails_the_gates(launched, jax_both_cx, port_whole_cx, trees):
    """The negative control: each band's contextual term on the band alone
    (its own target rows, its own max) fails both references' gates."""
    control = launched[2][0]["cx_control"]
    assert control["metrics"]["g_contextual"] != pytest.approx(port_whole_cx["metrics"]["g_contextual"], rel=1e-3)
    for want in (jax_both_cx, port_whole_cx):
        losses, grads, _ = _cx_step_ok(control, want, trees, (1e-2, 0.9999))
        assert not (losses and grads)


def test_spatial_cx_step_collectives(launched):
    """In the step each rank gathers the target's relu3_3 once (it needs no
    gradient: no backward gather) and reduces the max twice (forward and
    backward), and both ranks issue the same collectives."""
    colls = [r["cx"]["collectives"] for r in launched[2]]
    assert (colls[0]["gathers"], colls[0]["max_reduces"]) == (1, 2), colls[0]
    assert colls[0] == colls[1]
