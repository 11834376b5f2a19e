"""The port's halo exchange (``fdgan_tpu_torch/dist/halo_exchange.py``) and
K1's halo rows, on the CPU.

``conv2d_halo_sharded`` runs on 2 and 4 gloo ranks (tests/torch_halo_worker.py,
one launch per world size, each rank on one intra-op thread), each rank on
its block of tests/test_halo_exchange.py's six cases (3×3, 5×5, 3×3 s2, 4×4
s2, the W axis, FDGAN's first encoder conv with its ReLU). Its output is held
against JAX ``conv2d_halo_sharded`` on the forced CPU mesh of as many devices
at that file's atol 1e-5, and its gradients (x, weight, bias) against
``F.conv2d``'s on the whole image. K1's twin with halo rows
(``ops.dense.layer_reference(halo=)``, what ``fused_dense_layer(halo=)`` runs
on the CPU) is held in one process against the twin on the whole image, at
every seam.
"""

import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from fdgan_tpu.dist.halo_exchange import conv2d_halo_sharded as jax_conv2d_halo_sharded
from fdgan_tpu.dist.mesh import make_mesh as jax_make_mesh
from fdgan_tpu_torch.dist import halo_exchange, mesh
from fdgan_tpu_torch.ops import dense

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_halo_worker import CASES, case_inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120  # a rank that hangs in an exchange fails the test
RANK_ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
NAMES = [c[0] for c in CASES]
SPEC = {c[0]: c for c in CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    """(world, each rank's results) of one launch of the worker."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"halo{world}")
    mesh.run_local_ranks([sys.executable, os.path.join(ROOT, "tests", "torch_halo_worker.py"), str(tmp)], world,
                         WORKER_TIMEOUT, env=RANK_ENV)
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=True)["cases"] for r in range(world)]
    shutil.rmtree(tmp)
    return world, res


def _whole(res, name, key):
    d = 1 if SPEC[name][5] == "H" else 2
    return torch.cat([r[name][key] for r in res], dim=d).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_halo_conv_matches_jax(ranks, name):
    world, res = ranks
    _, _, _, pad, stride, dim, relu = SPEC[name]
    x, kernel, bias, _ = case_inputs(name)
    jmesh = jax_make_mesh(n_data=1, n_spatial=world, devices=jax.devices()[:world])
    spec = P(None, "spatial") if dim == "H" else P(None, None, "spatial")
    want = jax_conv2d_halo_sharded({"kernel": kernel, "bias": bias}, jax.device_put(x, NamedSharding(jmesh, spec)),
                                   jmesh, padding=pad, stride=stride, dim=dim)
    want = np.asarray(jax.nn.relu(want) if relu else want)
    got = _whole(res, name, "y")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # one exchange a conv in the forward, one in the backward, and a channels_last result
    assert all(r[name]["forward_exchanges"] == 1 and r[name]["exchanges"] == 2 for r in res)
    assert all(r[name]["channels_last"] for r in res)


@pytest.mark.parametrize("name", NAMES)
def test_halo_conv_gradient_matches_whole_image(ranks, name):
    """d(sum y·ct)/dx, /dw, /db: the ranks' blocks of dx, and the sums of
    their weight and bias shares, against F.conv2d on the whole image."""
    world, res = ranks
    _, _, _, pad, stride, dim, relu = SPEC[name]
    x, kernel, bias, ct = (torch.from_numpy(a) for a in case_inputs(name))
    xw = x.permute(0, 3, 1, 2).requires_grad_(True)
    w = kernel.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    b = bias.clone().requires_grad_(True)
    y = F.conv2d(xw, w, b, stride=stride, padding=pad)
    if relu:
        y = torch.relu(y)
    (y * ct.permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(_whole(res, name, "dx"), xw.grad.permute(0, 2, 3, 1).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sum(r[name]["dw"] for r in res).numpy(), w.grad.numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(sum(r[name]["db"] for r in res).numpy(), b.grad.numpy(), atol=1e-4, rtol=1e-5)


def test_halo_sizes_are_jax():
    from fdgan_tpu.dist.halo_exchange import halo_sizes as jax_halo_sizes

    for k, p, s in [(3, 1, 1), (5, 2, 1), (3, 1, 2), (4, 1, 2), (1, 0, 1), (1, 0, 2), (7, 3, 1)]:
        assert halo_exchange.halo_sizes(k, p, s) == jax_halo_sizes(k, p, s)


# K1's twin with halo rows: the image of H = 40 split at 8, 24 and 32 (whole blocks of 8 rows, uneven), every
# block run with its neighbours' rows (none at the image's ends), against the twin on the whole image. The
# convs sum the same products in both; the bound allows one rounding apart (fp32 1e-6 relative; bf16 one step)
K1_SEAMS = [0, 8, 24, 32, 40]
K1_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=2.0**-8)}


@pytest.mark.parametrize("c", [64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k1_twin_with_halo_rows_matches_the_whole_image(dtype, c):
    rng = np.random.default_rng(c)
    b, h, w = 2, K1_SEAMS[-1], 24

    def t(a):
        return torch.tensor(a, dtype=torch.float32)

    x = t(rng.uniform(size=(b, h, w, c))).to(dtype)
    args = (t(rng.uniform(0.5, 1.5, c)), t(rng.normal(0, 0.3, c)), t(rng.standard_normal((c, 128)) / np.sqrt(c)),
            t(rng.uniform(0.5, 1.5, 128)), t(rng.normal(0, 0.3, 128)),
            t(rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)))
    whole = dense.layer_reference(x, *args).float()
    blocks = []
    for start, stop in zip(K1_SEAMS, K1_SEAMS[1:]):
        xs, top, bottom = dense.halo_buffer(b, stop - start, w, c, device="cpu", dtype=dtype)
        xs.copy_(x[:, start:stop])
        if start > 0:
            top.copy_(x[:, start - 1:start])
        if stop < h:
            bottom.copy_(x[:, stop:stop + 1])
        halo = (top if start > 0 else None, bottom if stop < h else None)
        out = torch.empty((b, stop - start, w, 32), dtype=dtype)
        with torch.inference_mode():
            blocks.append(dense.fused_dense_layer(xs, *args, out=out, halo=halo).float())
    got = torch.cat(blocks, dim=1)
    torch.testing.assert_close(got, whole, **K1_TOL[dtype])
    for seam in K1_SEAMS[1:-1]:  # the rows beside each seam, where a missing halo row would show
        torch.testing.assert_close(got[:, seam - 1:seam + 1], whole[:, seam - 1:seam + 1], **K1_TOL[dtype])


def test_k1_with_halo_rows_refuses_what_it_cannot_take():
    """Rows outside x's buffer raise; a call autograd records gives the
    twin's gradients, the halo row's too (training with H sharded)."""
    c = 64
    x, top, bottom = dense.halo_buffer(1, 8, 16, c, device="cpu", dtype=torch.float32)
    x.uniform_()
    top.uniform_()
    args = (torch.ones(c), torch.zeros(c), torch.zeros(c, 128), torch.ones(128), torch.zeros(128),
            torch.zeros(3, 3, 128, 32))
    with pytest.raises(ValueError, match="halo_buffer"):
        with torch.inference_mode():
            dense.fused_dense_layer(x, *args, halo=(torch.zeros(1, 1, 16, c), None))
    rng = np.random.default_rng(1)
    w1 = torch.tensor(rng.standard_normal((c, 128)) / 8, dtype=torch.float32, requires_grad=True)
    w2 = torch.tensor(rng.standard_normal((3, 3, 128, 32)) / 30, dtype=torch.float32)
    xg, tg = x.clone().requires_grad_(True), top.clone().requires_grad_(True)
    xs, ts, _ = dense._HaloPack.apply(1, xg, tg, bottom.clone())
    dense.fused_dense_layer(xs, args[0], args[1], w1, args[3], args[4], w2, halo=(ts, None)).square().sum().backward()
    got = (w1.grad.clone(), xg.grad, tg.grad)
    w1.grad = None
    xw, tw = x.clone().requires_grad_(True), top.clone().requires_grad_(True)
    dense.layer_reference(xw, args[0], args[1], w1, args[3], args[4], w2, halo=(tw, None)).square().sum().backward()
    for g, want in zip(got, (w1.grad, xw.grad, tw.grad)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
