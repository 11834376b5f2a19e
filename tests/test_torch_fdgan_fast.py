"""The port's fast forward (fdgan_tpu_torch.models.fdgan_fast) against JAX
``fdgan_fast.apply``, against the port's own ``FDGAN.forward``, and behind
the engine.

The JAX references run once per module: ``fdgan_fast`` is XLA, so there is
no Pallas interpret cost. Weights cross with ``state_dict_from_jax``;
running statistics are randomised so that running mode applies a real
affine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models import fdgan_fast as jfast
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.models import fdgan_fast
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.ops import dense, stats
from fdgan_tpu_torch.serve import InferenceEngine

# tests/test_fdgan_fast.py's tolerance for fdgan_fast against fdgan.apply. It
# holds here: both sides are fp32 with the same reassociation, the K1 twin's
# products are fp32 convs, and the measured gap is ~2e-7.
FAST_TOL = dict(atol=5e-5, rtol=1e-4)
MODES = ["batch", "running"]


def _randomise_running_stats(tree, rng):
    """mean ~ N(0, 0.1²), var ~ 1 + U(0, 0.1) for every BN of a JAX tree."""
    if "mean" in tree and "var" in tree:
        tree["mean"] = (0.1 * rng.standard_normal(tree["mean"].shape)).astype(np.float32)
        tree["var"] = (1.0 + 0.1 * rng.uniform(size=tree["var"].shape)).astype(np.float32)
        return
    for child in tree.values():
        if isinstance(child, dict):
            _randomise_running_stats(child, rng)


@pytest.fixture(scope="module")
def case():
    params = jax.tree.map(np.asarray, jfdgan.init(jax.random.PRNGKey(0)))
    _randomise_running_stats(params, np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    refs, jstats = {}, {}
    for mode in MODES:
        collected = {}
        y = jfast.apply(params, jnp.asarray(x), bn_mode=mode, stats_out=collected)
        refs[mode] = np.asarray(y)
        jstats[mode] = {k: tuple(np.asarray(t) for t in v) for k, v in collected.items()}
    model = FDGAN()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, x, refs, jstats


@pytest.mark.parametrize("mode", MODES)
def test_fast_matches_jax_fdgan_fast(case, mode):
    model, x, refs, _ = case
    with torch.inference_mode():
        got = fdgan_fast.apply(model, torch.from_numpy(x), bn_mode=mode)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), refs[mode], **FAST_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_fast_matches_the_module_forward(case, mode):
    """The reassociation (segment statistics, pool before the conv) against
    ``FDGAN.forward``, the counterpart of ``fdgan.apply(impl="pallas")``."""
    model, x, _, _ = case
    with torch.inference_mode():
        fast = fdgan_fast.apply(model, torch.from_numpy(x), bn_mode=mode)
        module = model(torch.from_numpy(x), bn_mode=mode)
    np.testing.assert_allclose(fast.numpy(), module.numpy(), **FAST_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_kernels_on_the_cpu_are_the_plain_path(case, mode):
    """On a CPU tensor the wrappers take their twins: the same bits as
    ``impl='plain'``, and no kernel launch counted."""
    model, x, _, _ = case
    dense.reset_launch_counts()
    stats.reset_launch_count()
    with torch.inference_mode():
        got = fdgan_fast.apply(model, torch.from_numpy(x), bn_mode=mode)
        plain = fdgan_fast.apply(model, torch.from_numpy(x), bn_mode=mode, impl="plain")
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert (dense.k1_launches, dense.k2_launches, stats.launches) == (0, 0, 0)


def test_stats_out_matches_jax(case):
    """The same keys as JAX ``fdgan_fast.apply`` records (every dense layer's
    norm1 and norm2, every transition's norm), with the unbiased
    correction, within 1e-4 (test_fdgan_fast.py's stats tolerance)."""
    model, x, _, jstats = case
    got = {}
    with torch.inference_mode():
        fdgan_fast.apply(model, torch.from_numpy(x), bn_mode="batch", stats_out=got)
    assert set(got) == set(jstats["batch"]) and len(got) == 2 * 42 + 3
    for k, (jm, jv) in jstats["batch"].items():
        np.testing.assert_allclose(got[k][0].numpy(), jm, atol=1e-4, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k][1].numpy(), jv, atol=1e-4, rtol=1e-4, err_msg=k)
    assert jstats["running"] == {}


def test_stats_out_matches_the_module_forward(case):
    model, x, _, _ = case
    fast, module = {}, {}
    with torch.inference_mode():
        fdgan_fast.apply(model, torch.from_numpy(x), bn_mode="batch", stats_out=fast)
        model(torch.from_numpy(x), bn_mode="batch", stats_out=module)
    assert set(fast) == set(module)
    for k, (m, v) in module.items():
        torch.testing.assert_close(fast[k][0], m, atol=1e-6, rtol=1e-5, msg=k)
        torch.testing.assert_close(fast[k][1], v, atol=1e-6, rtol=1e-5, msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_engine_runs_the_fast_forward(case, mode):
    """The engine's forward is ``fdgan_fast.apply`` on its own copy of the
    weights: the same values for the same batch."""
    model, x, _, _ = case
    engine = InferenceEngine(model, device="cpu", precision="fp32", bn_mode=mode, bucket=8, batch_sizes=(2,))
    with torch.inference_mode():
        got = engine._forward(engine._model, torch.from_numpy(x))
        want = fdgan_fast.apply(model, torch.from_numpy(x), bn_mode=mode)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    imgs = [(x[i] * 255).round().astype(np.uint8) for i in range(2)]
    ys = engine.predict_batch(imgs)
    with torch.inference_mode():
        direct = fdgan_fast.apply(model, torch.from_numpy(np.stack(imgs).astype(np.float32) / 255.0), bn_mode=mode)
    np.testing.assert_allclose(np.stack(ys), direct.numpy(), atol=1e-6, rtol=0)


def test_fast_runs_bf16_and_checks_shapes(case):
    model, x, _, _ = case
    with torch.inference_mode():
        y = fdgan_fast.apply(model, torch.from_numpy(x).bfloat16(), bn_mode="batch")
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y.float()).all())
    np.testing.assert_allclose(y.float().numpy(), case[2]["batch"], atol=6e-2)  # bf16 through ~60 layers
    with pytest.raises(ValueError, match="divisible by 8"):
        fdgan_fast.apply(model, torch.zeros(1, 12, 8, 3))
    with pytest.raises(ValueError, match="NHWC"):
        fdgan_fast.apply(model, torch.zeros(1, 3, 16, 16))
    with pytest.raises(ValueError, match="BN mode"):
        fdgan_fast.apply(model, torch.zeros(1, 16, 16, 3), bn_mode="eval")


def test_gradients_flow_through_the_fast_forward(case):
    """The train step differentiates through it: every live parameter of the
    encoder gets a finite gradient, the transitions' included."""
    model, x, _, _ = case
    model.zero_grad(set_to_none=True)
    y = fdgan_fast.apply(model, torch.from_numpy(x[:1]), bn_mode="batch")
    y.square().mean().backward()
    for name in ("dense_block1.denselayer1.conv1.weight", "trans_block1.conv.weight", "trans_block3.norm.weight",
                 "dense_block3.denselayer24.norm1.bias", "conv_refin1.weight"):
        grad = model.get_parameter(name).grad
        assert grad is not None and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0, name
    model.zero_grad(set_to_none=True)
