"""The port's FDGAN generator against the JAX package and the torch oracle.

The JAX references are computed once per module: the Pallas-interpret
forward at 2×16² takes some seconds per BN mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.io.torch_import import FDGAN_TRANSPOSED, export_state_dict
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu_torch.io.torch_import import load_torch_state_dict, state_dict_from_jax
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.nn.layers import BatchNorm
from fdgan_tpu_torch.ops import dense
from torch_oracle import FDGANOracle

GEN_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_pallas_dense.py:132


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
def jax_case():
    params = jax.tree.map(np.asarray, jfdgan.init(jax.random.PRNGKey(0)))
    _randomise_running_stats(params, np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    refs = {}
    for mode in ("batch", "running"):
        fwd = jax.jit(lambda p, xx, m=mode: jfdgan.apply(p, xx, bn_mode=m, impl="pallas", interpret=True))
        refs[mode] = np.asarray(fwd(params, jnp.asarray(x)))
    return params, x, refs


def test_state_dict_from_jax_equals_export_state_dict(jax_case):
    params, _, _ = jax_case
    ours = state_dict_from_jax(params)
    theirs = export_state_dict(params, transposed=FDGAN_TRANSPOSED)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = FDGAN()
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_generator_matches_jax_pallas_forward(jax_case, mode):
    params, x, refs = jax_case
    model = FDGAN()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), bn_mode=mode)
        plain = model(torch.from_numpy(x), bn_mode=mode, impl="plain")
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), refs[mode], **GEN_TOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)  # the wrappers take the twins on CPU


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_generator_matches_torch_oracle(mode):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        oracle = FDGANOracle()
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(1.0, 1.1)
    state = {k: v for k, v in oracle.state_dict().items() if not k.endswith("num_batches_tracked")}
    model = FDGAN()
    model.load_state_dict(state, strict=True)
    x = np.random.default_rng(2).uniform(size=(2, 16, 24, 3)).astype(np.float32)
    oracle.train(mode == "batch")
    with torch.inference_mode():
        ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = model(torch.from_numpy(x), bn_mode=mode)
    torch.testing.assert_close(got, ref, **GEN_TOL)


def test_load_torch_state_dict_strips_prefix_and_counters(tmp_path):
    oracle = FDGANOracle()
    path = tmp_path / "netG.pth"
    torch.save({f"module.{k}": v for k, v in oracle.state_dict().items()}, path)
    state = load_torch_state_dict(str(path))
    assert not any(k.startswith("module.") or k.endswith("num_batches_tracked") for k in state)
    FDGAN().load_state_dict(state, strict=True)


def test_init_weights_bounds_and_determinism():
    a = FDGAN(generator=torch.Generator().manual_seed(3))
    b = FDGAN(generator=torch.Generator().manual_seed(3))
    c = FDGAN(generator=torch.Generator().manual_seed(4))
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        if name.endswith("conv_refin6.weight"):
            # conv2d_init's torch-style bound 1/sqrt(fan_in), fan_in = 640·3·3
            bound = 1.0 / np.sqrt(640 * 9)
            assert float(p.abs().max()) <= bound and float(p.abs().max()) > 0.9 * bound
            assert not torch.equal(p, r)
    for m in a.modules():
        if isinstance(m, BatchNorm):
            assert float(m.weight.detach().min()) == 1.0 and float(m.running_var.min()) == 1.0


def test_generator_bf16_and_shape_checks():
    model = FDGAN(dtype=torch.bfloat16)
    x = torch.rand(1, 16, 8, 3, dtype=torch.bfloat16)
    dense.reset_launch_counts()
    with torch.inference_mode():
        y = model(x, bn_mode="running")
    assert y.dtype == torch.bfloat16 and y.shape == (1, 16, 8, 3)
    assert bool(torch.isfinite(y.float()).all()) and float(y.abs().max()) <= 1.0
    assert (dense.k1_launches, dense.k2_launches) == (0, 0)  # CPU: the twins, no launches
    with pytest.raises(ValueError, match="divisible by 8"):
        model(torch.rand(1, 12, 8, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="NHWC"):
        model(torch.rand(1, 3, 16, 16, dtype=torch.bfloat16))
