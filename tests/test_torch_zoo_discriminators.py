"""The port's DCPDN discriminators (``PatchD``, ``BeganD`` of
fdgan_tpu_torch.models.discriminators) against JAX ``patch_d_apply`` and
``began_d_apply`` on the CPU: parameters from ``zoo_params`` over the JAX
inits' structure, inputs from ``np.random.default_rng(0)``, the JAX side
jitted once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.models import discriminators as jdisc
from fdgan_tpu.models.blocks import BNCtx as JBNCtx
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.models.discriminators import BeganD, PatchD
from zoo_params import random_params

FAST_TOL = dict(atol=5e-5, rtol=1e-4)  # tests/test_torch_fdgan_fast.py
MODES = ["batch", "running"]


@pytest.fixture(scope="module")
def case():
    key = jax.random.PRNGKey(0)
    p_params = random_params(lambda: jdisc.patch_d_init(key))
    b_params = random_params(lambda: jdisc.began_d_init(key), seed=1)
    xp = np.random.default_rng(0).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    xb = np.random.default_rng(0).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)

    def patch(p, x, mode):
        col = {}
        return jdisc.patch_d_apply(p, x, JBNCtx(mode, col)), col

    refs, jstats = {}, {}
    for mode in MODES:
        y, col = jax.jit(patch, static_argnums=2)(p_params, jnp.asarray(xp), mode)
        refs[mode], jstats[mode] = np.asarray(y), {k: tuple(np.asarray(t) for t in v) for k, v in col.items()}
    refs["began"] = np.asarray(jax.jit(jdisc.began_d_apply)(b_params, jnp.asarray(xb)))
    patch_d, began_d = PatchD(), BeganD()
    patch_d.load_state_dict(state_dict_from_jax(p_params, frozenset()), strict=True)
    began_d.load_state_dict(state_dict_from_jax(b_params, frozenset()), strict=True)
    return patch_d, began_d, xp, xb, refs, jstats


@pytest.mark.parametrize("mode", MODES)
def test_patch_d_matches_jax(case, mode):
    patch_d, _, xp, _, refs, jstats = case
    got = {}
    with torch.inference_mode():
        y = patch_d(torch.from_numpy(xp), bn_mode=mode, stats_out=got)
    assert y.shape == (1, 30, 30, 1) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), refs[mode], **FAST_TOL)
    assert set(got) == set(jstats[mode]) == ({"main.layer2.bn", "main.layer3.bn"} if mode == "batch" else set())
    for k, (jm, jv) in jstats[mode].items():
        np.testing.assert_allclose(got[k][0].numpy(), jm, atol=1e-4, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k][1].numpy(), jv, atol=1e-4, rtol=1e-4, err_msg=k)


def test_patch_d_keeps_its_fp32_head_in_bf16(case):
    """bf16 activations, fp32 probabilities: a bf16 sigmoid would saturate
    to exactly 0 or 1 (see ``NLayerDiscriminator``)."""
    patch_d, _, xp, _, refs, _ = case
    with torch.inference_mode():
        y = patch_d(torch.from_numpy(xp).bfloat16())
    assert y.dtype == torch.float32 and bool(((y > 0) & (y < 1)).all())
    assert np.abs(y.numpy() - refs["batch"]).max() < 0.05


def test_began_d_matches_jax(case):
    _, began_d, _, xb, refs, _ = case
    with torch.inference_mode():
        y = began_d(torch.from_numpy(xb))
    assert y.shape == xb.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), refs["began"], **FAST_TOL)
