"""The port's contextual loss (fdgan_tpu_torch.losses.contextual) against
JAX ``contextual_loss`` and the torch oracle of the reference's
``ContextualLoss`` (tests/torch_oracle.py), and the generator objective's
contextual term against JAX's, on the CPU. Inputs come from
``np.random.default_rng``; weights from the JAX inits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.losses import composite as jcomposite
from fdgan_tpu.losses.contextual import contextual_loss as jcontextual_loss
from fdgan_tpu.models import discriminators as jdisc
from fdgan_tpu.models import vgg16 as jvgg16
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses import composite
from fdgan_tpu_torch.losses.contextual import contextual_loss
from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator
from fdgan_tpu_torch.models.vgg16 import VGG16
from torch_oracle import ContextualLossOracle

TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 on every side, sums in another order


def _np(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.fixture(scope="module")
def vgg():
    params = jax.tree.map(np.asarray, jvgg16.init(jax.random.PRNGKey(1)))
    model = VGG16()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("seed", [0, 1])
def test_contextual_loss_matches_jax_and_the_oracle(seed):
    """B = 2 maps of 8×8×16: one pair unrelated, one a target plus noise."""
    a = _np(seed, (2, 8, 8, 16), -1, 1)
    b = a + 0.1 * _np(seed + 10, (2, 8, 8, 16), -1, 1) if seed else _np(seed + 10, (2, 8, 8, 16), -1, 1)
    got = contextual_loss(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(jcontextual_loss(jnp.asarray(a), jnp.asarray(b))), **TOL)
    oracle = ContextualLossOracle()(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(b).permute(0, 3, 1, 2))
    np.testing.assert_allclose(float(got), float(oracle), **TOL)
    # a map against itself: every target position's best match is its own, CX at its floor
    assert float(contextual_loss(torch.from_numpy(a), torch.from_numpy(a))) <= float(got)


def test_contextual_loss_is_fp32_for_bf16_features():
    a, b = _np(2, (1, 4, 4, 8), -1, 1), _np(3, (1, 4, 4, 8), -1, 1)
    got = contextual_loss(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    want = contextual_loss(torch.from_numpy(a).bfloat16().float(), torch.from_numpy(b).bfloat16().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_generator_loss_contextual_term_matches_jax(vgg):
    vgg_params, model = vgg
    d_params = jax.tree.map(np.asarray, jdisc.nlayer_init(jax.random.PRNGKey(0), input_nc=9))
    d = NLayerDiscriminator()
    d.load_state_dict(state_dict_from_jax(d_params), strict=True)
    x_hat, gt = _np(4, (2, 32, 32, 3), -1, 1), _np(5, (2, 32, 32, 3))
    weights = dict(adv=0.0, perceptual=0.0, ssim=0.0, contextual=0.5)
    _, jterms = jcomposite.generator_loss(d_params, jnp.asarray(x_hat), jnp.asarray(gt),
                                          jcomposite.LossWeights(**weights), vgg_params)
    with torch.no_grad():
        _, terms = composite.generator_loss(d, torch.from_numpy(x_hat), torch.from_numpy(gt),
                                            composite.LossWeights(**weights), model)
    assert set(terms) == set(jterms) == {"pixel", "contextual", "total"}
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), **TOL, err_msg=k)
