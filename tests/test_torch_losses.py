"""The port's discriminator, losses, SSIM and VGG16 against the JAX
package's, on the same numpy inputs and the same JAX-made weights carried
across with state_dict_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.losses import composite as jcomposite
from fdgan_tpu.losses import gan as jgan
from fdgan_tpu.losses.perceptual import perceptual_loss as jperceptual
from fdgan_tpu.models import discriminators as jdisc
from fdgan_tpu.models import vgg16 as jvgg16
from fdgan_tpu.ops.ssim import ssim as jssim
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.losses import composite, gan
from fdgan_tpu_torch.losses.perceptual import perceptual_loss
from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator, fusion_apply
from fdgan_tpu_torch.models.vgg16 import VGG16
from fdgan_tpu_torch.ops.ssim import ssim

TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 on both sides, sums in another order
WEIGHTS = dict(perceptual=0.5, ssim=1.0, adv=1.0, pixel=100.0)


def _np(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """JAX weights and inputs, and the JAX results the tests compare with."""
    d_params = jax.tree.map(np.asarray, jdisc.nlayer_init(jax.random.PRNGKey(0), input_nc=9))
    vgg_params = jax.tree.map(np.asarray, jvgg16.init(jax.random.PRNGKey(1)))
    x9 = _np(0, (2, 32, 32, 9))
    x_hat = _np(1, (2, 32, 32, 3), -1.0, 1.0)
    gt = _np(2, (2, 32, 32, 3))
    _, g_terms = jcomposite.generator_loss(d_params, jnp.asarray(x_hat), jnp.asarray(gt),
                                           jcomposite.LossWeights(**WEIGHTS), vgg_params)
    refs = {
        "nlayer": np.asarray(jdisc.nlayer_apply(d_params, jnp.asarray(x9))),
        "fusion": np.asarray(jdisc.fusion_apply(d_params, jnp.asarray(gt))),
        "ssim": float(jssim(jnp.asarray(x_hat * 0.5 + 0.5), jnp.asarray(gt))),
        "vgg": [np.asarray(f) for f in jvgg16.apply(vgg_params, jnp.asarray(gt))],
        "perceptual": float(jperceptual(vgg_params, jnp.asarray(x_hat * 0.5 + 0.5), jnp.asarray(gt))),
        "g_terms": {k: float(v) for k, v in g_terms.items()},
        "d_terms": {k: float(v) for k, v in jcomposite.discriminator_loss(
            d_params, jnp.asarray(x_hat), jnp.asarray(gt), 0.9)[1].items()},
    }
    return d_params, vgg_params, {"x9": x9, "x_hat": x_hat, "gt": gt}, refs


def _d(d_params) -> NLayerDiscriminator:
    d = NLayerDiscriminator()
    d.load_state_dict(state_dict_from_jax(d_params), strict=True)
    return d


def _vgg(vgg_params) -> VGG16:
    vgg = VGG16()
    vgg.load_state_dict(state_dict_from_jax(vgg_params), strict=True)
    return vgg


def _t(a):
    return torch.from_numpy(np.array(a))


def test_state_dict_from_jax_carries_the_discriminator(case):
    d_params, _, _, _ = case
    sd = state_dict_from_jax(d_params)
    assert sorted(sd) == sorted(NLayerDiscriminator().state_dict())
    assert {k.split(".")[1] for k in sd} == {"0", "2", "3", "5", "6", "8", "9", "11"}
    np.testing.assert_array_equal(sd["model.0.weight"].numpy(), d_params["model"]["0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["model.3.running_var"].numpy(), d_params["model"]["3"]["var"])


def test_nlayer_matches_jax(case):
    d_params, _, x, refs = case
    with torch.no_grad():
        got = _d(d_params)(_t(x["x9"]))
    assert got.shape == (2, 2, 2, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), refs["nlayer"], **TOL)


@pytest.mark.parametrize("impl", ["kernels", "plain"])
def test_fusion_apply_matches_jax(case, impl):
    d_params, _, x, refs = case
    with torch.no_grad():
        got = fusion_apply(_d(d_params), _t(x["gt"]), impl)
    np.testing.assert_allclose(got.numpy(), refs["fusion"], **TOL)


def test_discriminator_bf16_keeps_fp32_params_and_head(case):
    d_params, _, x, refs = case
    d = _d(d_params)
    with torch.no_grad():
        got = fusion_apply(d, _t(x["gt"]).bfloat16())
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in d.parameters())
    np.testing.assert_allclose(got.numpy(), refs["fusion"], atol=0.05)  # bf16 activations, probabilities


@pytest.mark.parametrize("target", [0.0, 0.9, 1.0])
def test_bce_matches_jax(target):
    pred = _np(3, (2, 2, 2, 1))
    pred[0, 0, 0, 0], pred[1, 1, 1, 0] = 0.0, 1.0  # the clip
    got = gan.bce(_t(pred).bfloat16(), target)
    want = jgan.bce(jnp.asarray(pred).astype(jnp.bfloat16), target)
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_d_loss_and_g_adv_match_jax():
    real, fake = _np(4, (2, 3, 3, 1)), _np(5, (2, 3, 3, 1))
    np.testing.assert_allclose(float(gan.d_loss(_t(real), _t(fake), 0.9)),
                               float(jgan.d_loss(jnp.asarray(real), jnp.asarray(fake), 0.9)), rtol=1e-6)
    np.testing.assert_allclose(float(gan.g_adv_loss(_t(fake))), float(jgan.g_adv_loss(jnp.asarray(fake))), rtol=1e-6)


def test_ssim_matches_jax(case):
    _, _, x, refs = case
    a, b = _t(x["x_hat"] * 0.5 + 0.5), _t(x["gt"])
    np.testing.assert_allclose(float(ssim(a, b)), refs["ssim"], **TOL)
    assert float(ssim(b, b)) == pytest.approx(1.0, abs=1e-6)


def test_vgg16_features_match_jax(case):
    _, vgg_params, x, refs = case
    with torch.no_grad():
        feats = _vgg(vgg_params)(_t(x["gt"]))
    assert [tuple(f.shape) for f in feats] == [r.shape for r in refs["vgg"]]
    for f, r in zip(feats, refs["vgg"]):
        np.testing.assert_allclose(f.numpy(), r, atol=1e-5, rtol=1e-4)


def test_perceptual_loss_matches_jax(case):
    _, vgg_params, x, refs = case
    with torch.no_grad():
        got = perceptual_loss(_vgg(vgg_params), _t(x["x_hat"] * 0.5 + 0.5), _t(x["gt"]))
    np.testing.assert_allclose(float(got), refs["perceptual"], **TOL)


@pytest.mark.parametrize("term", ["adv", "pixel", "perceptual", "ssim", "total"])
def test_generator_loss_matches_jax(case, term):
    d_params, vgg_params, x, refs = case
    with torch.no_grad():
        total, terms = composite.generator_loss(_d(d_params), _t(x["x_hat"]), _t(x["gt"]),
                                                composite.LossWeights(**WEIGHTS), _vgg(vgg_params))
    assert terms["total"] is total
    np.testing.assert_allclose(float(terms[term]), refs["g_terms"][term], **TOL)


@pytest.mark.parametrize("term", ["d_total", "d_real", "d_fake"])
def test_discriminator_loss_matches_jax(case, term):
    d_params, _, x, refs = case
    with torch.no_grad():
        _, terms = composite.discriminator_loss(_d(d_params), _t(x["x_hat"]), _t(x["gt"]), 0.9)
    np.testing.assert_allclose(float(terms[term]), refs["d_terms"][term], **TOL)


def test_zero_weight_terms_are_left_out(case):
    d_params, _, x, _ = case
    d = _d(d_params)
    weights = composite.LossWeights(adv=0.0, ssim=0.0)
    _, terms = composite.generator_loss(d, _t(x["x_hat"]), _t(x["gt"]), weights, vgg=None)
    assert set(terms) == {"pixel", "total"}
    assert float(terms["total"]) == pytest.approx(100.0 * float(terms["pixel"]))


def test_contextual_raises_until_ported(case):
    """Ported now, so it no longer raises: with a VGG16 the contextual term
    (CX on relu3_3) is JAX's and enters the total with its weight; without
    one it is left out, as in JAX."""
    d_params, vgg_params, x, _ = case
    weights = dict(WEIGHTS, contextual=2.0)
    _, jterms = jcomposite.generator_loss(d_params, jnp.asarray(x["x_hat"]), jnp.asarray(x["gt"]),
                                          jcomposite.LossWeights(**weights), vgg_params)
    with torch.no_grad():
        _, terms = composite.generator_loss(_d(d_params), _t(x["x_hat"]), _t(x["gt"]),
                                            composite.LossWeights(**weights), _vgg(vgg_params))
        _, no_vgg = composite.generator_loss(_d(d_params), _t(x["x_hat"]), _t(x["gt"]),
                                             composite.LossWeights(**weights), None)
    assert set(terms) == {k for k in jterms}
    for k in ("contextual", "total"):
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), **TOL, err_msg=k)
    assert "contextual" not in no_vgg
