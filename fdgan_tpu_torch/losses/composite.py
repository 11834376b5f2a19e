"""Composite generator and discriminator objectives of FD-GAN training.

Counterpart of ``fdgan_tpu/losses/composite.py``: adversarial BCE through
the fusion discriminator, pixel L1 (or MSE), VGG16 perceptual, 1 − SSIM and
the contextual loss on VGG16's relu3_3 (where a VGG16 is given).

Range contract, as the JAX package's: ``x_hat`` is the generator's tanh
output in [−1, 1]; ``gt`` is in [0, 1], as the h5 pipeline stores it. Every
term compares the [0, 1] views, so the discriminator sees real and fake
images of one range. Zero-weight terms are left out in Python, so their
graphs are never built.

``impl`` picks how the discriminator's input is built: ``'kernels'``
through K3 (``ops.freq``), ``'plain'`` through its plain version.

With H sharded (``dist.halo_exchange.spatial_sharding``) every image is a
band of rows, and every mean (the pixel term, BCE over D's patches, the
perceptual MSEs, SSIM, the logged ``d_real`` / ``d_fake``) is this rank's
share of the whole image's: its band's sum over the global count
(``halo_exchange.global_mean``), so that the shares of a spatial group add
up to the mean. The contextual term, where every position meets every
target position, gathers the target's features over the spatial group and
takes its max over image positions there; it too is this rank's share
(``losses/contextual.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from fdgan_tpu_torch.dist import halo_exchange
from fdgan_tpu_torch.dist.halo_exchange import global_mean
from fdgan_tpu_torch.losses.contextual import contextual_loss
from fdgan_tpu_torch.losses.gan import d_loss, g_adv_loss
from fdgan_tpu_torch.losses.perceptual import perceptual_loss
from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator, fusion_apply
from fdgan_tpu_torch.models.vgg16 import VGG16
from fdgan_tpu_torch.ops.ssim import ssim

@dataclasses.dataclass(frozen=True)
class LossWeights:
    adv: float = 1.0
    pixel: float = 100.0
    pixel_norm: str = "l1"  # 'l1' | 'mse'
    perceptual: float = 1.0
    ssim: float = 1.0
    contextual: float = 0.0  # CX on VGG16 relu3_3; needs a VGG16, as the perceptual term


def pixel_loss(x: torch.Tensor, y: torch.Tensor, norm: str) -> torch.Tensor:
    diff = (x - y).float()
    return global_mean(diff.abs() if norm == "l1" else diff.square())


def generator_loss(
    d: NLayerDiscriminator,
    x_hat: torch.Tensor,
    gt: torch.Tensor,
    weights: LossWeights,
    vgg: Optional[VGG16] = None,
    impl: str = "kernels",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's objective and its terms (NHWC ``x_hat``, ``gt``)."""
    x01 = (x_hat + 1.0) * 0.5
    terms = {}
    total = torch.zeros((), dtype=torch.float32, device=x_hat.device)
    if weights.adv > 0:
        terms["adv"] = g_adv_loss(fusion_apply(d, x01, impl))
        total = total + weights.adv * terms["adv"]
    terms["pixel"] = pixel_loss(x01, gt, weights.pixel_norm)
    total = total + weights.pixel * terms["pixel"]
    if vgg is not None and weights.perceptual > 0:
        terms["perceptual"] = perceptual_loss(vgg, x01, gt)
        total = total + weights.perceptual * terms["perceptual"]
    if weights.ssim > 0:
        terms["ssim"] = ssim(x01, gt)
        # with H sharded each rank's share of the 1, so that the shares add up to 1 − SSIM
        total = total + weights.ssim * (1.0 / halo_exchange.spatial_size() - terms["ssim"])
    if weights.contextual > 0 and vgg is not None:
        # relu3_3, downsampled enough for CX's cost, quadratic in H·W
        terms["contextual"] = contextual_loss(vgg(x01)[2], vgg(gt)[2])
        total = total + weights.contextual * terms["contextual"]
    terms["total"] = total
    return total, terms


def discriminator_loss(
    d: NLayerDiscriminator,
    x_hat: torch.Tensor,
    gt: torch.Tensor,
    real_label: float = 1.0,
    impl: str = "kernels",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BCE(D(fuse(gt)), real_label) + BCE(D(fuse(x̂, detached)), 0). Real and
    fake go through D in separate forwards, each with its own batch BN."""
    x01 = ((x_hat + 1.0) * 0.5).detach()
    d_real = fusion_apply(d, gt, impl)
    d_fake = fusion_apply(d, x01, impl)
    loss = d_loss(d_real, d_fake, real_label)
    return loss, {"d_total": loss, "d_real": global_mean(d_real), "d_fake": global_mean(d_fake)}
