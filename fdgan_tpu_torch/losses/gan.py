"""Adversarial BCE losses for the sigmoid-headed discriminator.

Counterpart of ``fdgan_tpu/losses/gan.py``: binary cross-entropy on
probability maps, always in fp32 (in bf16 the clip bound 1 − 1e−7 rounds to
1, and a saturated discriminator then gives log(0)).
"""

from __future__ import annotations

import torch

from fdgan_tpu_torch.dist.halo_exchange import global_mean

_EPS = 1e-7


def bce(pred: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCE of a probability map against a constant label (with H
    sharded, this rank's share of the whole map's mean)."""
    p = pred.float().clamp(_EPS, 1.0 - _EPS)
    return global_mean(-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)))


def d_loss(d_real: torch.Tensor, d_fake: torch.Tensor, real_label: float = 1.0) -> torch.Tensor:
    """BCE(D(real), real_label) + BCE(D(fake), 0); ``real_label`` < 1 is
    one-sided label smoothing."""
    return bce(d_real, real_label) + bce(d_fake, 0.0)


def g_adv_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """The generator's term: BCE(D(fake), 1)."""
    return bce(d_fake, 1.0)
