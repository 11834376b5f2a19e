"""VGG16 perceptual loss, as ``fdgan_tpu/losses/perceptual.py`` computes it
for the train step: the sum over relu1_2 … relu4_3 of the mean squared
feature difference. With H sharded each mean is this rank's share of the
whole image's (``halo_exchange.global_mean``); VGG's 3×3 convs take their
halos and its 2×2 max pools stay on a rank (bands of 8-row multiples)."""

from __future__ import annotations

import torch

from fdgan_tpu_torch.dist.halo_exchange import global_mean
from fdgan_tpu_torch.models.vgg16 import VGG16


def perceptual_loss(vgg: VGG16, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a, b in zip(vgg(x), vgg(y)):
        total = total + global_mean((a - b).float().square())
    return total
