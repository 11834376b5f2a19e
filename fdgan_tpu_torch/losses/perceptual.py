"""VGG16 perceptual loss, as ``fdgan_tpu/losses/perceptual.py`` computes it
for the train step: the sum over relu1_2 … relu4_3 of the mean squared
feature difference."""

from __future__ import annotations

import torch

from fdgan_tpu_torch.models.vgg16 import VGG16


def perceptual_loss(vgg: VGG16, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a, b in zip(vgg(x), vgg(y)):
        total = total + (a - b).float().square().mean()
    return total
