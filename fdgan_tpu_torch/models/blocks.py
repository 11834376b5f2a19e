"""The FDGAN decoder's blocks (counterpart of ``fdgan_tpu/models/blocks.py``).

``BottleneckDy`` and ``TransitionDy`` are the reference's
``BottleneckBlockdy`` and ``TransitionBlockdy`` (models/dehaze1113.py
:256-275, :343-428): their BatchNorms are built but never called in the
forward. They are kept, so the state dict matches the checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from fdgan_tpu_torch.nn.layers import BatchNorm, Conv2d, ConvTranspose2d, relu, upsample_nearest


class BottleneckDy(nn.Module):
    """x → cat[x, conv2(relu(conv1(relu(x))))]; conv1 1×1, conv2 3×3."""

    def __init__(self, in_planes: int, out_planes: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inter = out_planes * 4
        self.bn1 = BatchNorm(in_planes, **kw)  # dead
        self.conv1 = Conv2d(in_planes, inter, 1, bias=False, **kw)
        self.bn2 = BatchNorm(inter, **kw)  # dead
        self.conv2 = Conv2d(inter, out_planes, 3, padding=1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.conv2(relu(self.conv1(relu(x))))], dim=1)


class TransitionDy(nn.Module):
    """relu → 1×1 ConvTranspose2d → ×2 nearest upsample."""

    def __init__(self, in_planes: int, out_planes: int, device=None, dtype=torch.float32):
        super().__init__()
        self.bn1 = BatchNorm(in_planes, device=device, dtype=dtype)  # dead
        self.conv1 = ConvTranspose2d(
            in_planes, out_planes, 1, bias=False, device=device, dtype=dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(self.conv1(relu(x)), 2)
