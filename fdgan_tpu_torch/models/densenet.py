"""DenseNet-121 encoder pieces with torchvision's state-dict names.

Counterpart of ``fdgan_tpu/models/densenet.py``: dense layers
``denselayerN.norm1/conv1/norm2/conv2`` and transitions ``norm/conv``, so
the reference ``.pth`` checkpoints load as they are. A dense block runs
through ``ops.dense.dense_block_fused`` (kernels K1 and K2 on the GPU).
"""

from __future__ import annotations

import torch
from torch import nn

from fdgan_tpu_torch.nn.layers import BatchNorm, avg_pool, batch_norm, relu
from fdgan_tpu_torch.ops.dense import dense_block_fused

GROWTH_RATE = 32
BN_SIZE = 4


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inter = BN_SIZE * GROWTH_RATE
        self.norm1 = BatchNorm(in_ch, **kw)
        self.conv1 = nn.Conv2d(in_ch, inter, 1, bias=False, **kw)
        self.norm2 = BatchNorm(inter, **kw)
        self.conv2 = nn.Conv2d(inter, GROWTH_RATE, 3, padding=1, bias=False, **kw)


class DenseBlock(nn.Module):
    def __init__(self, in_ch: int, num_layers: int, device=None, dtype=torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(
                f"denselayer{i + 1}",
                DenseLayer(in_ch + i * GROWTH_RATE, device=device, dtype=dtype),
            )

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels") -> torch.Tensor:
        """x NCHW (channels_last) → the concat of x and every layer's output."""
        y = dense_block_fused(
            list(self.children()), x.permute(0, 2, 3, 1).contiguous(), mode=bn_mode, impl=impl
        )
        return y.permute(0, 3, 1, 2)


class Transition(nn.Module):
    """norm → relu → 1×1 conv → 2×2 average pool."""

    def __init__(self, in_ch: int, out_ch: int, device=None, dtype=torch.float32):
        super().__init__()
        self.norm = BatchNorm(in_ch, device=device, dtype=dtype)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch") -> torch.Tensor:
        return avg_pool(self.conv(relu(batch_norm(self.norm, x, bn_mode))), 2)
