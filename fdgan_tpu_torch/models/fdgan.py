"""FDGAN generator — the model the reference's ``demo.py`` runs.

Counterpart of ``fdgan_tpu/models/fdgan.py`` (reference
``models/dehaze1113.py:702-801``): a DenseNet-121 encoder (blocks of 6, 12
and 24 dense layers at H, H/2 and H/4) with multi-scale skip fusions and a
tanh output in [-1, 1]. The forward follows ``fdgan.apply(impl="pallas")``:
the 42 encoder dense layers run through kernel K1, and in batch-BN mode
their norm2 statistics come from kernel K2 (``ops/dense.py``).

The attribute names are the reference's, dead parameters included
(densenet ``conv0``, ``dense_block31``, ``dense_norm31`` and the BNs inside
the decoder's dy blocks), so a ``netG_epoch_*.pth`` loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fdgan_tpu_torch.models.blocks import BottleneckDy, TransitionDy
from fdgan_tpu_torch.models.densenet import DenseBlock, Transition
from fdgan_tpu_torch.nn.layers import BatchNorm, avg_pool, relu, tanh


class FDGAN(nn.Module):
    """The generator. ``forward`` takes NHWC (B, H, W, 3) images and returns
    NHWC (B, H, W, 3); H and W must be divisible by 8.

    The parameters are made with :meth:`init_weights` from ``generator``
    (a ``torch.Generator``; seed 0 when omitted)."""

    def __init__(self, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.conv0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, **kw)  # dead
        self.dense_block1 = DenseBlock(64, 6, **kw)
        self.trans_block1 = Transition(256, 128, **kw)
        self.dense_block2 = DenseBlock(128, 12, **kw)
        self.trans_block2 = Transition(512, 256, **kw)
        self.dense_block3 = DenseBlock(256, 24, **kw)
        self.trans_block3 = Transition(1024, 512, **kw)
        self.dense_block31 = DenseBlock(512, 16, **kw)  # dead
        self.dense_norm31 = BatchNorm(1024, **kw)  # dead
        self.dense_block4 = BottleneckDy(512, 256, **kw)
        self.trans_block4 = TransitionDy(768, 128, **kw)
        self.dense_block5 = BottleneckDy(384, 128, **kw)
        self.trans_block5 = TransitionDy(512, 64, **kw)
        self.dense_block6 = BottleneckDy(64, 32, **kw)
        self.trans_block6 = TransitionDy(96, 16, **kw)
        self.conv_refin1 = nn.Conv2d(3, 64, 3, 1, 1, **kw)
        self.conv_refin6 = nn.Conv2d(640, 512, 3, 1, 1, **kw)
        self.conv_refin5 = nn.Conv2d(256, 128, 1, 1, 0, **kw)
        self.conv_refin3 = nn.Conv2d(16, 3, 3, 1, 1, **kw)
        self.conv_refin2 = nn.Conv2d(64, 32, 1, 1, 0, **kw)
        self.conv_refine4 = nn.Conv2d(160, 128, 3, 1, 1, **kw)  # sic: 'refine'
        self.to_empty(device=device if device is not None else "cpu")
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Torch-style init, as ``conv2d_init(init='torch')``: every conv
        weight and bias ~ U(−1/√fan_in, 1/√fan_in) with fan_in = in·kh·kw;
        BatchNorm weight 1, bias 0, running mean 0, running var 1. Draws
        on the CPU from ``generator``, module by module in definition order."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                kh, kw = module.kernel_size
                bound = 1.0 / math.sqrt(module.in_channels * kh * kw)
                for p in (module.weight, module.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                        p.copy_(u * (2 * bound) - bound)
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels") -> torch.Tensor:
        """``bn_mode='batch'`` normalises with batch statistics (the
        reference's published inference mode), ``'running'`` with the
        stored ones. ``impl='kernels'`` runs the encoder's dense layers
        through K1/K2 (their plain twins for a CPU tensor); ``impl='plain'``
        runs the twins on any device."""
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected NHWC (B, H, W, 3) images, got shape {tuple(x.shape)}")
        if x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(f"H and W must be divisible by 8, got {tuple(x.shape[1:3])}")
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        x0 = relu(self.conv_refin1(x))
        x01 = self.conv_refin2(avg_pool(x0, 2))
        x1 = self.trans_block1(self.dense_block1(x0, bn_mode, impl), bn_mode)
        x10 = self.conv_refine4(torch.cat([x01, x1], dim=1))
        x2 = self.trans_block2(self.dense_block2(x10, bn_mode, impl), bn_mode)
        x3 = self.trans_block3(self.dense_block3(x2, bn_mode, impl), bn_mode)
        x22 = self.conv_refin5(avg_pool(x2, 2))
        x4 = self.conv_refin6(torch.cat([x3, x22], dim=1))
        x4 = self.trans_block4(self.dense_block4(x4))
        x5 = self.trans_block5(self.dense_block5(torch.cat([x4, x2], dim=1)))
        x6 = self.trans_block6(self.dense_block6(x5))
        y = tanh(self.conv_refin3(x6))
        return y.permute(0, 2, 3, 1).contiguous()
