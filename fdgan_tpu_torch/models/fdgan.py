"""FDGAN generator — the model the reference's ``demo.py`` runs.

Counterpart of ``fdgan_tpu/models/fdgan.py`` (reference
``models/dehaze1113.py:702-801``): a DenseNet-121 encoder (blocks of 6, 12
and 24 dense layers at H, H/2 and H/4) with multi-scale skip fusions and a
tanh output in [-1, 1]. The forward follows ``fdgan.apply(impl="pallas")``:
the 42 encoder dense layers run through kernel K1, and in batch-BN mode
their norm2 statistics come from kernel K2 (``ops/dense.py``) and bf16
batch statistics from ``channel_stats`` (``ops/stats.py``). The engine and
the train step run ``models/fdgan_fast.py`` over the same parameters, the
counterpart of the forward the JAX entry points run.

The attribute names are the reference's, dead parameters included
(densenet ``conv0``, ``dense_block31``, ``dense_norm31`` and the BNs inside
the decoder's dy blocks), so a ``netG_epoch_*.pth`` loads with
``load_state_dict(strict=True)``.

Mixed precision is the JAX package's: an fp32 model takes a bf16 input, and
every conv casts its weight to bf16 where it is used.
"""

from __future__ import annotations

import torch
from torch import nn

from fdgan_tpu_torch.models.blocks import BottleneckDy, TransitionDy
from fdgan_tpu_torch.models.densenet import DenseBlock, Transition
from fdgan_tpu_torch.nn.layers import BatchNorm, Conv2d, StatsOut, avg_pool, relu, tanh, torch_style_init


class FDGAN(nn.Module):
    """The generator. ``forward`` takes NHWC (B, H, W, 3) images and returns
    NHWC (B, H, W, 3); H and W must be divisible by 8.

    The parameters are made with :meth:`init_weights` from ``generator``
    (a ``torch.Generator``; seed 0 when omitted)."""

    multiple = 8   # the engine's bucket divisor: three ÷2 stages
    has_bn = True  # the engine's ``bn_mode`` applies

    def __init__(self, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.conv0 = Conv2d(3, 64, 7, 2, 3, bias=False, **kw)  # dead
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
        self.conv_refin1 = Conv2d(3, 64, 3, 1, 1, **kw)
        self.conv_refin6 = Conv2d(640, 512, 3, 1, 1, **kw)
        self.conv_refin5 = Conv2d(256, 128, 1, 1, 0, **kw)
        self.conv_refin3 = Conv2d(16, 3, 3, 1, 1, **kw)
        self.conv_refin2 = Conv2d(64, 32, 1, 1, 0, **kw)
        self.conv_refine4 = Conv2d(160, 128, 3, 1, 1, **kw)  # sic: 'refine'
        self.to_empty(device=device if device is not None else "cpu")
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """Torch-style init (``nn.layers.torch_style_init``), as
        ``conv2d_init(init='torch')``."""
        torch_style_init(self, generator)

    @staticmethod
    def input_map(x: torch.Tensor) -> torch.Tensor:
        """A staged batch as the model takes it: uint8 [0, 255] to [0, 1],
        normalised on x's device in fp32, exactly as the host would; float
        [0, 1] as it is."""
        return x.float() / 255.0 if x.dtype == torch.uint8 else x

    def serve_forward(self, x: torch.Tensor, bn_mode: str) -> torch.Tensor:
        """The engine's forward: ``models.fdgan_fast.apply``."""
        from fdgan_tpu_torch.models import fdgan_fast

        return fdgan_fast.apply(self, x, bn_mode=bn_mode)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels",
                stats_out: StatsOut = None) -> torch.Tensor:
        """``bn_mode='batch'`` normalises with batch statistics (the
        reference's published inference mode), ``'running'`` with the
        stored ones. ``impl='kernels'`` runs the encoder's dense layers
        through K1/K2 and bf16 batch statistics through ``channel_stats``
        (their plain twins for a CPU tensor); ``impl='plain'`` runs the
        twins on any device. In batch mode ``stats_out`` collects
        every BN's (mean, unbiased var) under its module path, which is the
        JAX key (``dense_block1.denselayer1.norm1``, ``trans_block1.norm``)."""
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected NHWC (B, H, W, 3) images, got shape {tuple(x.shape)}")
        if x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(f"H and W must be divisible by 8, got {tuple(x.shape[1:3])}")
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        def dense(name, xx):
            return getattr(self, name)(xx, bn_mode, impl, stats_out, f"{name}.")

        def trans(name, xx):
            return getattr(self, name)(xx, bn_mode, stats_out, f"{name}.", impl)

        x0 = relu(self.conv_refin1(x))
        x01 = self.conv_refin2(avg_pool(x0, 2))
        x1 = trans("trans_block1", dense("dense_block1", x0))
        x10 = self.conv_refine4(torch.cat([x01, x1], dim=1))
        x2 = trans("trans_block2", dense("dense_block2", x10))
        x3 = trans("trans_block3", dense("dense_block3", x2))
        x22 = self.conv_refin5(avg_pool(x2, 2))
        x4 = self.conv_refin6(torch.cat([x3, x22], dim=1))
        x4 = self.trans_block4(self.dense_block4(x4))
        x5 = self.trans_block5(self.dense_block5(torch.cat([x4, x2], dim=1)))
        x6 = self.trans_block6(self.dense_block6(x5))
        y = tanh(self.conv_refin3(x6))
        return y.permute(0, 2, 3, 1).contiguous()
