"""The block family of the FDGAN and DCPDN models (counterpart of
``fdgan_tpu/models/blocks.py``; the reference's ``models/dehaze1113.py``).

- ``Bottleneck`` (:234-253, :299-341): BN+ReLU+1×1 → BN+ReLU+k×k (k = 3, 5
  or 7), concatenated to its input or not; with ``use_bn=False`` its BNs are
  built and never called (the ``*dy`` variants);
- ``Transition`` (:343-428): (BN+)ReLU + 1×1 ConvTranspose2d, then a nearest
  ×2/×4 upsample, a ×2 average pool, or nothing;
- ``BlockUNet`` (:29-59): a ReLU or LeakyReLU pre-activation, a 4×4 s2 (or
  any k, stride) conv or ConvTranspose2d, and an optional BN;
- ``BeganConvBlock`` / ``BeganDeconvBlock`` (:14-26) of the BEGAN
  discriminator, and ``BasicBlockRes`` (:65-94).

``BottleneckDy`` and ``TransitionDy`` are the reference's
``BottleneckBlockdy`` and ``TransitionBlockdy`` as ``models/fdgan.py`` and
``models/fdgan_fast.py`` build them: the two blocks with ``use_bn=False``,
whose BatchNorms are built but never called in the forward. Every block
keeps its dead BNs, so the state dict matches the checkpoints.

Activations are NCHW tensors in ``torch.channels_last``; BNs run through a
``nn.layers.BNCtx``.
"""

from __future__ import annotations

import torch
from torch import nn

from fdgan_tpu_torch.nn.layers import (
    BatchNorm,
    BNCtx,
    Conv2d,
    ConvTranspose2d,
    avg_pool,
    elu,
    leaky_relu,
    relu,
    upsample_nearest,
)

DEFAULT_BN = BNCtx()


class Bottleneck(nn.Module):
    """bn1, conv1 (1×1, in → 4·out), bn2, conv2 (k×k, 4·out → out), bias-free.
    ``use_bn=False`` skips both BNs (they stay in the state dict);
    ``concat=False`` returns the new channels alone."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int = 3, use_bn: bool = True, concat: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inter = out_planes * 4
        self.use_bn, self.concat = use_bn, concat
        self.bn1 = BatchNorm(in_planes, **kw)
        self.conv1 = Conv2d(in_planes, inter, 1, bias=False, **kw)
        self.bn2 = BatchNorm(inter, **kw)
        self.conv2 = Conv2d(inter, out_planes, ksize, padding=ksize // 2, bias=False, **kw)

    def forward(self, x: torch.Tensor, bn: BNCtx = DEFAULT_BN) -> torch.Tensor:
        if self.use_bn:
            out = self.conv1(relu(bn(self.bn1, x, "bn1")))
            out = self.conv2(relu(bn(self.bn2, out, "bn2")))
        else:
            out = self.conv2(relu(self.conv1(relu(x))))
        return torch.cat([x, out], dim=1) if self.concat else out


class Transition(nn.Module):
    """bn1 + 1×1 ConvTranspose2d (bias-free), then ``resize``: 'up2', 'up4',
    'down2' or 'none'. ``use_bn=False`` skips bn1 (it stays in the state dict)."""

    def __init__(self, in_planes: int, out_planes: int, resize: str = "up2", use_bn: bool = True, device=None,
                 dtype=torch.float32):
        super().__init__()
        if resize not in ("up2", "up4", "down2", "none"):
            raise ValueError(f"unknown resize {resize!r}")
        self.resize, self.use_bn = resize, use_bn
        self.bn1 = BatchNorm(in_planes, device=device, dtype=dtype)
        self.conv1 = ConvTranspose2d(in_planes, out_planes, 1, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, bn: BNCtx = DEFAULT_BN) -> torch.Tensor:
        out = self.conv1(relu(bn(self.bn1, x, "bn1")) if self.use_bn else relu(x))
        out = out.contiguous(memory_format=torch.channels_last)  # as BlockUNet's
        if self.resize == "up2":
            return upsample_nearest(out, 2)
        if self.resize == "up4":
            return upsample_nearest(out, 4)
        if self.resize == "down2":
            return avg_pool(out, 2)
        return out


class BottleneckDy(Bottleneck):
    """x → cat[x, conv2(relu(conv1(relu(x))))]: a 3×3 ``Bottleneck`` with
    ``use_bn=False``."""

    def __init__(self, in_planes: int, out_planes: int, device=None, dtype=torch.float32):
        super().__init__(in_planes, out_planes, 3, use_bn=False, device=device, dtype=dtype)


class TransitionDy(Transition):
    """relu → 1×1 ConvTranspose2d → ×2 nearest upsample: an 'up2'
    ``Transition`` with ``use_bn=False``."""

    def __init__(self, in_planes: int, out_planes: int, device=None, dtype=torch.float32):
        super().__init__(in_planes, out_planes, "up2", use_bn=False, device=device, dtype=dtype)


class BlockUNet(nn.Module):
    """Pre-activation (ReLU, or LeakyReLU 0.2 with ``relu_=False``) → a
    bias-free k×k conv (``conv``) or, with ``transposed``, ConvTranspose2d
    (``tconv``, the reference's name), padding 1 → an optional BN (``bn``)."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 4, stride: int = 2, bn: bool = False,
                 relu_: bool = True, transposed: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.relu_ = relu_
        conv = (ConvTranspose2d if transposed else Conv2d)(in_c, out_c, kernel, stride, 1, bias=False, **kw)
        self.add_module("tconv" if transposed else "conv", conv)
        self.bn = BatchNorm(out_c, **kw) if bn else None

    def forward(self, x: torch.Tensor, bn: BNCtx = DEFAULT_BN) -> torch.Tensor:
        conv = self.tconv if hasattr(self, "tconv") else self.conv
        # a 1×1 map at batch 1 is both layouts, and torch's convs may return NCHW from it
        y = conv(relu(x) if self.relu_ else leaky_relu(x, 0.2)).contiguous(memory_format=torch.channels_last)
        return y if self.bn is None else bn(self.bn, y, "bn")


class BeganConvBlock(nn.Module):
    """``0``, ``2``: 3×3 convs with ELU; ``4``: a 1×1 conv; then a ×2 average pool."""

    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.add_module("0", Conv2d(in_dim, in_dim, 3, padding=1, **kw))
        self.add_module("2", Conv2d(in_dim, in_dim, 3, padding=1, **kw))
        self.add_module("4", Conv2d(in_dim, out_dim, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = elu(self.get_submodule("0")(x))
        h = elu(self.get_submodule("2")(h))
        return avg_pool(self.get_submodule("4")(h), 2)


class BeganDeconvBlock(nn.Module):
    """``0``, ``2``: 3×3 convs with ELU; then a ×2 nearest upsample."""

    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.add_module("0", Conv2d(in_dim, out_dim, 3, padding=1, **kw))
        self.add_module("2", Conv2d(out_dim, out_dim, 3, padding=1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = elu(self.get_submodule("0")(x))
        return upsample_nearest(elu(self.get_submodule("2")(h)), 2)


class BasicBlockRes(nn.Module):
    """ResNet's BasicBlock: relu(bn2(conv2(relu(bn1(conv1 x)))) + x), 3×3 convs."""

    def __init__(self, inplanes: int, planes: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.conv1 = Conv2d(inplanes, planes, 3, padding=1, bias=False, **kw)
        self.bn1 = BatchNorm(planes, **kw)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, **kw)
        self.bn2 = BatchNorm(planes, **kw)

    def forward(self, x: torch.Tensor, bn: BNCtx = DEFAULT_BN) -> torch.Tensor:
        out = relu(bn(self.bn1, self.conv1(x), "bn1"))
        return relu(bn(self.bn2, self.conv2(out), "bn2") + x)
