"""The discriminators of FD-GAN and DCPDN in PyTorch.

Counterpart of ``fdgan_tpu/models/discriminators.py``: the fusion
discriminator (``nlayer_init``, ``nlayer_apply``, ``fusion_apply``), the
pix2pix PatchGAN ``NLayerDiscriminator`` (the reference's
``models/dehaze1113.py:142-186``) over the 9-channel frequency
decomposition concat[RGB, LF, HF]; ``PatchD``, the reference's ``D``
(:188-230), a PatchGAN of blockUNet1 layers under ``main.layer{i}``; and
``BeganD``, its BEGAN-style autoencoder ``D1`` (:96-140).

The state dict carries the reference's ``nn.Sequential`` indices:
``model.{0,2,5,8,11}`` are the 4×4 convs (the middle ones bias-free),
``model.{3,6,9}`` the BatchNorms; the LeakyReLUs and the sigmoid hold no
parameters. BatchNorm always normalises with the batch's statistics and its
running statistics are never folded, as in the JAX train step. Convs run in
the activation's dtype; the sigmoid head runs in fp32, since a bf16 sigmoid
saturates to exactly 0 or 1 and defeats the BCE clip.
"""

from __future__ import annotations

import torch
from torch import nn

from fdgan_tpu_torch.models.blocks import BeganConvBlock, BeganDeconvBlock, BlockUNet
from fdgan_tpu_torch.nn.layers import (
    BatchNorm,
    BNCtx,
    Conv2d,
    batch_norm,
    elu,
    finish,
    leaky_relu,
    sigmoid,
    tanh,
)
from fdgan_tpu_torch.ops import filters, freq


class NLayerDiscriminator(nn.Module):
    """PatchGAN over NHWC images: (B, H, W, input_nc) → (B, H', W', 1)
    fp32 probabilities (H' = H/8 − 2 for the default n_layers=3)."""

    def __init__(self, input_nc: int = 9, ndf: int = 64, n_layers: int = 3, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.n_layers = n_layers
        model = {"0": Conv2d(input_nc, ndf, 4, 2, 1, **kw)}
        idx, nf_mult = 2, 1
        for n in range(1, n_layers + 1):
            nf_prev, nf_mult = nf_mult, min(2**n, 8)
            stride = 2 if n < n_layers else 1
            model[str(idx)] = Conv2d(ndf * nf_prev, ndf * nf_mult, 4, stride, 1, bias=False, **kw)
            model[str(idx + 1)] = BatchNorm(ndf * nf_mult, **kw)
            idx += 3
        model[str(idx)] = Conv2d(ndf * nf_mult, 1, 4, 1, 1, **kw)
        self.model = nn.ModuleDict(model)
        finish(self, device, generator)

    def forward(self, x: torch.Tensor, impl: str = "kernels") -> torch.Tensor:
        """``impl`` picks the BNs' batch statistics (``nn.layers.batch_stats``)."""
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = leaky_relu(self.model["0"](h))
        idx = 2
        for _ in range(self.n_layers):
            h = leaky_relu(batch_norm(self.model[str(idx + 1)], self.model[str(idx)](h), "batch", impl=impl))
            idx += 3
        h = self.model[str(idx)](h)
        if h.shape[2] == 0 or h.shape[3] == 0:
            raise ValueError(f"input too small for NLayerDiscriminator: {tuple(x.shape[1:3])}; "
                             "the 4x4 tail convs need >= 24 px")
        return sigmoid(h.float()).permute(0, 2, 3, 1)


def fusion_apply(d: NLayerDiscriminator, x: torch.Tensor, impl: str = "kernels") -> torch.Tensor:
    """D(concat[RGB, Gaussian LF, Laplacian HF] of NHWC x). ``impl='kernels'``
    builds the input with K3 (``ops.freq``) and D's batch statistics with
    ``channel_stats`` (``ops.stats``), their plain versions for a CPU tensor;
    ``impl='plain'`` runs the plain versions on any device."""
    if impl == "kernels":
        return d(freq.frequency_fuse(x), impl)
    if impl == "plain":
        return d(filters.frequency_fuse(x), impl)
    raise ValueError(f"unknown impl {impl!r}")


class PatchD(nn.Module):
    """The reference's ``D``: NHWC (B, H, W, nc) → (B, H/2 − 2, W/2 − 2, 1)
    fp32 probabilities. layer1 a 4×4 s2 conv; layer2 and layer3 LeakyReLU,
    3×3 conv and BN; layer4 and layer5 LeakyReLU and a 4×4 s1 conv; every
    conv bias-free; the sigmoid in fp32, as ``NLayerDiscriminator``'s."""

    def __init__(self, nc: int = 3, nf: int = 64, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.main = nn.ModuleDict({
            "layer1": nn.ModuleDict({"conv": Conv2d(nc, nf, 4, 2, 1, bias=False, **kw)}),
            "layer2": BlockUNet(nf, nf * 2, 3, 1, bn=True, relu_=False, **kw),
            "layer3": BlockUNet(nf * 2, nf * 4, 3, 1, bn=True, relu_=False, **kw),
            "layer4": BlockUNet(nf * 4, nf * 8, 4, 1, relu_=False, **kw),
            "layer5": BlockUNet(nf * 8, 1, 4, 1, relu_=False, **kw),
        })
        finish(self, device, generator)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels",
                stats_out=None) -> torch.Tensor:
        """``bn_mode``, ``impl`` and ``stats_out`` as ``FDGAN.forward``'s; the
        statistics are recorded under ``main.layer2.bn`` and ``main.layer3.bn``."""
        bn = BNCtx(bn_mode, impl, stats_out).sub("main")
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.main["layer1"]["conv"](h)
        for name in ("layer2", "layer3", "layer4", "layer5"):
            h = self.main[name](h, bn.sub(name))
        return sigmoid(h.float()).permute(0, 2, 3, 1)


class BeganD(nn.Module):
    """The reference's ``D1``, an autoencoder: NHWC (B, H, W, nc) → its
    tanh reconstruction (B, H, W, nc); H and W divisible by 8. No BN."""

    def __init__(self, nc: int = 3, ndf: int = 64, hidden_size: int = 64, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.conv1 = nn.ModuleDict({"0": Conv2d(nc, ndf, 3, padding=1, **kw)})
        self.conv2 = BeganConvBlock(ndf, ndf, **kw)
        self.conv3 = BeganConvBlock(ndf, ndf * 2, **kw)
        self.conv4 = BeganConvBlock(ndf * 2, ndf * 3, **kw)
        self.encode = Conv2d(ndf * 3, hidden_size, 1, **kw)
        self.decode = Conv2d(hidden_size, ndf, 1, **kw)
        self.deconv4 = BeganDeconvBlock(ndf, ndf, **kw)
        self.deconv3 = BeganDeconvBlock(ndf, ndf, **kw)
        self.deconv2 = BeganDeconvBlock(ndf, ndf, **kw)
        self.deconv1 = nn.ModuleDict({"0": Conv2d(ndf, ndf, 3, padding=1, **kw),
                                      "2": Conv2d(ndf, ndf, 3, padding=1, **kw),
                                      "4": Conv2d(ndf, nc, 3, padding=1, **kw)})
        finish(self, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = elu(self.conv1["0"](h))
        h = self.conv4(self.conv3(self.conv2(h)))
        h = self.decode(self.encode(h))
        h = self.deconv2(self.deconv3(self.deconv4(h)))
        h = elu(self.deconv1["0"](h))
        h = elu(self.deconv1["2"](h))
        return tanh(self.deconv1["4"](h)).permute(0, 2, 3, 1).contiguous()
