"""The fusion discriminator of FD-GAN in PyTorch.

Counterpart of ``fdgan_tpu/models/discriminators.py`` (``nlayer_init``,
``nlayer_apply``, ``fusion_apply``): the pix2pix PatchGAN
``NLayerDiscriminator`` (the reference's ``models/dehaze1113.py:142-186``)
over the 9-channel frequency decomposition concat[RGB, LF, HF].

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

from fdgan_tpu_torch.nn.layers import BatchNorm, Conv2d, batch_norm, leaky_relu, sigmoid, torch_style_init
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
        self.to_empty(device=device if device is not None else "cpu")
        torch_style_init(self, generator if generator is not None else torch.Generator().manual_seed(0))

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
