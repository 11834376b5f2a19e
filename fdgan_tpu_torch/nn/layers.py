"""Layers of the FDGAN models in PyTorch.

Counterpart of ``fdgan_tpu/nn/layers.py``. Activations are NCHW tensors in
``torch.channels_last`` memory format (their memory is NHWC), conv weights
are torch's OIHW, and the BatchNorm parameters carry the reference
checkpoints' names (``weight``, ``bias``, ``running_mean``, ``running_var``).

Mixed precision is the JAX package's: parameters may stay fp32 while the
activations are bf16, and every conv casts its weight to the activation's
dtype where it is used (:class:`Conv2d`, :class:`ConvTranspose2d`).

BatchNorm follows the reference's published inference mode: ``mode='batch'``
normalises with the current batch's statistics (its README runs
``netG.train()``); ``mode='running'`` uses the stored statistics. In batch
mode a ``stats_out`` dict collects each BN's (mean, unbiased var) under its
module path, for :func:`update_running_stats`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fdgan_tpu_torch.ops.stats import channel_stats
from fdgan_tpu_torch.ops.stats import reference as plain_channel_stats

StatsOut = Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding: int = 0,
    stride: int = 1,
) -> torch.Tensor:
    """Conv in the activation dtype (OIHW weight, torch padding)."""
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, stride=stride, padding=padding)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, padding=self.padding, stride=self.stride)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight is cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding, self.output_padding)


@torch.no_grad()
def torch_style_init(model: nn.Module, generator: torch.Generator) -> None:
    """``conv2d_init(init='torch')``: every conv weight and bias ~
    U(−1/√fan_in, 1/√fan_in) with fan_in = in·kh·kw; BatchNorm weight 1,
    bias 0, running mean 0, running var 1. Draws on the CPU from
    ``generator``, module by module in definition order."""
    for module in model.modules():
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


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Torch-style avg_pool2d: stride = window, floor on odd sizes, no padding."""
    return F.avg_pool2d(x, window)


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    return F.max_pool2d(x, window)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour ×scale upsample (reference: F.upsample_nearest)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def batch_stats(x: torch.Tensor, impl: str = "kernels") -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-channel (mean, biased var) of NCHW x, as ``_batch_stats``
    computes them: fp32 activations by the two-pass variance, bf16 ones by
    the one-pass E[x²]−μ², clamped at 0, whose fp32 cancellation error is
    far below bf16's own quantisation.

    ``impl='kernels'`` takes bf16 through ``ops.stats.channel_stats``: the
    hand-written kernel on a CUDA tensor, which reads x once in bf16 and so
    needs x channels_last (NHWC in memory; any other layout raises), and its
    twin on a CPU one. ``impl='plain'`` runs the plain formula on any device."""
    nhwc = x.permute(0, 2, 3, 1)
    if impl == "kernels":
        return channel_stats(nhwc)
    if impl == "plain":
        return plain_channel_stats(nhwc)
    raise ValueError(f"unknown impl {impl!r}")


def unbiased(var: torch.Tensor, n: int) -> torch.Tensor:
    """The n/(n−1) correction of a recorded batch variance."""
    return var * (n / max(n - 1, 1))


class BatchNorm(nn.Module):
    """BatchNorm parameters with exactly the reference's four state-dict
    entries. ``nn.BatchNorm2d`` is not used: its ``num_batches_tracked``
    buffer has no counterpart in the PyTorch-0.3 checkpoints."""

    def __init__(self, num_features: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("running_mean", torch.zeros(num_features, **kw))
        self.register_buffer("running_var", torch.ones(num_features, **kw))

    def forward(self, x: torch.Tensor, mode: str = "batch", stats_out: StatsOut = None,
                stats_key: Optional[str] = None, impl: str = "kernels") -> torch.Tensor:
        return batch_norm(self, x, mode, stats_out=stats_out, stats_key=stats_key, impl=impl)


def batch_norm(
    bn: BatchNorm,
    x: torch.Tensor,
    mode: str = "batch",
    eps: float = 1e-5,
    stats_out: StatsOut = None,
    stats_key: Optional[str] = None,
    impl: str = "kernels",
) -> torch.Tensor:
    """BatchNorm over NCHW, normalising over N, H and W. The statistics and
    the folded affine are fp32; the final multiply-add runs in x's dtype.
    Batch mode takes its statistics from :func:`batch_stats` with ``impl``.

    In batch mode with ``stats_out`` and ``stats_key`` given, the batch's
    (mean, unbiased var) is recorded, detached, under ``stats_key``."""
    if mode == "batch":
        mean, var = batch_stats(x, impl)
        if stats_out is not None and stats_key is not None:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            stats_out[stats_key] = (mean.detach(), unbiased(var.detach(), n))
    elif mode == "running":
        mean, var = bn.running_mean.float(), bn.running_var.float()
    else:
        raise ValueError(f"unknown BN mode {mode!r}")
    inv = bn.weight.float() * torch.rsqrt(var + eps)
    shift = bn.bias.float() - mean * inv
    return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


@torch.no_grad()
def update_running_stats(bn: BatchNorm, mean: torch.Tensor, var: torch.Tensor, momentum: float = 0.1) -> None:
    """Torch-style running-stat update, in place: r = (1−m)·r + m·batch."""
    bn.running_mean.copy_((1 - momentum) * bn.running_mean + momentum * mean.to(bn.running_mean.dtype))
    bn.running_var.copy_((1 - momentum) * bn.running_var + momentum * var.to(bn.running_var.dtype))


def fold_stats(model: nn.Module, stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]], momentum: float = 0.1) -> None:
    """Fold collected batch statistics into the running statistics of the
    BatchNorm at each key's module path."""
    for key, (mean, var) in stats.items():
        update_running_stats(model.get_submodule(key), mean, var, momentum)

