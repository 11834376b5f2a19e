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

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fdgan_tpu_torch.dist import halo_exchange
from fdgan_tpu_torch.dist.stats import combine as global_stats
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
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype.
    Inside ``dist.halo_exchange.spatial_sharding`` a conv with an extent on
    H (a kernel, padding or stride other than 1, 0, 1 there) takes the rows
    around this rank's block from its neighbours
    (``conv2d_halo_sharded``); a 1×1 conv stays local."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = halo_exchange.current()
        if shard is not None and (self.kernel_size[0], self.padding[0], self.stride[0]) != (1, 0, 1):
            return halo_exchange.conv2d_halo_sharded(self.weight, self.bias, x, shard.group, padding=self.padding,
                                                     stride=self.stride)
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


def finish(model: nn.Module, device, generator) -> nn.Module:
    """A model built on the meta device, materialised on ``device`` (the
    CPU when None) with torch-style random weights from ``generator`` (seed
    0 when None). ``device="meta"`` leaves it unmaterialised: a part of a
    larger model, or a template of names and shapes."""
    if device == "meta":
        return model
    model.to_empty(device=device if device is not None else "cpu")
    torch_style_init(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Torch-style avg_pool2d: stride = window, floor on odd sizes, no padding.
    With H sharded (``dist.halo_exchange.spatial_sharding``) a window must
    not cross a seam: this rank's H must divide by it, else ``ValueError``."""
    if halo_exchange.current() is not None and x.shape[2] % window:
        raise ValueError(f"a {window}x{window} pool over a shard of {x.shape[2]} rows would cross a seam")
    return F.avg_pool2d(x, window)


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None, padding: int = 0) -> torch.Tensor:
    """Max pool, stride = window unless given; the padding is −inf, so a
    padded position never wins (``fdgan_tpu/nn/layers.py:211-220``)."""
    return F.max_pool2d(x, window, stride or window, padding)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour ×scale upsample (reference: F.upsample_nearest). An
    integer scale repeats each row: with H sharded it stays on the rank."""
    if halo_exchange.current() is not None and not isinstance(scale, int):
        raise TypeError(f"with H sharded the scale must be an int, got {scale!r}")
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_nearest_to(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of NCHW x to an exact (H, W) by JAX's integer rule,
    output row i from input row ⌊i·h / H⌋ (``fdgan_tpu/nn/layers.py:231-237``;
    ``F.interpolate`` rounds a float scale instead). The index tensors are
    made on x's device; the result is channels_last."""
    h, w = x.shape[2:]
    rows = torch.arange(size[0], device=x.device) * h // size[0]
    cols = torch.arange(size[1], device=x.device) * w // size[1]
    return x[:, :, rows][:, :, :, cols].contiguous(memory_format=torch.channels_last)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def dropout(x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: with ``train`` and a ``generator``, each element is
    kept with probability 1 − rate and scaled by 1/(1 − rate), else zeroed;
    otherwise x as it is, as JAX ``dropout`` without an rng. The mask is
    drawn on the generator's device and moved to x's."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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
    twin on a CPU one. ``impl='plain'`` runs the plain formula on any device.
    The kernel reads 8-channel vectors: a bf16 x whose C is not a multiple
    of 8 (DCPDN's ``batchnorm20``) goes to it zero-padded to the next
    multiple, and the padded channels' statistics are dropped."""
    nhwc = x.permute(0, 2, 3, 1)
    if impl == "kernels":
        c = nhwc.shape[-1]
        if nhwc.dtype == torch.bfloat16 and c % 8:
            mean, var = channel_stats(F.pad(nhwc, (0, -c % 8)))
            return mean[:c], var[:c]
        return channel_stats(nhwc)
    if impl == "plain":
        return plain_channel_stats(nhwc)
    raise ValueError(f"unknown impl {impl!r}")


def unbiased(var: torch.Tensor, n) -> torch.Tensor:
    """The n/(n−1) correction of a recorded batch variance. n is an int, or
    a 0-d tensor: the global count of a data-parallel step
    (``dist.stats.combine``)."""
    if isinstance(n, torch.Tensor):
        return var * (n / (n - 1).clamp_min(1)).to(var.dtype)
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
    Batch mode takes its statistics from :func:`batch_stats` with ``impl``,
    over the global batch inside a data-parallel step
    (``dist.stats.global_batch_stats``).

    In batch mode with ``stats_out`` and ``stats_key`` given, the batch's
    (mean, unbiased var) is recorded, detached, under ``stats_key``."""
    if mode == "batch":
        mean, var, n = global_stats(*batch_stats(x, impl), x.shape[0] * x.shape[2] * x.shape[3])
        if stats_out is not None and stats_key is not None:
            stats_out[stats_key] = (mean.detach(), unbiased(var.detach(), n))
    elif mode == "running":
        mean, var = bn.running_mean.float(), bn.running_var.float()
    else:
        raise ValueError(f"unknown BN mode {mode!r}")
    inv = bn.weight.float() * torch.rsqrt(var + eps)
    shift = bn.bias.float() - mean * inv
    return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


@dataclasses.dataclass(frozen=True)
class BNCtx:
    """The BatchNorm mode, the batch statistics' ``impl`` and the statistics
    collector, threaded through a model with each BN's path, as JAX
    ``BNCtx`` (``fdgan_tpu/models/blocks.py:44-67``): ``sub(name)`` is the
    context of a child, and ``ctx(bn, x, name)`` normalises x with ``bn``,
    recording its batch statistics under ``{prefix}{name}``."""

    mode: str = "batch"
    impl: str = "kernels"
    stats_out: StatsOut = None
    prefix: str = ""

    def sub(self, name: str) -> "BNCtx":
        return dataclasses.replace(self, prefix=f"{self.prefix}{name}.")

    def __call__(self, bn: BatchNorm, x: torch.Tensor, name: str) -> torch.Tensor:
        return batch_norm(bn, x, self.mode, stats_out=self.stats_out, stats_key=f"{self.prefix}{name}",
                          impl=self.impl)


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

