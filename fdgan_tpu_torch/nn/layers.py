"""Layers of the FDGAN generator in PyTorch.

Counterpart of ``fdgan_tpu/nn/layers.py``. Activations are NCHW tensors in
``torch.channels_last`` memory format (their memory is NHWC), conv weights
are torch's OIHW, and the BatchNorm parameters carry the reference
checkpoints' names (``weight``, ``bias``, ``running_mean``, ``running_var``).

BatchNorm follows the reference's published inference mode: ``mode='batch'``
normalises with the current batch's statistics (its README runs
``netG.train()``); ``mode='running'`` uses the stored statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_DIMS = (0, 2, 3)  # N, H, W of an NCHW tensor


def conv2d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, padding: int = 0
) -> torch.Tensor:
    """Stride-1 conv in the activation dtype (OIHW weight, torch padding)."""
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, padding=padding)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Torch-style avg_pool2d: stride = window, floor on odd sizes, no padding."""
    return F.avg_pool2d(x, window)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour ×scale upsample (reference: F.upsample_nearest)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def batch_stats(x: torch.Tensor, dims: Sequence[int] = _DIMS) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 per-channel (mean, biased var), as ``_batch_stats`` computes them.

    fp32 activations use the two-pass variance; bf16 activations use the
    one-pass E[x²]−μ², clamped at 0, whose fp32 cancellation error is far
    below bf16's own quantisation."""
    dims = tuple(dims)
    mean = x.mean(dim=dims, keepdim=True, dtype=torch.float32)
    if x.dtype == torch.bfloat16:
        var = (x.float().square().mean(dim=dims) - mean.square().flatten()).clamp_min(0.0)
    else:
        var = (x.float() - mean).square().mean(dim=dims)
    return mean.flatten(), var


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

    def forward(self, x: torch.Tensor, mode: str = "batch") -> torch.Tensor:
        return batch_norm(self, x, mode)


def batch_norm(bn: BatchNorm, x: torch.Tensor, mode: str = "batch", eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over NCHW, normalising over N, H and W. The statistics and
    the folded affine are fp32; the final multiply-add runs in x's dtype."""
    if mode == "batch":
        mean, var = batch_stats(x)
    elif mode == "running":
        mean, var = bn.running_mean.float(), bn.running_var.float()
    else:
        raise ValueError(f"unknown BN mode {mode!r}")
    inv = bn.weight.float() * torch.rsqrt(var + eps)
    shift = bn.bias.float() - mean * inv
    return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)
