"""DenseNet-121 encoder pieces with torchvision's state-dict names.

Counterpart of ``fdgan_tpu/models/densenet.py``: dense layers
``denselayerN.norm1/conv1/norm2/conv2`` and transitions ``norm/conv``, so
the reference ``.pth`` checkpoints load as they are. A dense block runs
through ``ops.dense.dense_block_fused`` (kernels K1 and K2 on the GPU).

``stem`` is torchvision's front with ``pool0`` (conv0 7×7 s2, norm0, relu,
3×3 s2 max pool), as DCPDN's ``Dense`` runs it (dehaze1113.py:503);
``dense_block`` and ``transition`` run a block under a ``BNCtx``, as JAX
``dense_block_apply`` and ``transition_apply``.
"""

from __future__ import annotations

import torch
from torch import nn

from fdgan_tpu_torch.nn.layers import BatchNorm, BNCtx, Conv2d, StatsOut, avg_pool, batch_norm, max_pool, relu
from fdgan_tpu_torch.ops.dense import dense_block_fused

GROWTH_RATE = 32
BN_SIZE = 4
INIT_FEATURES = 64


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inter = BN_SIZE * GROWTH_RATE
        self.norm1 = BatchNorm(in_ch, **kw)
        self.conv1 = Conv2d(in_ch, inter, 1, bias=False, **kw)
        self.norm2 = BatchNorm(inter, **kw)
        self.conv2 = Conv2d(inter, GROWTH_RATE, 3, padding=1, bias=False, **kw)


class DenseBlock(nn.Module):
    def __init__(self, in_ch: int, num_layers: int, device=None, dtype=torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(
                f"denselayer{i + 1}",
                DenseLayer(in_ch + i * GROWTH_RATE, device=device, dtype=dtype),
            )

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels",
                stats_out: StatsOut = None, prefix: str = "") -> torch.Tensor:
        """x NCHW (channels_last) → the concat of x and every layer's output.
        ``stats_out`` collects the BN statistics under ``{prefix}denselayerN.normK``."""
        y, _ = dense_block_fused(
            list(self.children()), x.permute(0, 2, 3, 1).contiguous(), mode=bn_mode, impl=impl,
            stats_out=stats_out, prefix=prefix,
        )
        return y.permute(0, 3, 1, 2)


class Transition(nn.Module):
    """norm → relu → 1×1 conv → 2×2 average pool."""

    def __init__(self, in_ch: int, out_ch: int, device=None, dtype=torch.float32):
        super().__init__()
        self.norm = BatchNorm(in_ch, device=device, dtype=dtype)
        self.conv = Conv2d(in_ch, out_ch, 1, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", stats_out: StatsOut = None,
                prefix: str = "", impl: str = "kernels") -> torch.Tensor:
        h = batch_norm(self.norm, x, bn_mode, stats_out=stats_out, stats_key=f"{prefix}norm", impl=impl)
        return avg_pool(self.conv(relu(h)), 2)


def dense_block(block: DenseBlock, x: torch.Tensor, bn: BNCtx) -> torch.Tensor:
    """``block`` under ``bn``, whose prefix is the block's path."""
    return block(x, bn.mode, bn.impl, bn.stats_out, bn.prefix)


def transition(trans: Transition, x: torch.Tensor, bn: BNCtx) -> torch.Tensor:
    """``trans`` under ``bn``, whose prefix is the transition's path."""
    return trans(x, bn.mode, bn.stats_out, bn.prefix, bn.impl)


def stem_modules(device=None, dtype=torch.float32):
    """conv0 (3 → 64, 7×7 s2 p3, bias-free) and norm0."""
    return (Conv2d(3, INIT_FEATURES, 7, 2, 3, bias=False, device=device, dtype=dtype),
            BatchNorm(INIT_FEATURES, device=device, dtype=dtype))


def stem(conv0: Conv2d, norm0: BatchNorm, x: torch.Tensor, bn: BNCtx) -> torch.Tensor:
    """pool0(relu0(norm0(conv0 x))): H/4 by W/4, 64 channels."""
    return max_pool(relu(bn(norm0, conv0(x), "norm0")), 3, stride=2, padding=1)
