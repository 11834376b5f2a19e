"""The memory-efficient DenseNet dehazing network (counterpart of
``fdgan_tpu/models/densenet_dehaze.py``, the working re-design of the
reference's abandoned ``models/densenet.py``):

    conv0 3→64 (3×3 s1) → relu
    denseblock1 64→576  → transition1 ÷2 → 288
    denseblock2 288→800 → transition2 ÷2 → 400
    denseblock3 400→912 → transition3 ÷2 → 456
    denseblock4 456→968 → transition4 ÷2 → 484
    up5: 484→256 ×2, cat x3 (456) → 712
    up6: 712→384 ×2, cat x2 (400) → 784
    up7: 784→256 ×2
    up8: 256→32  ×2 → refine3 32→3 → tanh

The four dense blocks (16 layers each; block 1 at full resolution) run
through ``ops.dense.dense_block_fused``, K1, K2 and ``channel_stats``. The
decoder's bottlenecks and transitions are the BN-free ``*dy1`` blocks (their
BNs built, never called), plain convolutions. ``remat=True`` checkpoints
each dense block with its transition (``torch.utils.checkpoint``,
non-reentrant), as JAX wraps them in ``jax.checkpoint``, and, as there, only
where no statistics are collected (``stats_out`` is None).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fdgan_tpu_torch.models import densenet
from fdgan_tpu_torch.models.blocks import Bottleneck, Transition
from fdgan_tpu_torch.models.dcpdn import _to_nchw, _to_nhwc
from fdgan_tpu_torch.nn.layers import BNCtx, Conv2d, StatsOut, finish, relu, tanh

BLOCK_CONFIG = (16, 16, 16, 16)
COMPRESSION = 0.5
# (bottleneck in, bottleneck out = transition in and out) of up5 … up8
DECODER = ((484, 256), (712, 384), (784, 256), (256, 128))
DECODER_OUT = (256, 384, 256, 32)


class DenseNetDehaze(nn.Module):
    """NHWC (B, H, W, 3) → tanh (B, H, W, 3); H and W divisible by 16."""

    def __init__(self, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.conv0 = Conv2d(3, 64, 3, padding=1, bias=False, **kw)
        ch = 64
        for i, n in enumerate(BLOCK_CONFIG, start=1):
            self.add_module(f"denseblock{i}", densenet.DenseBlock(ch, n, **kw))
            ch += n * densenet.GROWTH_RATE
            self.add_module(f"transition{i}", densenet.Transition(ch, int(ch * COMPRESSION), **kw))
            ch = int(ch * COMPRESSION)
        for i, ((cin, cout), tout) in enumerate(zip(DECODER, DECODER_OUT), start=5):
            self.add_module(f"dense_block{i}", Bottleneck(cin, cout, use_bn=False, concat=False, **kw))
            self.add_module(f"trans_block{i}", Transition(cout, tout, use_bn=False, **kw))
        self.refine3 = Conv2d(32, 3, 3, padding=1, **kw)
        finish(self, device, generator)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels", stats_out: StatsOut = None,
                remat: bool = False) -> torch.Tensor:
        """``bn_mode``, ``impl`` and ``stats_out`` as ``FDGAN.forward``'s."""
        bn = BNCtx(bn_mode, impl, stats_out)

        def stage(i, h):
            h = densenet.dense_block(getattr(self, f"denseblock{i}"), h, bn.sub(f"denseblock{i}"))
            return densenet.transition(getattr(self, f"transition{i}"), h, bn.sub(f"transition{i}"))

        h = relu(self.conv0(_to_nchw(x, 16)))
        skips = []
        for i in range(1, 5):
            if remat and stats_out is None and torch.is_grad_enabled():
                h = checkpoint(stage, i, h, use_reentrant=False)
            else:
                h = stage(i, h)
            skips.append(h)
        for i in range(5, 9):
            h = getattr(self, f"trans_block{i}")(getattr(self, f"dense_block{i}")(h))
            if i in (5, 6):  # x5 joins x3, x6 joins x2
                h = torch.cat([h, skips[7 - i]], dim=1)
        return _to_nhwc(tanh(self.refine3(h)))
