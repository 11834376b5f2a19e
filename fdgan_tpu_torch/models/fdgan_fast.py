"""The FDGAN forward that the reference's entry points run.

Counterpart of ``fdgan_tpu/models/fdgan_fast.py``: the JAX engine
(``serve.py:190``), ``cli/demo.py:99``, ``bench.py:50`` and the default
train step (``impl="xla"``, ``train/loop.py:119-122``) all run
``fdgan_fast.apply``. It computes what ``FDGAN.forward`` computes (the
counterpart of ``fdgan.apply(impl="pallas")``), reassociated in two places:

1. **Segment statistics.** In batch mode a dense block's concat has the
   per-channel statistics of its segments (the block input and each layer's
   32 channels), and ``ops.dense.dense_block_fused`` keeps them as it grows
   and returns them beside the concat. The transition after the block folds
   its BN with them (``_SegStats``, ``fdgan_fast.py:47-92``) instead of
   reducing the whole 256/512/1024-channel concat again.
2. **Pool before the conv.** The transition's 1×1 conv and its 2×2 average
   pool are linear and act on different axes, so they commute:
   ``_transition_fast`` (``:182-187``) pools relu(BN(x)) first and runs the
   conv at a quarter of the pixels.

The dense layers run through K1 and K2 and the segment statistics through
``channel_stats`` (``impl="kernels"``; the twins for CPU tensors), or the
plain versions on any device (``impl="plain"``). ``stats_out`` records every
BN's (mean, unbiased var) under the keys and with the correction of
``FDGAN.forward`` and of JAX ``fdgan_fast.apply`` (``:78-85``, ``:122-123``).

Not ported: ``_stem``'s 3→8 channel padding (``:190-199``), a workaround for
the TPU's lane width; ``remat`` (``torch.utils.checkpoint``, with
``accum_steps``).
"""

from __future__ import annotations

import torch

from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.nn.layers import StatsOut, avg_pool, relu, tanh, unbiased
from fdgan_tpu_torch.ops.dense import dense_block_fused, fold_bn


def _transition_fast(trans, x: torch.Tensor, seg_stats, bn_mode: str, stats_out: StatsOut,
                     prefix: str) -> torch.Tensor:
    """norm (folded with the block's statistics in batch mode) → relu → 2×2
    average pool → 1×1 conv, over NHWC x; returns NCHW (channels_last)."""
    norm = trans.norm
    if bn_mode == "batch":
        mean, var = seg_stats
        if stats_out is not None:
            n = x.shape[0] * x.shape[1] * x.shape[2]
            stats_out[f"{prefix}norm"] = (mean.detach(), unbiased(var.detach(), n))
    else:
        mean, var = norm.running_mean, norm.running_var
    a, b = fold_bn(norm.weight, norm.bias, mean, var)
    # b + x·a in one pass (one rounding in bf16), relu in place: the concat is the
    # forward's widest tensor, and each pass over it costs (PERF.md §5)
    h = torch.addcmul(b.to(x.dtype), x, a.to(x.dtype)).relu_()
    # the 2×2 average pool as a mean over the two pixel pairs of the NHWC view (fp32 sums,
    # one rounding, as avg_pool2d); torch's channels_last avg_pool2d reads the wide concat slowly
    bsz, hh, ww, c = h.shape
    h = h.view(bsz, hh // 2, 2, ww // 2, 2, c).mean(dim=(2, 4))
    return trans.conv(h.permute(0, 3, 1, 2))


def _enc_stage(model: FDGAN, i: int, x: torch.Tensor, bn_mode: str, impl: str, stats_out: StatsOut) -> torch.Tensor:
    """Dense block i and the transition after it, NCHW (channels_last) in and out."""
    block, trans = f"dense_block{i}", f"trans_block{i}"
    y, seg = dense_block_fused(
        list(getattr(model, block).children()), x.permute(0, 2, 3, 1).contiguous(), mode=bn_mode, impl=impl,
        stats_out=stats_out, prefix=f"{block}.",
    )
    return _transition_fast(getattr(model, trans), y, seg, bn_mode, stats_out, f"{trans}.")


def apply(model: FDGAN, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels",
          stats_out: StatsOut = None) -> torch.Tensor:
    """The generator's forward over ``model``'s own parameters: NHWC (B, H,
    W, 3) images in, NHWC (B, H, W, 3) out, H and W divisible by 8. The
    arguments are ``FDGAN.forward``'s, and so is the result, to the
    reassociation of the transitions (test: ``tests/test_torch_fdgan_fast.py``)."""
    if bn_mode not in ("batch", "running"):
        raise ValueError(f"unknown BN mode {bn_mode!r}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected NHWC (B, H, W, 3) images, got shape {tuple(x.shape)}")
    if x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f"H and W must be divisible by 8, got {tuple(x.shape[1:3])}")
    stats_out = stats_out if bn_mode == "batch" else None
    m = model
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x0 = relu(m.conv_refin1(x))
    x01 = m.conv_refin2(avg_pool(x0, 2))
    x1 = _enc_stage(m, 1, x0, bn_mode, impl, stats_out)
    x10 = m.conv_refine4(torch.cat([x01, x1], dim=1))
    x2 = _enc_stage(m, 2, x10, bn_mode, impl, stats_out)
    x3 = _enc_stage(m, 3, x2, bn_mode, impl, stats_out)
    x22 = m.conv_refin5(avg_pool(x2, 2))
    x4 = m.conv_refin6(torch.cat([x3, x22], dim=1))
    x4 = m.trans_block4(m.dense_block4(x4))
    x5 = m.trans_block5(m.dense_block5(torch.cat([x4, x2], dim=1)))
    x6 = m.trans_block6(m.dense_block6(x5))
    y = tanh(m.conv_refin3(x6))
    return y.permute(0, 2, 3, 1).contiguous()
