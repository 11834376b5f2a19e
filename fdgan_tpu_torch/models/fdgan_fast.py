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

``remat`` is JAX's structured rematerialisation through
``torch.utils.checkpoint``. Not ported: ``_stem``'s 3→8 channel padding
(``:190-199``), a workaround for the TPU's lane width.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def _enc_stage(model: FDGAN, i: int, x: torch.Tensor, bn_mode: str, impl: str, capture: bool,
               remat) -> Tuple[torch.Tensor, dict]:
    """Dense block i and the transition after it, NCHW (channels_last) in and
    out. The stage's batch statistics are an output (a dict of its own, as
    JAX ``_enc_stage`` returns its collector, ``fdgan_fast.py:156-166``), so
    that under ``remat="stages"`` the recompute writes no caller's dict."""
    block, trans = f"dense_block{i}", f"trans_block{i}"

    def core(xin):
        col = {} if capture else None
        y, seg = dense_block_fused(
            list(getattr(model, block).children()), xin.permute(0, 2, 3, 1).contiguous(), mode=bn_mode, impl=impl,
            stats_out=col, prefix=f"{block}.", remat=bool(remat),
        )
        return _transition_fast(getattr(model, trans), y, seg, bn_mode, col, f"{trans}."), col or {}

    return _checkpoint(core, x) if remat == "stages" else core(x)


def _dec_stage(bottleneck, transition, v: torch.Tensor, remat) -> torch.Tensor:
    """A decoder bottleneck and the transition after it, checkpointed under
    remat (JAX ``_dec_stage``: its activations are the backward's largest)."""
    def core(x):
        return transition(bottleneck(x))

    return _checkpoint(core, v) if remat else core(v)


def _checkpoint(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward, where
    autograd records (non-reentrant: the recompute runs with grad enabled,
    as the first pass, so the dense blocks take the same ``torch.cat`` path)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def apply(model: FDGAN, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels",
          stats_out: StatsOut = None, remat=False) -> torch.Tensor:
    """The generator's forward over ``model``'s own parameters: NHWC (B, H,
    W, 3) images in, NHWC (B, H, W, 3) out, H and W divisible by 8. The
    arguments are ``FDGAN.forward``'s, and so is the result, to the
    reassociation of the transitions (test: ``tests/test_torch_fdgan_fast.py``).

    ``remat`` (False | True | "stages"), as JAX ``fdgan_fast.apply``'s
    (``:202-253``), recomputes activations in the backward with
    ``torch.utils.checkpoint``; the values are the same in every mode. True
    checkpoints each dense layer's core (K2, the fold, K1) and each decoder
    stage; "stages" also each encoder block with its transition."""
    if bn_mode not in ("batch", "running"):
        raise ValueError(f"unknown BN mode {bn_mode!r}")
    if remat not in (False, True, "stages"):
        raise ValueError(f"remat must be False, True or 'stages'; got {remat!r}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected NHWC (B, H, W, 3) images, got shape {tuple(x.shape)}")
    if x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f"H and W must be divisible by 8, got {tuple(x.shape[1:3])}")
    capture = stats_out is not None and bn_mode == "batch"
    m = model
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x0 = relu(m.conv_refin1(x))
    x01 = m.conv_refin2(avg_pool(x0, 2))
    x1, col1 = _enc_stage(m, 1, x0, bn_mode, impl, capture, remat)
    x10 = m.conv_refine4(torch.cat([x01, x1], dim=1))
    x2, col2 = _enc_stage(m, 2, x10, bn_mode, impl, capture, remat)
    x3, col3 = _enc_stage(m, 3, x2, bn_mode, impl, capture, remat)
    if capture:
        for col in (col1, col2, col3):
            stats_out.update(col)
    x22 = m.conv_refin5(avg_pool(x2, 2))
    x4 = m.conv_refin6(torch.cat([x3, x22], dim=1))
    x4 = _dec_stage(m.dense_block4, m.trans_block4, x4, remat)
    x5 = _dec_stage(m.dense_block5, m.trans_block5, torch.cat([x4, x2], dim=1), remat)
    x6 = _dec_stage(m.dense_block6, m.trans_block6, x5, remat)
    y = tanh(m.conv_refin3(x6))
    return y.permute(0, 2, 3, 1).contiguous()
