"""Batch statistics global across the ranks of a data-parallel train step.

The JAX package trains data-parallel by sharding the batch over a mesh and
jitting one step (``fdgan_tpu/dist/mesh.py``, ``train/loop.py:11-12``), so
every batch-mode BatchNorm takes its mean and variance over the global
batch, and autodiff runs through those global statistics. Torch's default
DDP keeps per-rank statistics: a different model. Here each site that
produces batch statistics (``ops/dense.py``: ``channel_stats`` per segment
and K2's ``h_batch_stats``; ``nn/layers.py::batch_norm``: every other BN of
G and D) passes its per-rank (mean, biased var, count) through
:func:`combine`, which returns the global ones.

The combination is the parallel-variance form of Chan et al., in float64
(the kernels reduce their partials in float64 too): with n_r, m_r and v_r
per rank, N = Σ n_r, mean = Σ n_r·m_r / N and var = (Σ n_r·v_r +
Σ n_r·(m_r − mean)²) / N. Every rank puts its (n, m, v) into its own slot of
a zero (world, 1 + 2C) tensor and one differentiable SUM all-reduce
(``torch.distributed.nn.functional.all_reduce``) gives every rank all of
them: each rank then combines the same float64 values in the same order,
and so gets the same bits. The all-reduce's backward is the all-reduce of
the cotangents, so each rank's backward of its own loss, averaged over the
ranks afterwards, is the gradient of the global loss: what SyncBatchNorm
does, and what JAX's autodiff through GSPMD gives. The kernels' autograd
Functions keep their local VJPs; the combination sits outside them.

It is opt-in per step, through the :func:`global_batch_stats` context: the
statistics sites lie deep inside models that serving, the demo, the eval
and the zoo share, and the context keeps their signatures as they are and
keeps every other caller free of collectives (an eval under it on rank 0
alone would hang). The data-parallel step (``train/loop.py``) enters it
around its forwards and backwards both: under remat the backward recomputes
K2, and with it the combination, from a checkpoint. The group is kept in a
module global, not a thread-local, because on the card autograd runs that
backward on its own device thread. Outside the context, with no group, or
with a group of one rank, :func:`combine` returns its inputs as they are and
issues no collective: bit for bit the single-process step.

``collectives`` counts the combination's all-reduces in this process, in
the forward and (through a hook on each output) in the backward.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

_group = None  # the process group of the data-parallel step in progress, or None
collectives = {"forward": 0, "backward": 0}


def reset_counts() -> None:
    collectives.update(forward=0, backward=0)


@contextlib.contextmanager
def global_batch_stats(group: Optional["dist.ProcessGroup"]):
    """Inside the block, :func:`combine` takes the statistics over the ranks
    of ``group`` (None, or a group of one rank: no change)."""
    global _group
    prev = _group
    _group = group if group is not None and dist.get_world_size(group) > 1 else None
    try:
        yield
    finally:
        _group = prev


def _count_backward(grad: torch.Tensor) -> None:
    collectives["backward"] += 1


def combine(mean: torch.Tensor, var: torch.Tensor,
            n: int) -> Tuple[torch.Tensor, torch.Tensor, Union[int, torch.Tensor]]:
    """Per-channel (mean, biased var) of this rank's n values → those of
    the global batch and its count N (a float64 0-d tensor on mean's device;
    ``nn.layers.unbiased`` takes either). Differentiable in mean and var.
    Outside :func:`global_batch_stats` (or in a group of one rank) the
    inputs come back as they are."""
    group = _group
    if group is None:
        return mean, var, n
    from torch.distributed.nn.functional import all_reduce

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    c = mean.shape[0]
    mine = torch.cat([torch.full((1,), float(n), dtype=torch.float64, device=mean.device),
                      mean.double(), var.double()])
    slots = torch.cat([mine.new_zeros(rank, 1 + 2 * c), mine[None], mine.new_zeros(world - rank - 1, 1 + 2 * c)])
    slots = all_reduce(slots, op=dist.ReduceOp.SUM, group=group)
    collectives["forward"] += 1
    if slots.requires_grad:
        slots.register_hook(_count_backward)
    gmean, gvar, total = merge(slots[:, 0], slots[:, 1:1 + c], slots[:, 1 + c:])
    return gmean.to(mean.dtype), gvar.to(var.dtype), total.detach()  # a count: no gradient


def merge(counts: torch.Tensor, means: torch.Tensor, variances: torch.Tensor):
    """The parallel-variance combination (Chan et al.) of P parts: counts
    (P,), per-channel means and biased variances (P, C), in their dtype
    (float64 in :func:`combine`). Returns (mean, biased var, total count)."""
    w = counts[:, None]
    total = counts.sum()
    mean = (w * means).sum(0) / total
    var = ((w * variances).sum(0) + (w * (means - mean).square()).sum(0)) / total
    return mean, var, total
