"""Contextual loss (Mechrez-style CX), as ``fdgan_tpu/losses/contextual.py``
computes it: the recovered ``ContextualLoss`` of the reference's orphaned
``loss.cpython-36.pyc`` (lines 23-73), with sigma 0.1, b 1.0, epsilon 1e-5
and cosine similarity.

- the target's per-sample channel mean is taken from both feature sets,
  each position's C-vector is L2-normalised, d = 1 − ⟨î, t̂⟩;
- d̃ = d / (min over target positions + ε);
- w = exp((b − d̃)/σ), normalised over target positions;
- CX = −log(mean over target positions of the max over image positions),
  averaged over the batch.

Everything is fp32; the cosine products are one batched ``torch.matmul``.
Quadratic in H·W: it is meant for downsampled VGG features (relu3_3).

With H sharded (``dist.halo_exchange.spatial_sharding``, over a spatial
group of n ranks) each rank holds a band of both feature maps, and every
image position meets every target position across the bands. JAX's GSPMD
partitions the term unasked; here it is written out:

- each rank gathers the target's features (``halo_exchange.gather_rows``),
  so that the target mean and the normalised targets are the whole image's;
- each rank builds only its band's rows of d (its image positions × all
  target positions): no rank holds the (B, N, N) matrix, only N/n of its
  rows, and so does everything the backward saves;
- the min and the normalisation over target positions are local to a row;
- the max over image positions of each target column is taken over the
  group (``halo_exchange.group_amax``, an all-reduce MAX);
- the result is the same on every rank, and each rank returns its 1/n share
  of it, as ``global_mean`` and SSIM's 1 − s do, so that the shares of a
  group add up to the whole image's CX.
"""

from __future__ import annotations

import torch

from fdgan_tpu_torch.dist import halo_exchange


def contextual_loss(image_features: torch.Tensor, target_features: torch.Tensor, sigma: float = 0.1,
                    b: float = 1.0, epsilon: float = 1e-5) -> torch.Tensor:
    """CX loss between two NHWC feature maps (each position a C-vector); with
    H sharded, this rank's share of the whole image's (the module's
    docstring)."""
    shard = halo_exchange.current()
    if shard is not None:
        target_features = halo_exchange.gather_rows(target_features, dim=1, shard=shard)
    bsz, c = image_features.shape[0], image_features.shape[-1]
    i_feat = image_features.reshape(bsz, -1, c).float()
    t_feat = target_features.reshape(bsz, -1, c).float()
    t_mean = t_feat.mean(dim=1, keepdim=True)
    i_cent, t_cent = i_feat - t_mean, t_feat - t_mean
    i_norm = i_cent / (torch.linalg.vector_norm(i_cent, dim=-1, keepdim=True) + 1e-12)
    t_norm = t_cent / (torch.linalg.vector_norm(t_cent, dim=-1, keepdim=True) + 1e-12)
    d = 1.0 - torch.matmul(i_norm, t_norm.transpose(1, 2))  # (B, N_img, N_tgt): this band's rows with H sharded
    d_tilde = d / (d.amin(dim=2, keepdim=True) + epsilon)
    wgt = torch.exp((b - d_tilde) / sigma)
    cx_ij = wgt / wgt.sum(dim=2, keepdim=True)
    best = cx_ij.amax(dim=1) if shard is None else halo_exchange.group_amax(cx_ij, dim=1, shard=shard)
    loss = (-torch.log(best.mean(dim=1) + 1e-12)).mean()
    return loss if shard is None else loss / shard.size
