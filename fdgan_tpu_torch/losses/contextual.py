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
"""

from __future__ import annotations

import torch


def contextual_loss(image_features: torch.Tensor, target_features: torch.Tensor, sigma: float = 0.1,
                    b: float = 1.0, epsilon: float = 1e-5) -> torch.Tensor:
    """CX loss between two NHWC feature maps (each position a C-vector)."""
    bsz, h, w, c = image_features.shape
    i_feat = image_features.reshape(bsz, h * w, c).float()
    t_feat = target_features.reshape(bsz, h * w, c).float()
    t_mean = t_feat.mean(dim=1, keepdim=True)
    i_cent, t_cent = i_feat - t_mean, t_feat - t_mean
    i_norm = i_cent / (torch.linalg.vector_norm(i_cent, dim=-1, keepdim=True) + 1e-12)
    t_norm = t_cent / (torch.linalg.vector_norm(t_cent, dim=-1, keepdim=True) + 1e-12)
    d = 1.0 - torch.matmul(i_norm, t_norm.transpose(1, 2))  # (B, N_img, N_tgt)
    d_tilde = d / (d.amin(dim=2, keepdim=True) + epsilon)
    wgt = torch.exp((b - d_tilde) / sigma)
    cx_ij = wgt / wgt.sum(dim=2, keepdim=True)
    cx = cx_ij.amax(dim=1).mean(dim=1)
    return (-torch.log(cx + 1e-12)).mean()
