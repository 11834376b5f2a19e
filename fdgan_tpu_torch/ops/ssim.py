"""Differentiable SSIM, as ``fdgan_tpu/ops/ssim.py`` computes it.

The reference's ``models/pytorch_ssim``: an 11-tap Gaussian window with
σ = 1.5 (the 2-D window is the outer product of the normalised 1-D one),
zero padding of 5, C1 = 0.01², C2 = 0.03², the mean of the SSIM map.

Everything runs in fp32: the E[x²] − μ² cancellation makes the result
useless at reduced precision. So the separable window is applied as
shifted-slice sums, which no card runs in TF32, forward or backward.

With H sharded (``dist.halo_exchange.spatial_sharding``) the H pass takes
its 5 rows a side from the neighbouring shards, zeros at the image's ends
(the zero padding of the whole image), and :func:`ssim` is this rank's
share of the whole image's mean (``halo_exchange.global_mean``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fdgan_tpu_torch.dist import halo_exchange

SSIM_WINDOW_SIZE = 11


def gaussian_window_1d() -> np.ndarray:
    """Normalised exp(−(x − w//2)² / 2σ²) over the 11-tap window, σ = 1.5, fp32."""
    w, sigma = SSIM_WINDOW_SIZE, 1.5
    g = np.array([math.exp(-((x - w // 2) ** 2) / (2.0 * sigma**2)) for x in range(w)])
    return (g / g.sum()).astype(np.float32)


def _sep_filter(x: torch.Tensor, taps, pad: int) -> torch.Tensor:
    """Zero-padded separable filter of NHWC x: along H, then along W; with H
    sharded the H pass reads the neighbours' rows (zeros at the ends)."""
    n, h, w = len(taps), x.shape[1], x.shape[2]
    shard = halo_exchange.current()
    if shard is not None:
        top, bottom = halo_exchange.halo_rows(x, pad, pad, shard=shard)
        a = torch.cat([top, x, bottom], dim=1)
    else:
        a = F.pad(x, (0, 0, 0, 0, pad, pad))
    y = taps[0] * a[:, 0:h]
    for k in range(1, n):
        y = y + taps[k] * a[:, k:k + h]
    a = F.pad(y, (0, 0, pad, pad))
    y = taps[0] * a[:, :, 0:w]
    for k in range(1, n):
        y = y + taps[k] * a[:, :, k:k + w]
    return y


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM of two NHWC images, fp32."""
    taps = [float(t) for t in gaussian_window_1d()]
    img1, img2 = img1.float(), img2.float()
    c = img1.shape[-1]
    f = _sep_filter(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1), taps, SSIM_WINDOW_SIZE // 2)
    mu1, mu2, exx, eyy, exy = (f[..., i * c:(i + 1) * c] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq, sigma2_sq, sigma12 = exx - mu1_sq, eyy - mu2_sq, exy - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two NHWC images (with H sharded, this rank's share of
    it: ``halo_exchange.global_mean``)."""
    return halo_exchange.global_mean(ssim_map(img1, img2))
