"""Frequency priors of the fusion discriminator: the plain version of K3.

Counterpart of ``fdgan_tpu/ops/filters.py``. :func:`frequency_fuse` builds
the discriminator's 9-channel input, concat[RGB, LF, HF] in NHWC:

* LF, :func:`blur`: the input normalised with the ImageNet statistics,
  reflect-padded by 7 and filtered with the separable 15×15 σ=3 Gaussian;
* HF, :func:`laplace`: the raw input, zero-padded by 1, filtered with the
  3×3 Laplacian (ones, centre −8; the JAX module's ``laplacian_kernel_2d``).

The rounding points are those of the Pallas kernel (``ops/pallas_filters.py``)
that the CUDA kernel K3 replaces, not those of XLA's depthwise convs: x is
normalised in x's dtype; both filters accumulate in fp32 with fp32 taps, in
the kernel's order; LF and HF are rounded to x's dtype once, at the end.
Everything is shifted-slice arithmetic, so no conv runs in TF32 on a card
and autograd differentiates it as it stands.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BLUR_SIZE = 15
BLUR_SIGMA = 3.0
BLUR_PAD = BLUR_SIZE // 2  # 7


def gaussian_1d(l: int = BLUR_SIZE, sigma: float = BLUR_SIGMA) -> np.ndarray:
    """Unnormalised 1-D Gaussian on the reference's grid
    ``arange(-l//2+1, l//2+1)`` (symmetric for odd l)."""
    ax = np.arange((-l) // 2 + 1.0, l // 2 + 1.0)
    return np.exp(-(ax**2) / (2.0 * sigma**2))


def blur_taps() -> np.ndarray:
    """The 15 fp32 taps of both Gaussian passes: outer(t, t) is the
    sum-normalised 2-D kernel. K3 reads the same values."""
    t = gaussian_1d()
    return (t / t.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mean_std(dtype: torch.dtype, device: torch.device):
    """IMAGENET_MEAN and IMAGENET_STD as tensors of ``dtype`` on ``device``,
    copied there once: a copy from the host at every call would make the
    host wait for the device (K3's backward runs this plain version). Made
    outside inference mode, whichever mode the first call runs in, so that
    autograd may save them."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
                torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalise(x: torch.Tensor) -> torch.Tensor:
    """(x − mean) / std per channel of NHWC x, in x's dtype."""
    mean, std = _mean_std(x.dtype, x.device)
    return (x - mean) / std


def _planes(x: torch.Tensor) -> torch.Tensor:
    """NHWC → fp32 (B, C, H, W)."""
    return x.permute(0, 3, 1, 2).float()


def _extend(x: torch.Tensor, halo, rows: int) -> torch.Tensor:
    """x with the last ``rows`` rows of halo's top before it and the first
    ``rows`` of its bottom after it, along H (either may be None)."""
    top, bottom = halo
    parts = ([top[:, top.shape[1] - rows:]] if top is not None else []) + [x] + \
        ([bottom[:, :rows]] if bottom is not None else [])
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def _check_halo(x: torch.Tensor, halo) -> tuple:
    """halo as (top, bottom); raises unless each is None or (B, ≥7, W, 3) in
    x's dtype."""
    top, bottom = halo if halo is not None else (None, None)
    for name, r in (("top", top), ("bottom", bottom)):
        if r is not None and (r.dim() != 4 or r.shape[0] != x.shape[0] or r.shape[1] < BLUR_PAD
                              or r.shape[2:] != x.shape[2:] or r.dtype != x.dtype):
            raise ValueError(f"halo {name} must be (B, >={BLUR_PAD}, W, C) of x's shape and dtype, got "
                             f"{tuple(r.shape)} {r.dtype} for x {tuple(x.shape)} {x.dtype}")
    return top, bottom


def blur(x: torch.Tensor, halo=None) -> torch.Tensor:
    """LF branch over NHWC x, in x's dtype: a column pass then a row pass of
    the 15 taps, ``acc = acc + t[k]·a[k:]`` from k = 0, in fp32.

    ``halo`` (top, bottom): the 7 rows of the image above and below x, a
    shard of it along H (``dist.halo_exchange.halo_rows``), each None at an
    end of the image; the column pass reads them where it would reflect,
    and reflects only at an end."""
    if min(x.shape[1], x.shape[2]) <= BLUR_PAD:
        raise ValueError(f"blur reflect-pads by {BLUR_PAD}: H and W must exceed it, got {tuple(x.shape[1:3])}")
    h, w = x.shape[1], x.shape[2]
    top, bottom = _check_halo(x, halo)
    if top is None and bottom is None:
        a = F.pad(_planes(normalise(x)), (BLUR_PAD,) * 4, mode="reflect")
    else:
        a = F.pad(_planes(normalise(_extend(x, (top, bottom), BLUR_PAD))),
                  (BLUR_PAD, BLUR_PAD, BLUR_PAD * (top is None), BLUR_PAD * (bottom is None)), mode="reflect")
    taps = [float(t) for t in blur_taps()]
    col = taps[0] * a[:, :, 0:h, :]
    for k in range(1, BLUR_SIZE):
        col = col + taps[k] * a[:, :, k:k + h, :]
    out = taps[0] * col[:, :, :, 0:w]
    for k in range(1, BLUR_SIZE):
        out = out + taps[k] * col[:, :, :, k:k + w]
    return out.permute(0, 2, 3, 1).to(x.dtype)


def laplace(x: torch.Tensor, halo=None) -> torch.Tensor:
    """HF branch over NHWC x, in x's dtype: the sum of the 3×3 neighbourhood
    (zero outside the image) minus 9 × the centre, in fp32. ``halo`` as
    :func:`blur`'s: its rows next to x take the place of the zero rows."""
    h, w = x.shape[1], x.shape[2]
    top, bottom = _check_halo(x, halo)
    if top is None and bottom is None:
        z = F.pad(_planes(x), (1, 1, 1, 1))
    else:
        z = F.pad(_planes(_extend(x, (top, bottom), 1)), (1, 1, int(top is None), int(bottom is None)))
    s = z[:, :, 0:h, 0:w]
    for di in range(3):
        for dj in range(3):
            if di or dj:
                s = s + z[:, :, di:di + h, dj:dj + w]
    out = s - 9.0 * z[:, :, 1:1 + h, 1:1 + w]
    return out.permute(0, 2, 3, 1).to(x.dtype)


def frequency_fuse(x: torch.Tensor, halo=None) -> torch.Tensor:
    """concat[RGB, LF, HF] of NHWC x: (B, H, W, 3) → (B, H, W, 9), x's dtype.
    ``halo`` (top, bottom), as :func:`blur`'s: x is a shard of the image
    along H, and the result is that shard's rows of the whole image's."""
    return torch.cat([x, blur(x, halo), laplace(x, halo)], dim=-1)
