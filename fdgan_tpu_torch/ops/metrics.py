"""Evaluation metrics matching the reference ``PSNRSSIM.py`` protocol exactly.

* PSNR: ``10·log10(1/MSE)`` on float images in [0,1]          (PSNRSSIM.py:201-205)
* SSIM: per-channel skimage-style ``compare_ssim`` with Gaussian weights
  σ=1.5, win=11, ``use_sample_covariance=False`` (population covariance),
  pad-crop of the filter radius, channel mean                 (PSNRSSIM.py:46-194, 233-240)
* boundary handling: crop SCALE px after truncating to a multiple of SCALE
  (SCALE=1 in the reference)                                  (PSNRSSIM.py:198, 208-223)

Pure NumPy + SciPy — the reference's vendored copy depends on a removed
private NumPy API (`_validate_lengths`) and on skimage, neither of which this
re-implementation needs. A copy of ``fdgan_tpu/ops/metrics.py``, so that the
port needs no JAX to score its outputs.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, uniform_filter

SCALE = 1

_DTYPE_RANGE = {
    np.dtype(np.bool_): (False, True),
    np.dtype(np.uint8): (0, 255),
    np.dtype(np.uint16): (0, 65535),
    np.dtype(np.uint32): (0, 2**32 - 1),
    np.dtype(np.uint64): (0, 2**64 - 1),
    np.dtype(np.int8): (-128, 127),
    np.dtype(np.int16): (-32768, 32767),
    np.dtype(np.int32): (-(2**31), 2**31 - 1),
    np.dtype(np.int64): (-(2**63), 2**63 - 1),
    np.dtype(np.float16): (-1, 1),
    np.dtype(np.float32): (-1, 1),
    np.dtype(np.float64): (-1, 1),
}


def psnr(img_orig: np.ndarray, img_out: np.ndarray) -> float:
    """`output_psnr_mse` (PSNRSSIM.py:201-205): inputs in [0,1]."""
    mse = np.mean(np.square(img_orig - img_out))
    return float(10.0 * np.log10(1.0 / mse))


def _crop(ar: np.ndarray, pad: int) -> np.ndarray:
    slices = tuple(slice(pad, s - pad) for s in ar.shape)
    return ar[slices]


def compare_ssim(
    X: np.ndarray,
    Y: np.ndarray,
    win_size: int | None = None,
    data_range: float | None = None,
    gaussian_weights: bool = False,
    sigma: float = 1.5,
    K1: float = 0.01,
    K2: float = 0.03,
    use_sample_covariance: bool = True,
) -> float:
    """Single-channel skimage-0.13-style SSIM (the protocol the reference
    vendors at PSNRSSIM.py:46-194)."""
    if X.dtype != Y.dtype:
        raise ValueError("Input images must have the same dtype.")
    if X.shape != Y.shape:
        raise ValueError("Input images must have the same dimensions.")

    if win_size is None:
        win_size = 11 if gaussian_weights else 7
    if win_size % 2 != 1:
        raise ValueError("Window size must be odd.")

    if data_range is None:
        dmin, dmax = _DTYPE_RANGE[X.dtype]
        data_range = dmax - dmin

    ndim = X.ndim
    if gaussian_weights:
        filter_func = gaussian_filter
        filter_args = {"sigma": sigma}
    else:
        filter_func = uniform_filter
        filter_args = {"size": win_size}

    X = X.astype(np.float64)
    Y = Y.astype(np.float64)

    NP = win_size**ndim
    cov_norm = NP / (NP - 1) if use_sample_covariance else 1.0

    ux = filter_func(X, **filter_args)
    uy = filter_func(Y, **filter_args)
    uxx = filter_func(X * X, **filter_args)
    uyy = filter_func(Y * Y, **filter_args)
    uxy = filter_func(X * Y, **filter_args)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2
    A1, A2, B1, B2 = (
        2 * ux * uy + C1,
        2 * vxy + C2,
        ux**2 + uy**2 + C1,
        vx + vy + C2,
    )
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return float(_crop(S, pad).mean())


def mssim_channels(ref_img: np.ndarray, res_img: np.ndarray) -> float:
    """Per-channel SSIM mean as in `compute_mssim` (PSNRSSIM.py:233-240):
    uint8 images, Gaussian weights, population covariance."""
    channels = [
        compare_ssim(
            ref_img[:, :, i],
            res_img[:, :, i],
            gaussian_weights=True,
            use_sample_covariance=False,
        )
        for i in range(ref_img.shape[-1])
    ]
    return float(np.mean(channels))


def boundary_crop(F: np.ndarray, scale: int = SCALE) -> np.ndarray:
    """`_open_img` boundary handling (PSNRSSIM.py:208-214)."""
    h, w = F.shape[:2]
    F = F[: h - h % scale, : w - w % scale]
    return F[scale:-scale, scale:-scale]
