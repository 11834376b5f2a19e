"""Colour-space conversions on NHWC tensors.

Counterpart of ``fdgan_tpu/ops/colors.py`` (the reference's
``models/pytorch_colors/__init__.py:15-91``, which round-trips through
skimage on the host): the same conversions in torch, on the tensor's own
device, with skimage's conventions and the JAX module's constants (RGB in
[0, 1], BT.601 YUV and YCbCr, the D65/2° white point for XYZ and Lab, and
the Ruifrok-Johnston HED stain matrix with skimage's log adjustment).
Nothing on a path of either package calls it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ITU-R BT.601 (skimage's yuv and ycbcr conventions)
_RGB2YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14714119, -0.28886916, 0.43601035],
     [0.61497538, -0.51496512, -0.10001026]]
)
_RGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]]
)
_XYZ_REF_WHITE = np.array([0.95047, 1.0, 1.08883])  # D65
# HED: skimage.color.rgb_from_hed, with the log-adjusted semantics (clamp at
# 1e-6, normalise by log(1e-6)) that make rgb2hed and hed2rgb exact inverses
_RGB_FROM_HED = np.array(
    [[0.65, 0.70, 0.29],
     [0.07, 0.99, 0.11],
     [0.27, 0.57, 0.78]]
)
_HED_FROM_RGB = np.linalg.inv(_RGB_FROM_HED)
_LOG_ADJUST = math.log(1e-6)
_EPS, _KAPPA = 0.008856, 7.787  # the Lab transfer function's knee and slope


def _const(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=x.dtype, device=x.device)


def _matmul_last(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """y[..., d] = Σ_c x[..., c]·m[d, c]."""
    return torch.einsum("...c,dc->...d", x, _const(m, x))


def rgb2yuv(x: torch.Tensor) -> torch.Tensor:
    return _matmul_last(x, _RGB2YUV)


def yuv2rgb(x: torch.Tensor) -> torch.Tensor:
    return _matmul_last(x, np.linalg.inv(_RGB2YUV))


def rgb2ycbcr(x: torch.Tensor) -> torch.Tensor:
    """skimage's convention: Y in [16, 235], Cb and Cr in [16, 240] for [0, 1] input."""
    r, g, b = x.unbind(-1)
    y = 65.481 * r + 128.553 * g + 24.966 * b + 16.0
    cb = -37.797 * r - 74.203 * g + 112.0 * b + 128.0
    cr = 112.0 * r - 93.786 * g - 18.214 * b + 128.0
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr2rgb(x: torch.Tensor) -> torch.Tensor:
    y, cb, cr = x[..., 0] - 16.0, x[..., 1] - 128.0, x[..., 2] - 128.0
    r = 0.00456621 * y + 0.00625893 * cr
    g = 0.00456621 * y - 0.00153632 * cb - 0.00318811 * cr
    b = 0.00456621 * y + 0.00791071 * cb
    return torch.stack([r, g, b], dim=-1)


def rgb2xyz(x: torch.Tensor) -> torch.Tensor:
    x = torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    return _matmul_last(x, _RGB2XYZ)


def xyz2rgb(x: torch.Tensor) -> torch.Tensor:
    x = _matmul_last(x, np.linalg.inv(_RGB2XYZ))
    x = torch.where(x > 0.0031308, 1.055 * x.clamp_min(1e-8) ** (1 / 2.4) - 0.055, 12.92 * x)
    return x.clamp(0.0, 1.0)


def rgb2lab(x: torch.Tensor) -> torch.Tensor:
    xyz = rgb2xyz(x) / _const(_XYZ_REF_WHITE, x)
    f = torch.where(xyz > _EPS, xyz.clamp_min(1e-8) ** (1.0 / 3.0), _KAPPA * xyz + 16.0 / 116.0)
    fx, fy, fz = f.unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab2rgb(x: torch.Tensor) -> torch.Tensor:
    lum, a, b = x.unbind(-1)
    fy = (lum + 16.0) / 116.0
    f = torch.stack([fy + a / 500.0, fy, fy - b / 200.0], dim=-1)
    xyz = torch.where(f**3 > _EPS, f**3, (f - 16.0 / 116.0) / _KAPPA)
    return xyz2rgb(xyz * _const(_XYZ_REF_WHITE, x))


def rgb2hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x.unbind(-1)
    v = x.amax(dim=-1)
    delta = v - x.amin(dim=-1)
    safe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(v == r, (g - b) / safe, torch.where(v == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(delta == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    s = torch.where(v == 0, 0.0, delta / torch.where(v == 0, 1.0, v))
    return torch.stack([h, s, v], dim=-1)


def hsv2rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - f * s), v * (1.0 - (1.0 - f) * s)
    sector = torch.remainder(i.long(), 6).clamp(0, 5).unsqueeze(-1)

    def pick(*choices):  # the JAX module's jnp.choose(i, choices, mode="clip")
        return torch.stack(choices, dim=-1).gather(-1, sector).squeeze(-1)

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], dim=-1)


def rgb2hed(x: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] → HED stain concentrations (non-negative)."""
    x = x.clamp_min(1e-6)
    stains = torch.einsum("...c,cd->...d", torch.log(x) / _LOG_ADJUST, _const(_HED_FROM_RGB, x))
    return stains.clamp_min(0.0)


def hed2rgb(x: torch.Tensor) -> torch.Tensor:
    """HED stain concentrations → RGB in [0, 1]."""
    log_rgb = torch.einsum("...c,cd->...d", x * _LOG_ADJUST, _const(_RGB_FROM_HED, x))
    return torch.exp(log_rgb).clamp(0.0, 1.0)


_CONVERTERS = {
    ("rgb", "yuv"): rgb2yuv,
    ("yuv", "rgb"): yuv2rgb,
    ("rgb", "ycbcr"): rgb2ycbcr,
    ("ycbcr", "rgb"): ycbcr2rgb,
    ("rgb", "xyz"): rgb2xyz,
    ("xyz", "rgb"): xyz2rgb,
    ("rgb", "lab"): rgb2lab,
    ("lab", "rgb"): lab2rgb,
    ("rgb", "hsv"): rgb2hsv,
    ("hsv", "rgb"): hsv2rgb,
    ("rgb", "hed"): rgb2hed,
    ("hed", "rgb"): hed2rgb,
}


def convert(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """pytorch_colors' ``convert()`` (``__init__.py:83-91``): one conversion,
    or two through RGB; an unknown pair raises ``ValueError``."""
    if src == dst:
        return x
    key = (src.lower(), dst.lower())
    if key in _CONVERTERS:
        return _CONVERTERS[key](x)
    if (src, "rgb") in _CONVERTERS and ("rgb", dst) in _CONVERTERS:
        return _CONVERTERS[("rgb", dst)](_CONVERTERS[(src, "rgb")](x))
    raise ValueError(f"no converter {src} -> {dst}")
