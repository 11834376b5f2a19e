"""Image helpers — parity with the reference's ``myutils/utils.py``
(:11-81): load/save RGB images, BGR channel games, ImageNet-mean (BGR,
0-255 scale) add/subtract, RGB↔BGR batch flip.

Counterpart of ``fdgan_tpu/utils/images.py``. Host-side images are numpy HWC
float arrays in [0, 255], as the reference's conventions have them; PIL is
imported only where a file is read or written. The batch helpers take and
return NHWC torch tensors on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# BGR ImageNet mean on the 0-255 scale (myutils/utils.py:51-58)
IMAGENET_MEAN_BGR = (103.939, 116.779, 123.680)


def load_rgb_image(
    filename: str, size: Optional[int] = None, scale: Optional[float] = None, keep_asp: bool = False
) -> np.ndarray:
    """HWC float32 [0,255] (reference `tensor_load_rgbimage`, utils.py:11-24)."""
    from PIL import Image

    img = Image.open(filename).convert("RGB")
    if size is not None:
        if keep_asp:
            size2 = int(size * 1.0 / img.size[0] * img.size[1])
            img = img.resize((size, size2), Image.LANCZOS)
        else:
            img = img.resize((size, size), Image.LANCZOS)
    elif scale is not None:
        img = img.resize((int(img.size[0] / scale), int(img.size[1] / scale)), Image.LANCZOS)
    return np.asarray(img, np.float32)


def normalize_to_uint8(arr: np.ndarray) -> np.ndarray:
    """Min/max-normalise an HWC float tensor to 8-bit — the reference's
    ``vutils.save_image(..., normalize=True, scale_each=False)`` output
    protocol (demo.py:151), shared by the PNG writers and the HTTP encoder."""
    a = np.asarray(arr, np.float32)
    lo, hi = float(a.min()), float(a.max())
    a = (a - lo) / max(hi - lo, 1e-5)
    return (a * 255.0 + 0.5).clip(0, 255).astype(np.uint8)


def save_rgb_image(arr: np.ndarray, filename: str) -> None:
    """HWC [0,255] → 8-bit PNG (reference `tensor_save_rgbimage`, :27-34)."""
    from PIL import Image

    img = np.clip(np.asarray(arr), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(filename)


def save_bgr_image(arr: np.ndarray, filename: str) -> None:
    """BGR HWC → RGB save (reference `tensor_save_bgrimage`, :37-40)."""
    save_rgb_image(np.asarray(arr)[..., ::-1], filename)


def _mean(batch: torch.Tensor) -> torch.Tensor:
    return torch.tensor(IMAGENET_MEAN_BGR, dtype=batch.dtype, device=batch.device)


def subtract_imagenet_mean_batch(batch: torch.Tensor) -> torch.Tensor:
    """BGR NHWC [0,255] minus ImageNet mean (utils.py:51-58)."""
    return batch - _mean(batch)


def add_imagenet_mean_batch(batch: torch.Tensor) -> torch.Tensor:
    """Inverse of the above (utils.py:61-68)."""
    return batch + _mean(batch)


def imagenet_clamp_batch(batch: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Clamp a mean-subtracted BGR batch to [low-mean, high-mean] per channel
    (utils.py:70-73)."""
    mean = _mean(batch)
    return torch.clamp(batch, low - mean, high - mean)


def preprocess_batch(batch: torch.Tensor) -> torch.Tensor:
    """RGB↔BGR channel flip on NHWC (reference `preprocess_batch`, :76-81)."""
    return torch.flip(batch, dims=(-1,))
