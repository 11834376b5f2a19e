"""Host-side image helpers (numpy; PIL is imported only where a file is read).

Counterpart of the parts of ``fdgan_tpu/utils/images.py`` that serving uses.
"""

from __future__ import annotations

import numpy as np


def load_rgb_image(filename: str) -> np.ndarray:
    """HWC float32 in [0, 255] (reference ``tensor_load_rgbimage``, utils.py:11-24)."""
    from PIL import Image

    return np.asarray(Image.open(filename).convert("RGB"), np.float32)


def normalize_to_uint8(arr: np.ndarray) -> np.ndarray:
    """Min/max-normalise an HWC float tensor to 8-bit — the reference's
    ``vutils.save_image(..., normalize=True, scale_each=False)`` output
    protocol (demo.py:151), shared by the PNG writers and the HTTP encoder."""
    a = np.asarray(arr, np.float32)
    lo, hi = float(a.min()), float(a.max())
    a = (a - lo) / max(hi - lo, 1e-5)
    return (a * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
