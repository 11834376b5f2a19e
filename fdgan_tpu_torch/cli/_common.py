"""Shared CLI helpers: generator loading and the reference's PNG output."""

from __future__ import annotations

import numpy as np
import torch


def save_image_normalized(arr_hwc: np.ndarray, path: str) -> None:
    """``vutils.save_image(..., normalize=True, scale_each=False)`` semantics
    (demo.py:151): min/max-normalise to [0, 1], then write 8-bit."""
    from PIL import Image

    from fdgan_tpu_torch.utils.images import normalize_to_uint8

    Image.fromarray(normalize_to_uint8(arr_hwc)).save(path)


def load_generator(path: str, device="cpu", dtype=torch.float32):
    """An FDGAN generator on ``device`` in ``dtype`` from a reference
    ``.pth`` checkpoint (DataParallel prefixes handled)."""
    from fdgan_tpu_torch.io.torch_import import load_torch_state_dict
    from fdgan_tpu_torch.models.fdgan import FDGAN

    if not (path.endswith(".pth") or path.endswith(".pt")):
        raise ValueError(f"{path}: the port loads .pth checkpoints only")
    model = FDGAN(device=device, dtype=dtype)
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    return model
