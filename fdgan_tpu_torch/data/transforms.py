"""Paired image transforms — numpy HWC equivalents of the reference's
``transforms/pix2pix.py:10-222`` two-image transform set. Crop coordinates
and flip decisions are shared across the pair, exactly as the reference's
RandomCrop (shared x1, y1 at :192-207) and RandomHorizontalFlip (shared flag
at :216-221) do.

All transforms take and return float32 HWC arrays (plus any extra paired
arrays), so they compose with ``PairedH5Dataset``. A copy of
``fdgan_tpu/data/transforms.py``: numpy only, the same random draws.
"""

from __future__ import annotations

import numbers
import random
from typing import Optional, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, *imgs):
        for t in self.transforms:
            imgs = t(*imgs)
        return imgs


class ToArray:
    """[0,255] uint8 → [0,1] float32 (ToTensor analog, without the CHW
    transpose — NHWC is the native layout here)."""

    def __call__(self, *imgs):
        return tuple(np.asarray(i, np.float32) / 255.0 if i.dtype == np.uint8 else np.asarray(i, np.float32) for i in imgs)


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, *imgs):
        return tuple((i - self.mean) / self.std for i in imgs)


class Scale:
    """Resize so the smaller edge equals `size` (bilinear), aspect kept."""

    def __init__(self, size: int):
        self.size = size

    def _resize(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        if (w <= h and w == self.size) or (h <= w and h == self.size):
            return img
        if w < h:
            ow, oh = self.size, int(self.size * h / w)
        else:
            oh, ow = self.size, int(self.size * w / h)
        return _bilinear_resize(img, oh, ow)

    def __call__(self, *imgs):
        return tuple(self._resize(i) for i in imgs)


class CenterCrop:
    def __init__(self, size):
        self.size = (int(size), int(size)) if isinstance(size, numbers.Number) else tuple(size)

    def __call__(self, *imgs):
        th, tw = self.size
        out = []
        for img in imgs:
            h, w = img.shape[:2]
            y1 = int(round((h - th) / 2.0))
            x1 = int(round((w - tw) / 2.0))
            out.append(img[y1 : y1 + th, x1 : x1 + tw])
        return tuple(out)


class Pad:
    def __init__(self, padding: int, fill: float = 0.0):
        self.padding = padding
        self.fill = fill

    def __call__(self, *imgs):
        p = self.padding
        return tuple(
            np.pad(i, ((p, p), (p, p), (0, 0)), constant_values=self.fill) for i in imgs
        )


class Lambda:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *imgs):
        return tuple(self.fn(i) for i in imgs)


class RandomCrop:
    """Shared-coordinate random crop across the pair."""

    def __init__(self, size, padding: int = 0, rng: Optional[random.Random] = None):
        self.size = (int(size), int(size)) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding
        self.rng = rng or random

    def __call__(self, *imgs):
        th, tw = self.size
        out = []
        x1 = y1 = -1
        for img in imgs:
            if self.padding > 0:
                img = np.pad(img, ((self.padding,) * 2, (self.padding,) * 2, (0, 0)))
            h, w = img.shape[:2]
            if w == tw and h == th:
                out.append(img)
                continue
            if x1 == -1 and y1 == -1:
                x1 = self.rng.randint(0, w - tw)
                y1 = self.rng.randint(0, h - th)
            out.append(img[y1 : y1 + th, x1 : x1 + tw])
        return tuple(out)


class RandomHorizontalFlip:
    """Shared-decision horizontal flip."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or random

    def __call__(self, *imgs):
        if self.rng.random() < 0.5:
            return tuple(np.ascontiguousarray(i[:, ::-1]) for i in imgs)
        return imgs


def _bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Dependency-free bilinear resize (align_corners=False convention)."""
    h, w = img.shape[:2]
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)
