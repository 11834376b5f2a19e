"""Image-folder datasets — fixed-behaviour counterparts of the reference's
``datasets/folder.py`` (class-per-subdirectory) and
``datasets/classification.py`` (h5 + scalar label).

The reference versions draw a RANDOM index on every ``__getitem__`` call
(folder.py:99-101, classification.py:46-47) — a bug that breaks shuffling,
epoch coverage, and reproducibility. These implementations index
deterministically (SURVEY.md §4.5: document, don't replicate). A copy of
``fdgan_tpu/data/folder.py``; h5py and PIL are imported where a file is read.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def find_classes(directory: str) -> Tuple[List[str], dict]:
    classes = sorted(
        d for d in os.listdir(directory) if os.path.isdir(os.path.join(directory, d))
    )
    return classes, {c: i for i, c in enumerate(classes)}


def make_dataset(directory: str, class_to_idx: dict) -> List[Tuple[str, int]]:
    items = []
    for target in sorted(class_to_idx):
        droot = os.path.join(directory, target)
        for root, _, fnames in sorted(os.walk(droot)):
            for fname in sorted(fnames):
                if is_image_file(fname):
                    items.append((os.path.join(root, fname), class_to_idx[target]))
    return items


class ImageFolder:
    """(image HWC float32 [0,1], class index) per item, deterministic."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        classes, class_to_idx = find_classes(root)
        self.root = root
        self.classes = classes
        self.imgs = make_dataset(root, class_to_idx)
        if not self.imgs:
            raise RuntimeError(f"no images under {root} (extensions {IMG_EXTENSIONS})")
        self.transform = transform

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, index: int):
        from PIL import Image

        path, target = self.imgs[index]
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        if self.transform is not None:
            (img,) = self.transform(img)
        return img, target


class ClassificationH5:
    """h5 files with `haze` + scalar `label` (mean − 1, matching the
    reference's datasets/classification.py:32-75 semantics), indexed
    deterministically."""

    def __init__(self, root: str):
        import glob

        self.root = root
        self._len = len(glob.glob(os.path.join(root, "*h5")))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, index: int):
        import h5py

        with h5py.File(os.path.join(self.root, f"{index}.h5"), "r") as f:
            haze = np.asarray(f["haze"][:], np.float32)
            label = float(np.asarray(f["label"]).mean()) - 1.0
        return haze, label
