"""Datasets and the batching loader (h5 pairs, image folders), as in
``fdgan_tpu/data``."""

from fdgan_tpu_torch.data.h5 import PairedH5Dataset, DataLoader, get_loader
from fdgan_tpu_torch.data import transforms
from fdgan_tpu_torch.data.folder import ImageFolder, ClassificationH5

__all__ = [
    "PairedH5Dataset",
    "DataLoader",
    "get_loader",
    "transforms",
    "ImageFolder",
    "ClassificationH5",
]
