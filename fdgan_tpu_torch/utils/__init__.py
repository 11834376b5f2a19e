"""Image helpers, as in ``fdgan_tpu/utils``."""

from fdgan_tpu_torch.utils.images import (
    load_rgb_image,
    save_rgb_image,
    save_bgr_image,
    subtract_imagenet_mean_batch,
    add_imagenet_mean_batch,
    preprocess_batch,
)

__all__ = [
    "load_rgb_image",
    "save_rgb_image",
    "save_bgr_image",
    "subtract_imagenet_mean_batch",
    "add_imagenet_mean_batch",
    "preprocess_batch",
]
