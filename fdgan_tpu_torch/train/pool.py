"""CycleGAN-style image replay buffer, copied from ``fdgan_tpu/train/pool.py``
(the reference's ``misc.ImagePool``, misc.py:140-161): until the pool is
full a query stores and returns the incoming batch; then, with p = 0.5, it
swaps the batch for a random stored one. The draws come from a numpy
generator, so a seed gives the JAX package's sequence."""

from __future__ import annotations

from typing import Optional

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: Optional[int] = None):
        self.pool_size = pool_size
        self.num_imgs = 0
        self.images = []
        self._rng = np.random.default_rng(seed)

    def query(self, image):
        if self.pool_size == 0:
            return image
        if self.num_imgs < self.pool_size:
            self.images.append(image)
            self.num_imgs += 1
            return image
        if self._rng.uniform(0, 1) > 0.5:
            idx = int(self._rng.integers(self.pool_size))
            tmp = self.images[idx]
            self.images[idx] = image
            return tmp
        return image
