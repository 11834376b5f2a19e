"""CycleGAN-style image replay buffer, copied from ``fdgan_tpu/train/pool.py``
(the reference's ``misc.ImagePool``, misc.py:140-161): until the pool is
full a query stores and returns the incoming batch; then, with p = 0.5, it
swaps the batch for a random stored one.

Two implementations, as in the JAX package:

- :class:`ImagePool`, on the host. The draws come from a numpy generator,
  so a seed gives the JAX package's sequence.
- :func:`device_pool_init` / :func:`device_pool_query`, for the
  device-resident loop (``train/loop.py::make_device_pool_loop``,
  ``cli/train --deviceSteps``), where the host never waits on the fakes: a
  ``(pool_size, b, H, W, C)`` buffer and a fill count on the device, the
  query's draws taken on the device from a ``torch.Generator``, and no value
  read on the host. :func:`pool_update` is the query given its draws as
  tensors (JAX's ``device_pool_query`` after its ``jax.random`` calls), so
  that a test can feed it JAX's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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


def device_pool_init(pool_size: int, batch_shape, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device pool's state: a zeroed ``(pool_size, *batch_shape)``
    buffer and the fill count, a 0-d int64 tensor, on ``device``."""
    buf = torch.zeros((pool_size,) + tuple(batch_shape), dtype=dtype, device=device)
    return buf, torch.zeros((), dtype=torch.int64, device=device)


def pool_update(buf: torch.Tensor, n_filled: torch.Tensor, image: torch.Tensor, swap: torch.Tensor,
                rand_slot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ImagePool.query`` (misc.py:146-161) on the device, given its draws:
    ``swap`` (0-d bool, uniform > 0.5) and ``rand_slot`` (0-d int, uniform
    in [0, pool_size)). In the fill phase (n_filled < pool_size) ``image``
    is stored at slot n_filled and returned; once full, with ``swap`` it is
    stored at ``rand_slot`` and the slot's old content is returned, else it
    passes through and the buffer is left as it was. The slot is read
    before it is written. ``buf`` is updated in place; returns (buf,
    n_filled', out), n_filled saturating at the pool size. No host sync.
    ``image`` must carry no gradient (D's step must not reach G through the
    pool)."""
    pool_size = buf.shape[0]
    not_full = n_filled < pool_size
    slot = torch.where(not_full, n_filled, rand_slot.to(n_filled.dtype)).reshape(1)
    old = buf.index_select(0, slot)[0]  # a copy: the read before the write
    stored = torch.where(not_full | swap, image.to(buf.dtype), old)
    buf.index_copy_(0, slot, stored.unsqueeze(0))
    out = torch.where(~not_full & swap, old.to(image.dtype), image)
    return buf, torch.clamp(n_filled + not_full.to(n_filled.dtype), max=pool_size), out


def device_pool_query(buf: torch.Tensor, n_filled: torch.Tensor, image: torch.Tensor,
                      generator: Optional[torch.Generator] = None):
    """:func:`pool_update` with its two draws taken from ``generator`` (a
    ``torch.Generator`` on the buffer's device) on the device, as JAX's
    ``device_pool_query`` draws them from its key every query, the fill
    phase included."""
    swap = torch.rand((), generator=generator, device=buf.device) > 0.5
    rand_slot = torch.randint(buf.shape[0], (), generator=generator, device=buf.device)
    return pool_update(buf, n_filled, image, swap, rand_slot)
