"""The one generator of the benchmark's inputs, read from a traffic mix's
parameters and the run's seed.

Everything here is a function of the seed: the same seed gives the same
images, batches, orders and arrival times. Images are made on the run's
device in one batch and copied to the host once. Every seed gets the same
sizes and the same set of inter-arrival gaps, in another order, so the
seed changes which work arrives when and never how much.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7_919 + salt) % 2**63)
    return gen


def rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, salt])


def hazy_scenes(seed: int, n: int, h: int, w: int, device, salt: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hazy, clear): ``n`` NHWC float images in [0, 1] on ``device``. A
    clear scene is smooth random colour fields (a 1/32-scale random image,
    bilinearly upsampled) with fine texture; its hazy view follows the
    scattering model I = J·t + A·(1 − t) with a per-image transmission t in
    [0.3, 0.9] and a greyish airlight A in [0.7, 1.0]."""
    gen = _generator(seed, salt, device)
    coarse = torch.rand((n, 3, h // 32 + 2, w // 32 + 2), generator=gen, device=device)
    clear = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    clear = (clear + 0.03 * torch.randn((n, 3, h, w), generator=gen, device=device)).clamp_(0.0, 1.0)
    t = 0.3 + 0.6 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    a = 0.7 + 0.3 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    a = (a + 0.05 * torch.rand((n, 3, 1, 1), generator=gen, device=device)).clamp_(max=1.0)
    hazy = clear * t + a * (1.0 - t)
    return hazy.permute(0, 2, 3, 1).contiguous(), clear.permute(0, 2, 3, 1).contiguous()


def images_uint8(seed: int, n: int, h: int, w: int, device) -> np.ndarray:
    """``n`` hazy HWC uint8 images, on the host: (n, h, w, 3)."""
    hazy, _ = hazy_scenes(seed, n, h, w, device)
    return torch.round(hazy * 255.0).to(torch.uint8).cpu().numpy()


def train_batches(seed: int, n: int, batch: int, size: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` training batches of (hazy, clear) float32 pairs in [0, 1], on
    the host, as a loader hands them out: each (n, batch, size, size, 3)."""
    hazy, clear = hazy_scenes(seed, n * batch, size, size, device, salt=2)
    shape = (n, batch, size, size, 3)
    return hazy.reshape(shape).cpu().numpy(), clear.reshape(shape).cpu().numpy()


def order(seed: int, count: int, pool: int) -> np.ndarray:
    """A stream of ``count`` indices into a pool of ``pool`` items: seeded
    permutations of the pool, one after another."""
    r = rng(seed, 3)
    reps = math.ceil(count / pool)
    return np.concatenate([r.permutation(pool) for _ in range(reps)])[:count]


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream at ``rate``
    per second over ``seconds``: round(rate·seconds) gaps at the midpoint
    quantiles of the exponential distribution, shuffled by the seed, and
    summed. Their mean is 1/rate and their total about ``seconds``."""
    n = max(1, round(rate * seconds))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    return np.cumsum(rng(seed, 4).permutation(gaps))
