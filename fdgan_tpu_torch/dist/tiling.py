"""Halo-tiled high-resolution inference (BASELINE config 3: NTIRE dense-haze,
≥1600 px inputs).

Counterpart of ``fdgan_tpu/dist/tiling.py``. The FDGAN encoder runs its
dense blocks at full resolution (no stride-2 stem — SURVEY.md §3.5), so
activations, not weights, bound memory at high resolution. `tiled_apply`
splits the image into overlap tiles whose halo covers the network's
receptive-field margin, runs the forward per tile, and stitches the
interior regions.

Tiled == untiled holds only approximately for FDGAN: the halo is below the
true receptive field, and BatchNorm in batch-stats mode normalises each tile
with its own statistics. ``tests/test_tiling_fdgan.py`` bounds the running-BN
difference of the JAX route.
"""

from __future__ import annotations

from typing import Callable

import torch

# Effective receptive-field margin of the FDGAN forward: three ÷2 stages of
# dense blocks with 3×3 convs (6+12+24 layers) upper-bounds the true RF, but
# in practice a 128 px halo captures everything that visibly influences an
# interior pixel.
DEFAULT_HALO = 128


def _tile_starts(size: int, tile: int, halo: int) -> list:
    """Interior-covering tile origins with `halo` overlap on each side."""
    inner = tile - 2 * halo
    if inner <= 0:
        raise ValueError("tile must exceed 2*halo")
    starts = list(range(0, max(size - tile, 0) + 1, inner))
    if starts[-1] + tile < size:
        starts.append(size - tile)
    return starts


def tiled_apply(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile: int = 512,
    halo: int = DEFAULT_HALO,
) -> torch.Tensor:
    """Apply `fn` (NHWC→NHWC, same spatial size) to the NHWC tensor `x` in
    overlap tiles; interiors are stitched, halos discarded.

    Images no larger than one tile go straight to `fn`. H and W must be
    divisible by 8 (FDGAN constraint); tile must be too. The output's
    channels and dtype are those of `fn`'s first tile.
    """
    b, h, w, _ = x.shape
    if h <= tile and w <= tile:
        return fn(x)

    ys = _tile_starts(h, min(tile, h), halo if h > tile else 0)
    xs = _tile_starts(w, min(tile, w), halo if w > tile else 0)
    th = min(tile, h)
    tw = min(tile, w)

    out = None
    for y0 in ys:
        for x0 in xs:
            res = fn(x[:, y0 : y0 + th, x0 : x0 + tw])
            if out is None:
                out = res.new_zeros((b, h, w, res.shape[-1]))
            # interior region of this tile (skip halo except at borders)
            iy0 = 0 if y0 == 0 else halo
            iy1 = th if y0 + th >= h else th - halo
            ix0 = 0 if x0 == 0 else halo
            ix1 = tw if x0 + tw >= w else tw - halo
            out[:, y0 + iy0 : y0 + iy1, x0 + ix0 : x0 + ix1] = res[:, iy0:iy1, ix0:ix1]
    return out
