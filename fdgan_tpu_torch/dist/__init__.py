"""Halo-tiled inference (``tiling``), as in ``fdgan_tpu/dist``. Meshes and
spatial sharding are not ported yet (ROADMAP.md, Queue 1 items 10-11)."""

from fdgan_tpu_torch.dist.tiling import tiled_apply

__all__ = ["tiled_apply"]
