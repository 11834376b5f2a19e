"""Halo-tiled inference (``tiling``), as in ``fdgan_tpu/dist``, and
multi-process data parallelism: ``mesh`` (the process group from
``FDGAN_TPU_DIST``, the state's broadcast, the batch's shard, the averages
over ranks) and ``stats`` (batch statistics global across the ranks).
Spatial sharding is not ported yet (ROADMAP.md, Queue 1 item 11)."""

from fdgan_tpu_torch.dist.tiling import tiled_apply

__all__ = ["tiled_apply"]
