"""Halo-tiled inference (``tiling``), as in ``fdgan_tpu/dist``; multi-process
data parallelism and the serving mesh: ``mesh`` (the process group from
``FDGAN_TPU_DIST``, the state's broadcast, the batch's shard, the averages
over ranks, the ``("data", "spatial")`` mesh with its blocks and their
gather), ``stats`` (batch statistics global across the ranks) and
``halo_exchange`` (the exchanges of a spatially sharded forward, the halo'd
conv, the spatial context, and the collectives of the contextual term),
which serve both the serving mesh and training with H sharded."""

from fdgan_tpu_torch.dist.halo_exchange import conv2d_halo_sharded, exchange_halo, halo_sizes, spatial_sharding
from fdgan_tpu_torch.dist.tiling import tiled_apply

__all__ = ["conv2d_halo_sharded", "exchange_halo", "halo_sizes", "spatial_sharding", "tiled_apply"]
