"""Multi-device scaling on torch.distributed: meshes, batch sharding, halo
exchange, row-sharded CLAHE and z-sharded volume chains (the port of
``mies_tpu.parallel``).

* data parallelism: each rank runs the chain on its own shard of the batch
  (``shard_pipeline``), with the batch-mean quality metrics by one
  all_reduce (``sharded_evaluate``);
* spatial sharding: one oversized slice split into row bands across ranks,
  stencils made exact by exchanging halo rows with the neighbouring ranks,
  clahe on tile-aligned bands with one LUT all_gather
  (``spatial_shard_apply``, ``batch_spatial_shard_apply``,
  ``clahe_spatial_shard``);
* z sharding: one [Z, H, W] volume split into z slabs, the whole volume
  chain on every slab with z halos, clahe3d on tile-aligned slabs with
  one LUT all_gather (K8z), and the global statistics by all_reduce
  (``volume_shard_apply``, ``clahe3d_band``).

The callables take and return this rank's shard. They run the same on gloo
worlds on the CPU (the tests) and on NCCL over the cards.
"""

from mies_tpu_torch.parallel.clahe_shard import clahe_spatial_shard
from mies_tpu_torch.parallel.halo import (
    batch_spatial_shard_apply,
    halo_extend_rows,
    spatial_shard_apply,
)
from mies_tpu_torch.parallel.mesh import init_distributed, make_mesh, mesh_devices
from mies_tpu_torch.parallel.sharding import sharded_evaluate, shard_pipeline
from mies_tpu_torch.parallel.volume_shard import (
    clahe3d_band,
    volume_shard_apply,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "mesh_devices",
    "shard_pipeline",
    "sharded_evaluate",
    "halo_extend_rows",
    "spatial_shard_apply",
    "batch_spatial_shard_apply",
    "clahe_spatial_shard",
    "clahe3d_band",
    "volume_shard_apply",
]
