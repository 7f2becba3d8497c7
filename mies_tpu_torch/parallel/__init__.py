"""Multi-device scaling on torch.distributed: meshes, batch sharding, halo
exchange and row-sharded CLAHE (the port of ``mies_tpu.parallel`` for 2-D
slices; the z-sharded volume layer is not ported yet).

* data parallelism: each rank runs the chain on its own shard of the batch
  (``shard_pipeline``);
* spatial sharding: one oversized slice split into row bands across ranks,
  stencils made exact by exchanging halo rows with the neighbouring ranks,
  clahe on tile-aligned bands with one LUT all_gather
  (``spatial_shard_apply``, ``batch_spatial_shard_apply``,
  ``clahe_spatial_shard``).

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
from mies_tpu_torch.parallel.sharding import shard_pipeline

__all__ = [
    "init_distributed",
    "make_mesh",
    "mesh_devices",
    "shard_pipeline",
    "halo_extend_rows",
    "spatial_shard_apply",
    "batch_spatial_shard_apply",
    "clahe_spatial_shard",
]
