"""Data-parallel batch sharding of the enhancement chain.

The port of ``mies_tpu.parallel.sharding``: the batch axis is the one
meaningful parallel axis of a stateless slice pipeline, so each rank runs
the port's ``build_batched_chain`` on its own shard of the batch, with no
communication. The batch is split over ALL the mesh's dimensions: on a
('data', 'space') mesh used purely data-parallel, leaving 'space' out
would replicate the whole computation across it. (The reference's
``sharded_evaluate`` waits for the port of ``eval/``.)
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from mies_tpu_torch.parallel.mesh import mesh_device
from mies_tpu_torch.pipeline.compiler import build_batched_chain
from mies_tpu_torch.pipeline.config import PipelineConfig


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's shard of a batch split over all the mesh's dimensions:
    its mesh coordinate, row-major."""
    idx = 0
    for d, name in enumerate(mesh.mesh_dim_names):
        idx = idx * mesh.mesh.shape[d] + mesh.get_local_rank(name)
    return idx


def shard_pipeline(
    cfg: PipelineConfig,
    mesh: DeviceMesh,
    quantize: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Compile cfg for this rank's shard of a [B, H, W] batch: the returned
    fn takes slices [k * B/N, (k + 1) * B/N), k = ``shard_index(mesh)``,
    N the mesh's size, and returns their outputs. The chain owns the
    quantize, so its tail peepholes (K4, or K13 under
    MIES_TPU_FUSE_TAIL=1) apply here as in ``compile_pipeline``."""
    return build_batched_chain(cfg, quantize=quantize, device=mesh_device(mesh))
