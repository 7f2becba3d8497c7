"""Data-parallel batch sharding of the enhancement chain.

The port of ``mies_tpu.parallel.sharding``: the batch axis is the one
meaningful parallel axis of a stateless slice pipeline, so each rank runs
the port's ``build_batched_chain`` on its own shard of the batch, with no
communication. The batch is split over ALL the mesh's dimensions: on a
('data', 'space') mesh used purely data-parallel, leaving 'space' out
would replicate the whole computation across it. ``sharded_evaluate``
adds the batch-mean quality metrics: each rank scores its own shard, and
one ``all_reduce`` of the per-rank sums gives the means over the whole
batch.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mies_tpu_torch.parallel.mesh import mesh_device
from mies_tpu_torch.pipeline.compiler import (
    _ingest,
    _quantize_u8,
    _to_device,
    build_batched_chain,
)
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


def _mesh_group(mesh: DeviceMesh):
    """The process group of all the mesh's ranks: the default group when
    the mesh spans the world (else a new group, which every rank of the
    world must build, as torch.distributed requires)."""
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == dist.get_world_size():
        return None
    return dist.new_group(ranks)


def sharded_evaluate(
    cfg: PipelineConfig,
    mesh: DeviceMesh,
    metric_names: tuple[str, ...] = ("psnr", "ssim"),
    max_val: float = 1.0,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, dict[str, float]]]:
    """Enhance this rank's shard of a batch AND reduce quality metrics over
    the whole batch.

    Returns fn(shard [b, H, W]) -> (uint8 shard, {name: batch mean}). The
    ground truth is the shard through the chain's own ingest (uint8 and
    uint16 to [0, 1]) and, for int16 HU input, the chain's ``window_hu``
    stage (without one the call raises: raw HU against [0, 1] outputs
    would be no comparison). Both sides are scaled by ``max_val`` and each
    image is scored; the means are one ``all_reduce`` of the per-rank sums
    and image counts (the reference's mean over the sharded axis)."""
    from mies_tpu_torch.eval.metrics import metric_values
    from mies_tpu_torch.ops.intensity import window_hu

    dev = mesh_device(mesh)
    # the float chain: K4's float epilogue ends it where the uint8 one
    # would, and the quantize follows the metrics
    chain = build_batched_chain(cfg, quantize=False, device=dev)
    wstage = next((s for s in cfg.stages if s.op == "window_hu"), None)
    names = tuple(metric_names)
    group = _mesh_group(mesh)

    def run(batch) -> tuple[torch.Tensor, dict[str, float]]:
        batch = _to_device(batch, dev)
        signed = batch.dtype in (torch.int8, torch.int16, torch.int32,
                                 torch.int64)
        if signed and wstage is None:
            raise ValueError(
                "sharded_evaluate: int16 HU input needs a window_hu "
                "stage in the config to define the metric baseline"
            )
        enhanced = chain(batch)
        gt = _ingest(batch)
        if signed:
            gt = window_hu(gt, **wstage.kwargs())
        per = metric_values(gt * max_val, enhanced * max_val, names,
                            float(max_val))
        sums = torch.stack([per[n].to(torch.float64).sum() for n in names]
                           + [torch.tensor(float(batch.shape[0]),
                                           dtype=torch.float64, device=dev)])
        dist.all_reduce(sums, group=group)
        means = (sums[:-1] / sums[-1]).tolist()
        return _quantize_u8(enhanced), dict(zip(names, means))

    return run
