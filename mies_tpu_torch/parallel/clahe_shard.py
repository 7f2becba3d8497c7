"""Row-sharded CLAHE: tile-aligned bands and one LUT all_gather.

The port of ``mies_tpu.parallel.clahe_shard``. CLAHE depends on whole
tiles, not on a fixed radius, so it cannot take the halo path; it shards
on tile boundaries instead: each rank builds the LUTs of only its own
band's tiles (opencv: K1 to the LUTs; fraction: K1 and the plain LUT
build; tiles never straddle ranks), all-gathers the
[gy/n, gx, 256] f32 LUTs of every band (the one collective, independent
of the image size), and blends its own rows against the full grid at its
global row offset (K5). The result equals the unsharded ``clahe`` bit for
bit: the same histograms, LUTs and OpenCV weights, only computed
elsewhere.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.parallel.mesh import mesh_device
from mies_tpu_torch.pipeline.compiler import _ingest, _quantize_u8, _to_device

SHARDABLE = ("opencv", "fraction")


def check_convention(convention: str) -> None:
    if convention not in SHARDABLE:
        raise ValueError(
            f"convention {convention!r} does not spatially shard (skimage "
            "regions straddle band boundaries; kornia's even-ceil tiles + "
            "half-tile interp grid don't align with the band contract); "
            "use opencv or fraction"
        )


def check_grid_rows(grid_size, n: int) -> None:
    if grid_size[0] % n:
        raise ValueError(f"grid rows {grid_size[0]} not divisible by axis size {n}")


def clahe_band(
    band: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size: tuple[int, int] = (8, 8),
    convention: str = "opencv",
    group=None,
) -> torch.Tensor:
    """CLAHE of this rank's row band [B, hb, W] float32 in [0, 1] of slices
    row-sharded over ``group`` (default: the whole world), band i on group
    rank i. gy must divide by the group size, the band rows by the local
    tile rows and the width by gx. Returns float32 [0, 1] (the caller
    quantizes)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    gy, gx = grid_size
    check_grid_rows(grid_size, n)
    _, hb, w = band.shape
    gy_local = gy // n
    if hb % gy_local or w % gx:
        raise ValueError(
            f"band {tuple(band.shape[-2:])} not tile-aligned for grid {tuple(grid_size)}"
        )
    check_convention(convention)
    th, tw = hb // gy_local, w // gx
    band = band.contiguous()

    luts_local = KC.tile_luts(band, (gy_local, gx), clip_limit, convention)
    # the one collective: every band's LUTs, so each rank holds the grid
    parts = [torch.empty_like(luts_local) for _ in range(n)]
    dist.all_gather(parts, luts_local, group=group)
    luts = torch.cat(parts, dim=1)
    return KC.clahe_apply_lut_band(band, luts, (gy, gx), (th, tw), idx * hb,
                                   KC.EPILOGUE[convention])


def clahe_spatial_shard(
    mesh: DeviceMesh,
    clip_limit: float = 2.0,
    grid_size: tuple[int, int] = (8, 8),
    convention: str = "opencv",
    quantize: bool = True,
    dim: str = "space",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """CLAHE of ONE [H, W] slice row-sharded over the mesh's ``dim``: the
    returned fn takes this rank's band, rows [i * H/n, (i + 1) * H/n) for
    i = ``mesh.get_local_rank(dim)``, and returns its rows of the result
    (uint8 when ``quantize``). gy must divide by n, H by gy and W by gx
    (tile-aligned bands, no pad). Equals the unsharded ``clahe`` bit for
    bit."""
    group = mesh.get_group(dim)
    check_grid_rows(grid_size, dist.get_world_size(group))
    check_convention(convention)
    dev = mesh_device(mesh)

    def fn(band: torch.Tensor) -> torch.Tensor:
        x = _ingest(_to_device(band, dev))
        out = clahe_band(x[None], clip_limit, grid_size, convention, group)[0]
        return _quantize_u8(out) if quantize else out

    return fn
