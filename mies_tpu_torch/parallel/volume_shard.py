"""Z-sharded volume chains: one [Z, H, W] volume split into z slabs.

The port of ``mies_tpu.parallel.volume_shard``, the 3-D sibling of
``parallel.halo.spatial_shard_apply``: a CT or MRI volume is cut into z
slabs over the mesh's 'space' dimension, one slab per rank, and the WHOLE
volume chain runs on every rank's slab, equal bit for bit to the unsharded
``compile_volume_pipeline``:

- A 3-D stencil stage extends its slab with the neighbours' real slices
  (``parallel.halo``'s exchange: a contiguous [z, H, W] slab viewed as
  [z, H * W] has its slices as rows), runs the whole-volume op, and crops;
  at the global z edges the op's own border gives the slices. SRAD and
  Perona-Malik exchange once a step, morphology once a level (+-inf slices
  for the 'ignore' border), the guided filter once a box mean.
- ``clahe3d`` shards on z TILE boundaries: each rank counts only its own
  tiles (K1), builds their LUTs, all-gathers the [gz, gy, gx, 256] LUT grid
  (the one collective, independent of the volume's size) and blends its
  slab at its global z offset (K8z).
- ``normalize`` and ``rescale_intensity`` take the min and max by
  all_reduce; ``equalize_hist`` all-reduces its int64 counts and reuses the
  unsharded interpolation.
- ``resample3d`` changes the shape: each rank computes its own output
  slices from its input slab and a halo of the slices their two taps read.
- Pointwise stages run locally.

A rank sends per step two halo slabs per stencil stage, the LUT grid per
clahe3d, and two scalars or 256 counts per global statistic; only the
halos scale with the volume (halo * H * W voxels).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.kernels import clahe3d as K3D
from mies_tpu_torch.ops import filters as F
from mies_tpu_torch.ops import histogram as H
from mies_tpu_torch.ops import intensity as I
from mies_tpu_torch.ops import restoration as R
from mies_tpu_torch.ops import volume3d as V
from mies_tpu_torch.parallel.halo import halo_extend_rows_multi
from mies_tpu_torch.parallel.mesh import mesh_device
from mies_tpu_torch.pipeline.compiler import (
    _quantize_u8,
    _to_device,
    _volume_registry,
)
from mies_tpu_torch.pipeline.config import PipelineConfig, validate

NBINS = H.NBINS
_REDUCE_OP = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
              "sum": dist.ReduceOp.SUM}
# ops run as extend -> the whole-volume op -> crop, and their default
# border (the slices past the global z edges)
_STENCIL_MODE = {
    "gaussian_blur3d": "nearest", "median_blur3d": "nearest",
    "unsharp_mask3d": "nearest", "difference_of_gaussians3d": "nearest",
    # nl-means has no mode param: it pads numpy 'reflect' (scipy 'mirror')
    "denoise_nl_means3d": "mirror",
    "frangi3d": "reflect", "vessel_enhance3d": "reflect",
    "sato3d": "reflect", "hessian3d": "reflect",
}
_MORPH3D = frozenset({"erode3d", "dilate3d", "morph_open3d", "morph_close3d",
                      "morph_gradient3d", "top_hat3d", "black_hat3d"})


def _zhalo_multi(x: torch.Tensor, halo: int, group, modes) -> tuple:
    """One z exchange, one extended slab [z + 2 halo, H, W] per border
    mode: the 2-D row exchange on the slab viewed as [z, H * W]."""
    z, h, w = x.shape
    ext = halo_extend_rows_multi(x.reshape(z, h * w), halo, group, modes)
    return tuple(e.reshape(-1, h, w) for e in ext)


def _zhalo(x: torch.Tensor, halo: int, group, mode) -> torch.Tensor:
    return _zhalo_multi(x, halo, group, (mode,))[0]


def _combine(group) -> Callable:
    """``combine`` for the statistics-taking ops: the whole volume's min,
    max or counts from every slab's, by all_reduce over ``group``."""
    def combine(t: torch.Tensor, op: str) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=_REDUCE_OP[op], group=group)
        return t
    return combine


# ---------------------------------------------------------------------------
# clahe3d on a z slab
# ---------------------------------------------------------------------------


def _check_clahe3d(grid_size, convention: str, n: int) -> None:
    if grid_size[0] % n:
        raise ValueError(f"grid z {grid_size[0]} not divisible by axis size {n}")
    if convention not in ("opencv", "fraction"):
        raise ValueError(
            f"convention {convention!r} does not z-shard (skimage regions "
            "straddle slab boundaries); use opencv or fraction"
        )


def clahe3d_band(
    band: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size: tuple[int, int, int] = (4, 8, 8),
    convention: str = "opencv",
    group=None,
) -> torch.Tensor:
    """clahe3d on this rank's z slab [zb, H, W] (float [0, 1]) of a volume
    z-sharded over ``group`` (default: the whole world), slab i on group
    rank i. gz must divide by the group size, the slab by the local z
    tiles, H and W by gy and gx. The local tiles' counts by K1 summed over
    each z tile, their LUTs by ``ops.volume3d.luts_3d``, ONE all_gather of
    the LUTs, then K8z at the slab's global z: equal to the unsharded
    ``clahe3d`` bit for bit. Returns float32 [0, 1]."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    gz, gy, gx = grid_size = tuple(int(g) for g in grid_size)
    _check_clahe3d(grid_size, convention, n)
    zb, h, w = band.shape
    gz_local = gz // n
    if zb % gz_local or h % gy or w % gx:
        raise ValueError(
            f"slab {tuple(band.shape)} not tile-aligned for grid {grid_size}"
        )
    tz, th, tw = zb // gz_local, h // gy, w // gx
    band = band.to(torch.float32).contiguous()

    hists = KC.tile_hists(band, (gy, gx))  # [zb, gy, gx, 256] int32
    hists = hists.reshape(gz_local, tz, gy * gx, NBINS).sum(1, dtype=torch.int32)
    luts_local = V.luts_3d(hists.to(torch.float32), clip_limit, tz * th * tw,
                           convention).reshape(gz_local, gy, gx, NBINS)
    # the one collective: every slab's LUTs, so each rank holds the grid
    luts = luts_local.new_empty((gz, gy, gx, NBINS))
    dist.all_gather_into_tensor(luts, luts_local.contiguous(), group=group)
    finalize = "u8norm" if convention == "opencv" else "clip01"
    return K3D.clahe3d_apply_lut_band(band, luts, grid_size, zb * n, idx * zb,
                                      finalize)


# ---------------------------------------------------------------------------
# per-stage z sharding rules
# ---------------------------------------------------------------------------


def volume_stage_z_field(op: str, params: dict) -> int:
    """z-slice radius a volume stage reads beyond its output voxel."""
    if op in ("gaussian_blur3d", "unsharp_mask3d"):
        sigma = params.get("sigma", params.get("radius", 1.0))
        truncate = params.get("truncate", 4.0)
        return int(truncate * float(sigma) + 0.5)
    if op == "median_blur3d":
        return params.get("kernel_size", 3) // 2
    if op == "guided_blur3d":
        return 2 * (params.get("kernel_size", 3) // 2)
    if op == "denoise_nl_means3d":
        # single-pass patch stencil: search radius + patch radius
        s = params.get("patch_size", 5)
        s = s if s % 2 == 1 else s + 1
        return params.get("patch_distance", 5) + s // 2
    if op == "srad3d":
        # 2 slabs/iteration (the c ring reads the 2-neighborhood)
        return 2 * int(params.get("niter", 15))
    if op == "anisotropic_diffusion3d":
        # 1 slab/iteration; the slab form refreshes the halo each iteration
        return int(params.get("niter", 10))
    if op == "denoise_tv3d":
        raise ValueError(
            "denoise_tv3d is not z-shardable: its convergence test sums "
            "energy over the WHOLE volume (global extent)"
        )
    if op == "denoise_wavelet3d":
        raise ValueError(
            "denoise_wavelet3d is not z-shardable: the multilevel DWT's "
            "subband thresholds are WHOLE-volume statistics and the "
            "decimated grids don't tile along z (global extent)"
        )
    if op == "meijering3d":
        raise ValueError(
            "meijering3d is not z-shardable: each scale's response is "
            "normalized by its VOLUME-WIDE max (global extent)"
        )
    if op in ("butterworth3d", "homomorphic3d", "wiener3d"):
        raise ValueError(
            f"op {op!r} is not z-shardable: the 3-D FFT reads every "
            "voxel for every output (global extent)"
        )
    if op == "difference_of_gaussians3d":
        low = params.get("low_sigma", 1.0)
        high = params.get("high_sigma")
        if high is None:
            high = 1.6 * float(low)
        return int(params.get("truncate", 4.0) * float(high) + 0.5)
    if op in ("frangi3d", "vessel_enhance3d", "sato3d", "hessian3d"):
        if op == "hessian3d":
            params = {**params, "gamma": params.get("gamma", 15.0)}
        if op != "sato3d" and params.get("gamma") is None:
            raise ValueError(
                f"op {op!r} with gamma=None normalizes by the per-scale "
                "GLOBAL max Frobenius norm and is not z-shardable; pass "
                "an explicit gamma"
            )
        return max(
            int(4.0 * float(s) + 0.5)
            for s in params.get("sigmas", (1.0, 2.0, 4.0))
        )
    if op in ("erode3d", "dilate3d", "morph_gradient3d"):
        return params.get("kernel_size", 3) // 2
    if op in ("morph_open3d", "morph_close3d", "top_hat3d", "black_hat3d"):
        # two morphology levels (erode then dilate or vice versa)
        return 2 * (params.get("kernel_size", 3) // 2)
    local = {
        # pointwise, or global-stat ops the slab fn handles explicitly
        "window_hu", "adjust_gamma", "adjust_log", "adjust_sigmoid",
        "invert", "normalize_meanstd", "denormalize_meanstd",
        "clahe3d", "normalize", "rescale_intensity", "equalize_hist",
        # shape-changing: its halo comes from the resize's taps and the
        # rank count (_resample_band_geometry), not from a radius
        "resample3d",
    }
    if op not in local:
        raise ValueError(f"op {op!r} is not z-shardable")
    return 0


# ---------------------------------------------------------------------------
# resample3d on a z slab
# ---------------------------------------------------------------------------


def _resample_band_geometry(z: int, depth: int, n: int
                            ) -> tuple[list[tuple[int, int]], int]:
    """Per-rank output slices of a z-sharded resample of z to ``depth``
    slices over n ranks: ([(first output slice, input slice of its
    extended slab's row 0)] per rank, halo). Rank k computes output slices
    [k * depth/n, (k + 1) * depth/n); each reads two adjacent input slices
    (``ops.volume3d._resize_taps``), all within its input slab
    [k * z/n, (k + 1) * z/n) extended by ``halo`` slices, the worst
    overhang of any rank, exchanged once. The taps never read the global
    edges' fill slices."""
    if depth % n or z % n:
        raise ValueError(
            f"z-sharded resample3d needs input z ({z}) and output depth "
            f"({depth}) divisible by the axis size ({n}); pick a target "
            f"depth that is a multiple of {n} (or run without "
            f"--data-parallel)"
        )
    lo, hi, _, _ = (t.numpy() for t in V._resize_taps(z, depth, torch.device("cpu")))
    dl, zl = depth // n, z // n
    halo = 0
    for k in range(n):
        rows = slice(k * dl, (k + 1) * dl)
        halo = max(halo, int(k * zl - lo[rows].min()),
                   int(hi[rows].max() + 1 - (k + 1) * zl))
    if halo > zl:
        raise ValueError(
            f"z-sharded resample3d: the {z}->{depth} resize needs a "
            f"{halo}-slab halo but each device holds only {zl} slabs — "
            f"use fewer devices or resample unsharded first"
        )
    return [(k * dl, k * zl - halo) for k in range(n)], halo


def resample3d_zband(x: torch.Tensor, depth: int, height: int, width: int,
                     group=None) -> torch.Tensor:
    """z-sharded ``ops.volume3d.resample3d``: this rank's [z/n, H, W] slab
    -> its [depth/n, height, width] slab of the output. The z pass
    extends the slab by the halo its taps read (one exchange) and lerps
    this rank's output slices from it; the h and w passes are per slice.
    Each output voxel is the unsharded op's two-tap lerp of the same
    inputs, so the result equals it bit for bit."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    zl, h, w = x.shape
    z = zl * n
    x = x.to(torch.float32)
    # axis order as the unsharded op (z, then h, then w)
    if z != depth:
        starts, halo = _resample_band_geometry(z, int(depth), n)
        first, offset = starts[idx]
        ext = _zhalo(x.contiguous(), halo, group, "nearest")
        taps = V._resize_taps(z, int(depth), x.device)
        x = V._lerp_rows(ext, 0, taps, slice(first, first + int(depth) // n),
                         offset)
    for axis, n_out in ((1, int(height)), (2, int(width))):
        if x.shape[axis] != n_out:
            x = V._lerp_rows(x, axis, V._resize_taps(x.shape[axis], n_out,
                                                     x.device))
    return x


# ---------------------------------------------------------------------------
# the slab function
# ---------------------------------------------------------------------------


def _stencil(fn: Callable, r: int, mode, group) -> Callable:
    """extend by r slices -> fn -> crop r slices."""
    if r == 0:
        return fn
    return lambda x: fn(_zhalo(x.contiguous(), r, group, mode))[r:-r]


def _srad_slab(p: dict, group) -> Callable:
    niter = int(p.get("niter", 15))
    args = (float(p.get("dt", 0.15)), float(p.get("q0", 1.0)),
            float(p.get("rho", 0.2)), float(p.get("eps", 1e-6)))
    R.check_srad_args(niter, *args[:3])

    def run(x):
        # a 2-slice halo refreshed every iteration
        x = x.to(torch.float32)
        for t in range(niter):
            ext = _zhalo(x.contiguous(), 2, group, "edge")
            x = R.srad3d_iteration(ext, t, *args)[2:-2]
        return x
    return run


def _pm_slab(p: dict, group) -> Callable:
    niter = int(p.get("niter", 10))
    step = R.pm3d_step(niter, p.get("kappa", 50.0), p.get("gamma", 0.1),
                       p.get("option", 1), p.get("voxelspacing"))

    def run(x):
        # edge-replicated slices zero the z boundary fluxes, as the
        # unsharded op's own border does; a 1-slice halo every iteration
        x = x.to(torch.float32)
        for _ in range(niter):
            x = step(_zhalo(x.contiguous(), 1, group, "edge"))[1:-1]
        return x
    return run


def _morph_slab(op: str, p: dict, group) -> Callable:
    """3-D morphology: each erode or dilate level extended by its own
    border ('ignore': slices of the constant the reduction never picks,
    +inf for a min, -inf for a max); min and max are exact, so the slab
    equals the unsharded op bit for bit."""
    k = p.get("kernel_size", 3)
    mode = p.get("mode", "ignore")
    r = k // 2

    def border(maximum):
        if mode != "ignore":
            return mode
        return float(np.float32("-inf" if maximum else "inf"))

    def prim(v, maximum):
        if r == 0:
            return v.to(torch.float32)
        ext = _zhalo(v.contiguous(), r, group, border(maximum))
        return V._extremum3d(ext, k, mode, maximum)[r:-r]

    def gradient(x):
        if r == 0:
            return torch.zeros_like(x, dtype=torch.float32)
        # one exchange, both borders
        ed, ee = _zhalo_multi(x.contiguous(), r, group,
                              (border(True), border(False)))
        return (V._extremum3d(ed, k, mode, True)[r:-r]
                - V._extremum3d(ee, k, mode, False)[r:-r])

    return {
        "erode3d": lambda x: prim(x, False),
        "dilate3d": lambda x: prim(x, True),
        "morph_open3d": lambda x: prim(prim(x, False), True),
        "morph_close3d": lambda x: prim(prim(x, True), False),
        "morph_gradient3d": gradient,
        "top_hat3d": lambda x: x.to(torch.float32) - prim(prim(x, False), True),
        "black_hat3d": lambda x: prim(prim(x, True), False) - x.to(torch.float32),
    }[op]


def _guided_slab(p: dict, group) -> Callable:
    """guided_blur3d: each box mean halo-wraps on its own (the second
    level boxes a and b, whose slices past the global edge are the border
    mode's slices of a and b, not a and b of the border's slices)."""
    k, eps = int(p.get("kernel_size", 3)), float(p.get("eps", 1e-2))
    mode = p.get("mode", "reflect")
    if k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    taps = np.full((k,), 1.0 / k, np.float32)
    box = _stencil(lambda v: v if k == 1 else V._pass3d(v, taps, mode),
                   k // 2, mode, group)
    return lambda x: F.guided_dataflow(lambda u, v: (box(u), box(v)),
                                       x.to(torch.float32), eps)


def _slab_stage(op: str, params: dict, group) -> Callable:
    reg = _volume_registry()
    p = dict(params)
    if op == "resample3d":
        return lambda x: resample3d_zband(x, p["depth"], p["height"],
                                          p["width"], group)
    if op == "clahe3d":
        p.pop("kernel_size", None)  # skimage-only, refused below
        _check_clahe3d(tuple(p.get("grid_size", (4, 8, 8))),
                       p.get("convention", "opencv"),
                       dist.get_world_size(group))
        return lambda x: clahe3d_band(x, group=group, **p)
    if op in _STENCIL_MODE:
        mode = p.get("mode", _STENCIL_MODE[op])
        return _stencil(functools.partial(reg[op], **p),
                        volume_stage_z_field(op, p), mode, group)
    if op == "srad3d":
        return _srad_slab(p, group)
    if op == "anisotropic_diffusion3d":
        return _pm_slab(p, group)
    if op in _MORPH3D:
        return _morph_slab(op, p, group)
    if op == "guided_blur3d":
        return _guided_slab(p, group)
    combine = _combine(group)
    if op == "normalize":
        return lambda x: I._normalize_minmax(x, p.get("eps", 1e-12), 3, combine)
    if op == "rescale_intensity":
        return lambda x: I._rescale_intensity(
            x, p.get("in_range"), p.get("out_range", (0.0, 1.0)), 3, combine)
    if op == "equalize_hist":
        return lambda x: H._equalize_hist(x, p.get("nbins", NBINS), 3, combine)
    return functools.partial(reg[op], **p)  # pointwise


def _build_zslab_fn(cfg: PipelineConfig, quantize: bool, group) -> Callable:
    """The per-rank slab function [Z/n, H, W] -> [Z'/n, H', W'] of a volume
    chain z-sharded over ``group``: every stage in its slab form (the
    module's docstring), then the uint8 quantize. Exact by induction:
    every stage sees the voxels the unsharded chain gives it."""
    validate(cfg)
    reg = _volume_registry()
    for s in cfg.stages:
        if s.op not in reg:
            raise ValueError(
                f"op {s.op!r} is not volume-capable; available: {sorted(reg)}"
            )
        volume_stage_z_field(s.op, s.kwargs())  # reject non-shardable early
    stages = [_slab_stage(s.op, s.kwargs(), group) for s in cfg.stages]

    def slab_fn(slab: torch.Tensor) -> torch.Tensor:
        x = slab
        for fn in stages:
            x = fn(x)
        return (_quantize_u8(x) if quantize else x).contiguous()

    return slab_fn


def volume_shard_apply(
    cfg: PipelineConfig,
    mesh: DeviceMesh,
    quantize: bool = True,
    dim: str = "space",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The volume chain on ONE [Z, H, W] volume z-sharded over the mesh's
    ``dim``: the returned fn takes this rank's slab [Z/n, H, W] (slices
    i * Z/n onwards, i = ``mesh.get_local_rank(dim)``; a tensor or numpy
    array, moved to the rank's device) and returns its slices of the
    chain's output. Z must divide by n (clahe3d: gz by n and Z by gz).
    Equals ``compile_volume_pipeline(cfg, quantize)`` on the whole volume
    bit for bit (ct_volume_3d on the card: K1, the LUT all_gather and K8z
    on every rank)."""
    slab_fn = _build_zslab_fn(cfg, quantize, mesh.get_group(dim))
    dev = mesh_device(mesh)
    return lambda slab: slab_fn(_to_device(slab, dev))
