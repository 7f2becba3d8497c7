"""Row-sharded chains with halo exchange.

The port of ``mies_tpu.parallel.halo`` for 2-D slices. An oversized slice
(a 4096 x 4096 mammogram) is split into row bands over the mesh's 'space'
dimension, one band per rank. A stencil stage stays exact when each band
is extended by the stage's radius of REAL neighbour rows before the stage
and cropped after: the rows move between neighbouring ranks with
``dist.batch_isend_irecv``, and at the global top and bottom edges the
stage's own border mode is reproduced locally. ``clahe`` runs its
tile-aligned band form (``clahe_shard.clahe_band``: K1, the LUT build, one
all_gather, K5). So the sharded chain equals the unsharded one bit for
bit. ``guided_blur`` halo-wraps each of its box means on its own: a box
of the extended band's a and b is not a box of a and b padded by the
border mode, so one extension for the whole op would change the edge rows.
Morphology extends every erode or dilate level by its own border (for the
'ignore' default, rows of the constant the reduction never picks: +inf
for a min, -inf for a max), and so does each pass of the rolling ball
(``subtract_background`` at downscale 1; above 1 its pyramid grids do not
tile along rows and it is refused). The geometry ops, ``histogram_match``,
``richardson_lucy`` and ``canny`` read the whole image and are refused
with the reason. ``sharpness`` runs (extend, run, crop), then passes the
slice's global first and last rows through unsmoothed on the edge ranks
(PIL's interior-only rule; the reference's band form).

The band function is batched ([B, h, W] on every rank): one function
serves ``spatial_shard_apply`` (one slice, B = 1) and
``batch_spatial_shard_apply`` (the batch split over 'data' as well).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mies_tpu_torch.kernels import diffusion as KD
from mies_tpu_torch.ops import filters as F
from mies_tpu_torch.ops import morphology as M
from mies_tpu_torch.ops import restoration as R
from mies_tpu_torch.parallel import clahe_shard as CS
from mies_tpu_torch.parallel.mesh import mesh_device
from mies_tpu_torch.pipeline.compiler import (
    OP_REGISTRY,
    VOLUME_ONLY_OPS,
    _bind_batched_stage,
    _check_ported,
    _ingest,
    _quantize_u8,
    _reject_volume_only,
    _to_device,
    _try_fuse_unsharp_quant,
)
from mies_tpu_torch.pipeline.config import PipelineConfig

# ops whose output pixel reads the whole image or its tile grid, and why
_GLOBAL_OPS = {
    "clahe": "tile histograms",
    "denoise_tv": "its convergence test sums the energy over the image",
    "musica": "decimated pyramid grids do not tile along rows",
    "equalize_hist": "a per-image histogram",
    "equalize": "a per-image histogram",
    "normalize": "the image's own range",
    "rescale_intensity": "the image's own range",
    "denoise_wavelet": "thresholds are whole-subband statistics, and the "
                       "decimated grids do not tile along rows",
    "meijering": "each scale is normalized by its image-wide max",
    "butterworth": "the FFT: every output pixel reads every input pixel",
    "homomorphic": "the FFT: every output pixel reads every input pixel",
    "wiener": "a circulant FFT deconvolution",
    "cycle_spin": "circular rolls wrap rows across the image",
    **{op: "a warped or resized pixel can read from anywhere" for op in (
        "resize", "center_crop", "flip", "rot90", "rotate", "affine_warp",
        "perspective_warp")},
    "histogram_match": "a per-image CDF",
    "richardson_lucy": "the zero-pad border applies to the intermediates "
                       "of every iteration",
    "canny": "hysteresis is global connectivity (and quantile thresholds "
             "are whole-image statistics)",
}
_POINTWISE = frozenset({
    "adjust_gamma", "adjust_log", "adjust_sigmoid", "invert", "window_hu",
    "normalize_meanstd", "denormalize_meanstd",
    "adjust_brightness", "adjust_contrast", "solarize", "posterize"})
_MORPH_OPS = frozenset({
    "erode", "dilate", "morph_open", "morph_close", "morph_gradient",
    "top_hat", "black_hat"})
# each stencil op's default border mode (mies_tpu_torch.ops defaults)
_DEFAULT_MODE = {
    "gaussian_blur": "nearest",
    "unsharp_mask": "nearest",
    "median_blur": "nearest",
    "box_blur": "reflect",
    "bilateral_blur": "reflect",
    "denoise_bilateral": "edge",
    "sobel_edges": "reflect",
    "scharr_edges": "reflect",
    "prewitt_edges": "reflect",
    "farid_edges": "reflect",
    "roberts_edges": "reflect",
    "laplace": "reflect",
    "laplacian_sharpen": "reflect",
    "difference_of_gaussians": "nearest",
    "gabor": "reflect",
    "gabor_bank": "reflect",
    "retinex": "nearest",
    "kuwahara": "reflect",
    "motion_blur": "constant",
    # nl-means has no mode param: it pads numpy 'reflect' == scipy 'mirror'
    "denoise_nl_means": "mirror",
    "lee_filter": "reflect",
    "frangi": "reflect",
    "vessel_enhance": "reflect",
    "sato": "reflect",
    "hessian": "reflect",
}


def _edge_rows(x: torch.Tensor, halo: int, mode) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``halo`` rows above and below x that the border ``mode`` gives
    (a float mode: rows of that constant value), gathered by the np.pad
    index of each row alone."""
    np_mode = None if isinstance(mode, float) else F._PAD_MODE[mode]
    if np_mode is None or np_mode == "constant":
        rows = torch.full((*x.shape[:-2], halo, x.shape[-1]),
                          0.0 if np_mode else mode, dtype=x.dtype, device=x.device)
        return rows, rows
    top, bot = _pad_rows(x.shape[-2], halo, np_mode, x.device)
    return x.index_select(-2, top), x.index_select(-2, bot)


@functools.lru_cache(maxsize=64)
def _pad_rows(n: int, halo: int, np_mode: str, device: torch.device):
    """The np.pad source rows of the ``halo`` rows above and below n rows,
    on ``device`` (kept: one host-to-device copy per shape, not per call)."""
    idx = torch.as_tensor(np.pad(np.arange(n), halo, mode=np_mode), device=device)
    return idx[:halo], idx[-halo:]


def _exchange(x: torch.Tensor, halo: int, group):
    """(rows from the band above, rows from the band below): each rank
    sends its top rows up and its bottom rows down, one batch of
    point-to-point operations; None at the global edges."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    group = group if group is not None else dist.group.WORLD
    ops, from_above, from_below = [], None, None
    if idx > 0:
        peer = dist.get_global_rank(group, idx - 1)
        from_above = x.new_empty((*x.shape[:-2], halo, x.shape[-1]))
        ops += [dist.P2POp(dist.irecv, from_above, peer, group),
                dist.P2POp(dist.isend, x[..., :halo, :].contiguous(), peer, group)]
    if idx < n - 1:
        peer = dist.get_global_rank(group, idx + 1)
        from_below = x.new_empty((*x.shape[:-2], halo, x.shape[-1]))
        ops += [dist.P2POp(dist.irecv, from_below, peer, group),
                dist.P2POp(dist.isend, x[..., -halo:, :].contiguous(), peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_above, from_below


def halo_extend_rows_multi(x: torch.Tensor, halo: int, group, modes) -> tuple:
    """One neighbour exchange, several border modes: one band per entry of
    ``modes``, each extended by ``halo`` rows on both sides of the row
    axis (-2) of x ([h, W] or [B, h, W]). Interior boundaries take the
    neighbours' real rows; the global edges take the mode's border rows.
    Raises if the halo is longer than the band (one hop only)."""
    n = dist.get_world_size(group)
    if halo <= 0:
        return tuple(x for _ in modes)
    if n > 1 and halo > x.shape[-2]:
        raise ValueError(
            f"halo {halo} exceeds the local band size {x.shape[-2]} "
            f"(single-hop neighbor exchange); use fewer devices along "
            f"the axis or larger bands"
        )
    from_above, from_below = _exchange(x, halo, group) if n > 1 else (None, None)
    out = []
    for mode in modes:
        pad_top, pad_bot = _edge_rows(x, halo, mode)
        top = pad_top if from_above is None else from_above
        bot = pad_bot if from_below is None else from_below
        out.append(torch.cat([top, x, bot], dim=-2))
    return tuple(out)


def halo_extend_rows(x: torch.Tensor, halo: int, group=None,
                     mode="nearest") -> torch.Tensor:
    """Extend a band by ``halo`` rows on each side of the row axis (-2):
    the neighbour bands' real rows inside the slice, the border ``mode``'s
    rows at its global top and bottom (on a group of one, both edges are
    global, so the per-stage crop keeps the shape)."""
    return halo_extend_rows_multi(x, halo, group, (mode,))[0]


def stage_receptive_field(op: str, params: dict) -> int:
    """Row radius a stage reads beyond its output pixel (0 = pointwise);
    raises for a stage that cannot shard by rows, naming the op."""
    if op not in OP_REGISTRY:
        raise ValueError(f"unknown op {op!r}; no receptive field for "
                         f"spatial sharding")
    if op == "learned_denoise":
        raise ValueError("learned_denoise receptive field is model-dependent")
    if op in ("gaussian_blur", "unsharp_mask"):
        sigma = params.get("sigma", params.get("radius", 1.0))
        truncate = params.get("truncate", 4.0)
        return int(truncate * float(sigma) + 0.5)
    if op in ("median_blur", "box_blur", "bilateral_blur"):
        return params.get("kernel_size", 5 if op == "bilateral_blur" else 3) // 2
    if op == "motion_blur":
        return params.get("kernel_size", 9) // 2
    if op == "denoise_bilateral":
        return F.denoise_bilateral_window(params.get("sigma_spatial", 1.0)) // 2
    if op in ("sobel_edges", "scharr_edges", "prewitt_edges",
              "roberts_edges", "laplace", "laplacian_sharpen"):
        # roberts reads only the forward (+1) diagonal; the symmetric
        # 1-row halo covers it
        return 1
    if op == "farid_edges":
        return 2  # the 5-tap Farid-Simoncelli pair
    if op == "difference_of_gaussians":
        low = params.get("low_sigma", 1.0)
        high = params.get("high_sigma")
        if high is None:
            high = 1.6 * float(low)
        return int(params.get("truncate", 4.0) * float(high) + 0.5)
    if op in ("gabor", "gabor_bank"):
        if op == "gabor":
            thetas = [float(params.get("theta", 0.0))]
        else:
            n = int(params.get("n_orientations", 8))
            thetas = [k * np.pi / n for k in range(n)]
        # the row radius of each rotated support
        return max(g.shape[0] // 2 for g in F._gabor_kernels(
            params.get("frequency", 0.1), thetas,
            params.get("bandwidth", 1.0), params.get("sigma_x"),
            params.get("sigma_y"), params.get("n_stds", 3),
            params.get("offset", 0.0)))
    if op == "kuwahara":
        return params.get("kernel_size", 5) // 2
    if op == "retinex":
        if params.get("rescale", "clip") == "minmax":
            raise ValueError(
                "retinex with rescale='minmax' stretches by the "
                "IMAGE-WIDE min/max (global extent); use "
                "rescale='clip' or batch sharding"
            )
        truncate = params.get("truncate", 4.0)
        return max(int(truncate * float(s) + 0.5)
                   for s in params.get("sigmas", (2.0, 8.0, 30.0)))
    if op == "subtract_background":
        if M._resolve_downscale(params.get("downscale", "auto"),
                                params.get("radius", 25.0)) > 1:
            raise ValueError(
                "subtract_background with an effective downscale > 1 "
                "(explicit, or 'auto' at radius > 10) runs on "
                "decimated pyramid grids which don't tile along rows; "
                "use downscale=1 or batch sharding"
            )
        # the non-flat ball opening: two levels of ceil(radius) each
        return 2 * int(np.ceil(params.get("radius", 25.0)))
    if op == "guided_blur":
        # two box-filter levels: image statistics, then the a/b means
        return 2 * (params.get("kernel_size", 3) // 2)
    if op == "sharpness":
        return 1
    if op == "denoise_nl_means":
        # single-pass patch stencil: search radius + patch radius
        s = params.get("patch_size", 7)
        s = s if s % 2 == 1 else s + 1
        return params.get("patch_distance", 11) + s // 2
    if op == "lee_filter":
        if params.get("sigma") is None:
            raise ValueError(
                "lee_filter with sigma=None estimates the noise from "
                "the IMAGE-WIDE mean local variance and cannot be "
                "spatially sharded; pass an explicit sigma"
            )
        return params.get("kernel_size", 5) // 2
    if op == "srad":
        # 2 px/iteration (the c ring reads the I 2-neighborhood); the
        # band form refreshes the halo each iteration
        return 2 * int(params.get("niter", 15))
    if op == "anisotropic_diffusion":
        # 1 px/iteration; the band form refreshes the halo each iteration,
        # so this is only the TOTAL extent diagnostic
        return int(params.get("niter", 10))
    if op in ("frangi", "vessel_enhance", "sato", "hessian"):
        if op == "hessian":
            # skimage's fixed gamma=15 default: no global statistic
            params = {**params, "gamma": params.get("gamma", 15.0)}
        if op != "sato" and params.get("gamma") is None:
            raise ValueError(
                f"op {op!r} with gamma=None normalizes by the per-scale "
                "GLOBAL max Frobenius norm and cannot be spatially "
                "sharded; pass an explicit gamma"
            )
        # per-scale Gaussian-derivative passes read int(4*sigma + 0.5)
        return max(
            int(4.0 * float(s) + 0.5)
            for s in params.get("sigmas", (1.0, 2.0, 4.0))
        )
    if op in ("erode", "dilate", "morph_gradient"):
        return params.get("kernel_size", 3) // 2
    if op in ("morph_open", "morph_close", "top_hat", "black_hat"):
        # two morphology levels (erode then dilate or vice versa)
        return 2 * (params.get("kernel_size", 3) // 2)
    if op in _GLOBAL_OPS:
        raise ValueError(
            f"op {op!r} has global/tile extent ({_GLOBAL_OPS[op]}) and "
            "cannot be spatially sharded with a fixed halo; use batch "
            "sharding for chains containing it (clahe has its own "
            "tile-aligned shard path)"
        )
    if op in VOLUME_ONLY_OPS or op not in _POINTWISE:
        raise ValueError(f"unknown op {op!r} for spatial sharding")
    return 0


def chain_receptive_field(cfg: PipelineConfig) -> int:
    """Total halo needed so the sharded chain is exact: sum of radii."""
    return sum(stage_receptive_field(s.op, s.kwargs()) for s in cfg.stages)


def _stencil(fn: Callable, r: int, mode, group) -> Callable:
    """extend by r rows -> fn -> crop r rows."""
    def run(x):
        ext = halo_extend_rows(x, r, group, mode)
        return fn(ext)[..., r:ext.shape[-2] - r, :]
    return run


def _srad_band(p: dict, group) -> Callable:
    niter = int(p.get("niter", 15))
    args = (float(p.get("dt", 0.15)), float(p.get("q0", 1.0)),
            float(p.get("rho", 0.2)), float(p.get("eps", 1e-6)))
    R.check_srad_args(niter, *args[:3])

    def run(x):
        # a 2-row halo refreshed every iteration: one K10 launch of the one
        # step t each (the whole-slice chain runs STEPS steps a launch)
        for t in range(niter):
            ext = halo_extend_rows(x.to(torch.float32), 2, group, "edge")
            x = KD.srad_step(ext, t, *args)[..., 2:-2, :]
        return x
    return run


def _pm_band(p: dict, group) -> Callable:
    niter, option = int(p.get("niter", 10)), int(p.get("option", 1))
    kappa, gamma = float(p.get("kappa", 50.0)), float(p.get("gamma", 0.1))
    R.check_pm_args(niter, option)

    def run(x):
        # edge-replicated pads zero the boundary fluxes, as the unsharded
        # op's own border does; a 1-row halo refreshed every iteration
        for _ in range(niter):
            ext = halo_extend_rows(x.to(torch.float32), 1, group, "edge")
            x = KD.anisotropic_diffusion_cuda(ext, 1, kappa, gamma, option)
            x = x[..., 1:-1, :]
        return x
    return run


def _guided_band(p: dict, group) -> Callable:
    """guided_blur on a band: each box mean halo-wraps on its own (the
    second level boxes a and b, whose rows past the global edge are the
    border mode's rows of a and b, not a and b of the border's rows), the
    two boxes of a level stacked into one exchange."""
    if p.get("guide") is not None:
        raise ValueError("guided_blur with a separate guide image has no "
                         "row-band form; shard the guide's chain by batch")
    k, eps = int(p.get("kernel_size", 3)), float(p.get("eps", 1e-2))
    mode = p.get("mode", "reflect")
    if k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    box = _stencil(lambda x: F.box_blur(x, k, mode), k // 2, mode, group)

    def box2(u, v):
        both = box(torch.stack([u, v]))
        return both[0], both[1]

    return lambda x: F.guided_dataflow(box2, x, eps)


def _morph_band(op: str, p: dict, group) -> Callable:
    """Morphology on a band: each erode or dilate level under (extend, run,
    crop), its border the op's mode or, for 'ignore', rows of the constant
    the reduction ignores (+inf for a min, -inf for a max: the unsharded
    op's own border). min and max are exact, so the band equals the
    unsharded op bit for bit."""
    k = int(p.get("kernel_size", 3))
    shape, mode = p.get("shape", "rect"), p.get("mode", "ignore")
    r = k // 2

    def border(maximum):
        if mode != "ignore":
            return mode
        return float(np.float32("-inf" if maximum else "inf"))

    def prim(v, maximum):
        if r == 0:
            return v
        ext = halo_extend_rows(v, r, group, border(maximum))
        return M._extremum(ext, k, shape, mode, maximum)[..., r:-r, :]

    def gradient(x):
        if r == 0:
            return torch.zeros_like(x)
        # one exchange, both borders
        ed, ee = halo_extend_rows_multi(x, r, group,
                                        (border(True), border(False)))
        return (M._extremum(ed, k, shape, mode, True)[..., r:-r, :]
                - M._extremum(ee, k, shape, mode, False)[..., r:-r, :])

    return {
        "erode": lambda x: prim(x, False),
        "dilate": lambda x: prim(x, True),
        "morph_open": lambda x: prim(prim(x, False), True),
        "morph_close": lambda x: prim(prim(x, True), False),
        "morph_gradient": gradient,
        "top_hat": lambda x: x - prim(prim(x, False), True),
        "black_hat": lambda x: prim(prim(x, True), False) - x,
    }[op]


def _background_band(p: dict, group) -> Callable:
    """subtract_background on a band, at an effective downscale of 1 (the
    receptive field refuses the pyramid's decimated grids): the ball's min
    pass under +inf rows, its max pass under -inf rows, each halo-wrapped
    on its own (the ignored constant of each reduction, as ``_morph_band``
    does). min and max are exact, so the band equals the unsharded op bit
    for bit."""
    stage_receptive_field("subtract_background", p)
    radius = float(p.get("radius", 25.0))
    intensity = p.get("intensity")
    table = M._ball_table(radius, radius / 255.0 if intensity is None
                          else float(intensity))
    rr = table.shape[0] // 2
    inf = float(np.float32("inf"))

    def opening(v):
        e = M._rb_pass(halo_extend_rows(v, rr, group, inf), table, False)
        return M._rb_pass(halo_extend_rows(e, rr, group, -inf), table, True)

    def run(x):
        x = x.to(torch.float32)
        if p.get("light_background", False):
            inv = 1.0 - x
            return 1.0 - torch.clamp(inv - opening(inv), 0.0, 1.0)
        return torch.clamp(x - opening(x), 0.0, 1.0)

    return run


def _sharpness_band(s, group) -> Callable:
    """sharpness on a band: (extend, run, crop), then PIL's interior-only
    rule at the slice's GLOBAL top and bottom rows: they pass through
    unsmoothed (the op's blend of a pixel with itself, clipped), on the
    edge ranks only. The halo made the band's own first and last rows
    interior, as they are inside the slice."""
    stencil = _stencil(_bind_batched_stage(s), 1, "nearest", group)
    factor = s.kwargs().get("factor", 1.0)

    def edge(row):
        row = row.to(torch.float32)
        return torch.clamp(row + factor * (row - row), 0.0, 1.0)

    def run(x):
        y = stencil(x)
        idx, n = dist.get_rank(group), dist.get_world_size(group)
        if idx == 0:
            y[..., 0, :] = edge(x[..., 0, :])
        if idx == n - 1:
            y[..., -1, :] = edge(x[..., -1, :])
        return y
    return run


def _band_stage(s, group) -> Callable:
    p = s.kwargs()
    if s.op == "sharpness":
        return _sharpness_band(s, group)
    if s.op == "clahe":
        CS.check_convention(p.get("convention", "opencv"))
        CS.check_grid_rows(tuple(p.get("grid_size", (8, 8))),
                           dist.get_world_size(group))
        # only 256 bins exist; kernel_size is skimage-only (rejected above)
        p.pop("nbins", None)
        p.pop("kernel_size", None)
        return lambda x: CS.clahe_band(x, group=group, **p)
    r = stage_receptive_field(s.op, p)
    if s.op == "srad":
        return _srad_band(p, group)
    if s.op == "anisotropic_diffusion":
        return _pm_band(p, group)
    if s.op == "guided_blur":
        return _guided_band(p, group)
    if s.op in _MORPH_OPS:
        return _morph_band(s.op, p, group)
    if s.op == "subtract_background":
        return _background_band(p, group)
    fn = _bind_batched_stage(s)
    if r == 0:
        return fn
    return _stencil(fn, r, p.get("mode", _DEFAULT_MODE[s.op]), group)


def _build_band_fn(cfg: PipelineConfig, quantize: bool, group) -> Callable:
    """The per-rank band function [B, h, W] -> [B, h, W] of a chain
    row-sharded over ``group``: stencil stages as (halo exchange of their
    own radius and border mode) -> the port's batched stage (K3, K11,
    plain Gaussian / Lee) -> crop; srad and anisotropic_diffusion with the
    halo refreshed every iteration (K10 / K9 per iteration); morphology
    with one exchange per erode or dilate level; pointwise stages
    directly; clahe as ``clahe_band``. A trailing unsharp_mask takes
    the quantize with it as in the unsharded chain (K4 on the extended
    band). Exact by induction: every stage sees the pixels the unsharded
    chain gives it."""
    _check_ported(cfg)
    _reject_volume_only(cfg)
    stages, tail = cfg.stages, None
    if quantize:
        stages, tail = _try_fuse_unsharp_quant(cfg, True)
    bound = [_band_stage(s, group) for s in stages]
    if tail is not None:
        last = cfg.stages[-1]
        r = stage_receptive_field(last.op, last.kwargs())
        bound.append(_stencil(tail, r, "nearest", group))

    def band_fn(band: torch.Tensor) -> torch.Tensor:
        x = _ingest(band)
        for fn in bound:
            x = fn(x)
        if tail is None and quantize:
            x = _quantize_u8(x)
        return x.contiguous()

    return band_fn


def spatial_shard_apply(
    cfg: PipelineConfig,
    mesh: DeviceMesh,
    quantize: bool = True,
    dim: str = "space",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The chain on ONE [H, W] slice row-sharded over the mesh's ``dim``:
    the returned fn takes this rank's band [H/n, W] (rows i * H/n onwards,
    i = ``mesh.get_local_rank(dim)``) and returns its rows of the chain's
    output. H must divide by n; a clahe stage also needs gy divisible by n
    and H, W by the grid. Equals ``compile_pipeline`` bit for bit (the
    flagship on a 4096^2 mammogram runs as K1, the LUT all_gather, K5, K3
    and K4 on every rank)."""
    band_fn = _build_band_fn(cfg, quantize, mesh.get_group(dim))
    dev = mesh_device(mesh)
    return lambda band: band_fn(_to_device(band, dev)[None])[0]


def batch_spatial_shard_apply(
    cfg: PipelineConfig,
    mesh: DeviceMesh,
    quantize: bool = True,
    data_dim: str = "data",
    space_dim: str = "space",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The chain on a batch [B, H, W] sharded over BOTH mesh dimensions:
    the batch over ``data_dim`` and every slice's rows over ``space_dim``.
    The returned fn takes this rank's block [B/d, H/s, W] (slices
    j * B/d onwards, rows i * H/s onwards, j and i this rank's coordinates
    ``mesh.get_local_rank(data_dim)`` and ``mesh.get_local_rank(space_dim)``)
    and returns its block of the output."""
    band_fn = _build_band_fn(cfg, quantize, mesh.get_group(space_dim))
    dev = mesh_device(mesh)
    return lambda block: band_fn(_to_device(block, dev))
