"""CLAHE in its four conventions, plain PyTorch.

Same algorithms and f32 operation order as ``mies_tpu.ops.histogram.clahe``:

* ``opencv``: uint8 levels, integer tile histograms, OpenCV's exact clip +
  redistribution, rint'ed uint8 LUTs, the bilinear blend with f32
  reciprocal weights, and a final rint. Eager torch does not contract
  multiply-adds into FMAs, so on the CPU this is bit-exact against
  ``cv2.createCLAHE`` (tests/test_torch_ops.py).
* ``fraction``: the same tiling and blend on fractional LUTs (cdf /
  tile_area) after a one-pass float redistribution; output clipped to
  [0, 1].
* ``skimage``: ``skimage.exposure.equalize_adapthist`` (0.26): 14-bit
  gray with a per-image min-max stretch, numpy-'reflect' pad on both
  sides, half-kernel-offset regions, the iterative integer clip, floored
  maps, the ``arange(k) / k`` blend, floor, per-image stretch out.
* ``kornia``: ``kornia.enhance.equalize_clahe`` (0.8.2): even-ceil
  tiles, ``histc`` binning, float clip, floored 255/P LUTs and the
  half-tile ``linspace`` blend.

Functions take float32 ``[..., H, W]`` (any leading batch dims; min and
max of the skimage stretches are per image) and run on the tensor's own
device. They are also the plain versions of the CLAHE kernels: K1 (tile
histograms), K2 (LUT apply), K6a (skimage map build), K6 (skimage apply).
Wherever the reference divides by a constant, the port divides by a 0-d
tensor on the same device: CUDA torch turns ``/ python_scalar`` into a
multiply by the reciprocal.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

NBINS = 256
NR_OF_GRAY = 2**14  # skimage's internal 14-bit gray resolution
CONVENTIONS = ("opencv", "fraction", "skimage", "kornia")


def check_convention(convention: str, nbins: int = NBINS) -> None:
    """The reference's argument rules, in its order: nbins != 256 is
    skimage-only, nbins >= 2, and the convention must be known."""
    if nbins != NBINS and convention != "skimage":
        raise NotImplementedError(
            f"nbins={nbins}: only the skimage convention supports "
            f"nbins != 256 (cv2/kornia hard-code 256 bins)"
        )
    if nbins < 2:
        raise ValueError(f"nbins must be >= 2, got {nbins}")
    if convention not in CONVENTIONS:
        raise ValueError(f"unknown CLAHE convention: {convention!r}")


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """0-d float32 tensor on ``like``'s device, a divisor that stays a
    true division on CUDA."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _levels(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> int32 uint8 levels: clip(round(x * 255), 0, 255)
    (torch.round rounds half to even, like jnp.round and cvRound)."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int32)


def _u8norm(res: torch.Tensor) -> torch.Tensor:
    """OpenCV saturate + renormalize: clip(rint(res), 0, 255) / 255, by
    true division."""
    return torch.clamp(torch.round(res), 0, 255) / _const(res, 255.0)


def _pad_reflect(img: torch.Tensor, rows: tuple[int, int],
                 cols: tuple[int, int]) -> torch.Tensor:
    """Pad the last two dims as ``np.pad(..., mode='reflect')`` does (the
    edge not repeated), by index arithmetic: any pad length, where
    ``F.pad`` refuses pads longer than the dim."""
    for dim, pads in ((-2, rows), (-1, cols)):
        if any(pads):
            img = img.index_select(
                dim, _reflect_index(img.shape[dim], *pads, img.device))
    return img


@functools.lru_cache(maxsize=256)
def _reflect_index(n: int, before: int, after: int,
                   device: torch.device) -> torch.Tensor:
    """The np.pad 'reflect' source index of an axis of n, on ``device``
    (kept: one blocking host-to-device copy per shape, not one per call,
    and none inside a CUDA-graph capture)."""
    idx = np.pad(np.arange(n), (before, after), mode="reflect")
    return torch.as_tensor(idx, device=device)


def grid_pads(shape: tuple[int, int], grid: tuple[int, int],
              convention: str) -> tuple[int, int]:
    """Bottom and right pad lengths that make H, W multiples of the grid.

    opencv: ``cv2.createCLAHE``'s rule (``CLAHE_Impl::apply``): when either
    axis is ragged, BOTH are padded by ``g - n % g``, so an axis that
    divides evenly gains a full tile. fraction (no outside ground truth,
    so the JAX package's rule): each axis by ``(g - n % g) % g``."""
    (h, w), (gy, gx) = shape, grid
    if convention == "opencv":
        if h % gy == 0 and w % gx == 0:
            return 0, 0
        return gy - h % gy, gx - w % gx
    return (gy - h % gy) % gy, (gx - w % gx) % gx


def _pad_reflect101(
    img: torch.Tensor, grid: tuple[int, int], convention: str
) -> tuple[torch.Tensor, int, int]:
    """Pad H, W up to multiples of the tile grid by ``grid_pads``' rule
    with BORDER_REFLECT_101 on the bottom/right only, as OpenCV's
    ``copyMakeBorder`` does (numpy mode 'reflect', any number of bounces,
    as OpenCV's ``borderInterpolate``)."""
    ph, pw = grid_pads(img.shape[-2:], grid, convention)
    return _pad_reflect(img, (0, ph), (0, pw)), ph, pw


def _tile_histograms(levels: torch.Tensor, grid: tuple[int, int],
                     nbins: int = NBINS) -> torch.Tensor:
    """Per-tile ``nbins``-bin histograms of integer levels [..., H, W] (H, W
    divisible by the grid) -> [..., gy*gx, nbins] float32 counts."""
    gy, gx = grid
    *lead, h, w = levels.shape
    th, tw = h // gy, w // gx
    tiles = levels.reshape(*lead, gy, th, gx, tw).transpose(-3, -2)
    tiles = tiles.reshape(*lead, gy * gx, th * tw).to(torch.int64)
    hist = torch.zeros(*lead, gy * gx, nbins, dtype=torch.float32,
                       device=levels.device)
    return hist.scatter_add_(-1, tiles, torch.ones_like(tiles, dtype=torch.float32))


# ---------------------------------------------------------------------------
# opencv and fraction conventions
# ---------------------------------------------------------------------------


def _clip_redistribute_opencv(hist: torch.Tensor, clip_value: float) -> torch.Tensor:
    """OpenCV's exact integer clip + redistribution, vectorized per tile.

    hist: [..., 256] float32 integer-valued counts. OpenCV:
      1. excess = sum(max(h - clip, 0)); h = min(h, clip)
      2. h += excess // 256
      3. residual = excess % 256; step = max(256 // residual, 1);
         h[i] += 1 for i = 0, step, 2*step, ... while residual lasts
         (and i < 256 — leftover residual beyond that is dropped).
    """
    excess = torch.clamp(hist - clip_value, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip_value)
    batch_incr = torch.floor(excess / NBINS)
    residual = excess - batch_incr * NBINS
    hist = hist + batch_incr
    step = torch.clamp(
        torch.floor(hist.new_full((), float(NBINS))
                    / torch.clamp(residual, min=1.0)),
        min=1.0,
    )
    i = torch.arange(NBINS, dtype=torch.float32, device=hist.device)
    k = torch.floor(i / step)
    gets_one = (torch.remainder(i, step) == 0) & (k < residual)
    return hist + gets_one.to(torch.float32)


def _clip_redistribute_fraction(hist: torch.Tensor, clip_value: float
                                ) -> torch.Tensor:
    """Fraction-convention clip: the excess is spread equally over all
    bins in one float pass (bins may exceed the clip afterwards)."""
    excess = torch.clamp(hist - clip_value, min=0.0).sum(dim=-1, keepdim=True)
    return torch.clamp(hist, max=clip_value) + excess / NBINS


def _luts_opencv(
    hists: torch.Tensor, clip_limit: float, tile_area: int
) -> torch.Tensor:
    """[..., 256] tile histograms -> uint8-valued float32 LUTs: clip,
    redistribute, cumsum, scale by the f32 255 / tile_area, rint."""
    clip_value = float(max(int(clip_limit * tile_area / NBINS), 1))
    hists = _clip_redistribute_opencv(hists, clip_value)
    cdf = torch.cumsum(hists, dim=-1)
    lut_scale = float(np.float32(NBINS - 1) / np.float32(tile_area))
    return torch.clamp(torch.round(cdf * lut_scale), 0, 255)


def _luts_fraction(
    hists: torch.Tensor, clip_limit: float, tile_area: int
) -> torch.Tensor:
    """[..., 256] tile histograms -> fractional LUTs cdf / tile_area (a
    true division) after the one-pass float clip at the f32
    max(clip_limit * tile_area, 1)."""
    clip_value = float(np.float32(max(clip_limit * tile_area, 1.0)))
    cdf = torch.cumsum(_clip_redistribute_fraction(hists, clip_value), dim=-1)
    return cdf / _const(cdf, float(tile_area))


def _bilinear_lut_apply(
    u8: torch.Tensor,
    luts: torch.Tensor,
    grid: tuple[int, int],
    tile_shape: tuple[int, int] | None = None,
    y_offset: int = 0,
) -> torch.Tensor:
    """Bilinearly interpolate per pixel between the 4 neighbouring tile LUTs.

    u8:   [..., H, W] integer levels (the padded image, or any top-left
          crop of it when ``tile_shape`` gives the padded tile size, or a
          row band of it when ``y_offset`` gives the band's global first
          row — the plain version of K5).
    luts: [..., gy, gx, 256] float32, always the FULL tile grid.
    Returns float32 [..., H, W] of interpolated LUT values (un-rounded).

    OpenCV weights: ``txf = x * (1/tw) - 0.5`` with the f32 reciprocal;
    ``tx1 = max(floor(txf), 0)``; ``tx2 = min(floor(txf) + 1, gx - 1)``
    (the UNCLIPPED floor); ``xa = txf - floor(txf)``; x then y lerp. A
    band's rows enter as the f32 global row ``y + y_offset``.
    """
    gy, gx = grid
    *lead, h, w = u8.shape
    th, tw = tile_shape if tile_shape is not None else (h // gy, w // gx)
    dev = u8.device
    inv_th = float(np.float32(1.0) / np.float32(th))
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    yg = torch.arange(h, dtype=torch.float32, device=dev) + float(y_offset)
    yf = yg * inv_th - 0.5
    xf = torch.arange(w, dtype=torch.float32, device=dev) * inv_tw - 0.5
    ty1f = torch.floor(yf)
    tx1f = torch.floor(xf)
    ya = (yf - ty1f)[:, None]
    xa = (xf - tx1f)[None, :]
    ty1 = torch.clamp(ty1f.to(torch.int64), min=0)[:, None]
    tx1 = torch.clamp(tx1f.to(torch.int64), min=0)[None, :]
    ty2 = torch.clamp(ty1f.to(torch.int64) + 1, max=gy - 1)[:, None]
    tx2 = torch.clamp(tx1f.to(torch.int64) + 1, max=gx - 1)[None, :]

    flat = luts.reshape(*lead, gy * gx * NBINS)
    v = u8.to(torch.int64)

    def pick(ty: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
        idx = ((ty * gx + tx) * NBINS + v).reshape(*lead, h * w)
        return torch.gather(flat, -1, idx).reshape(*lead, h, w)

    v11, v12 = pick(ty1, tx1), pick(ty1, tx2)
    v21, v22 = pick(ty2, tx1), pick(ty2, tx2)
    top = v11 * (1.0 - xa) + v12 * xa
    bot = v21 * (1.0 - xa) + v22 * xa
    return top * (1.0 - ya) + bot * ya


def _clahe_tiled(img: torch.Tensor, clip_limit: float,
                 grid: tuple[int, int], convention: str) -> torch.Tensor:
    """The opencv and fraction conventions (OpenCV tiling and blend)."""
    gy, gx = grid
    h0, w0 = img.shape[-2:]
    u8, _, _ = _pad_reflect101(_levels(img.to(torch.float32)), (gy, gx),
                               convention)
    h, w = u8.shape[-2:]
    th, tw = h // gy, w // gx
    hists = _tile_histograms(u8, (gy, gx))
    build = _luts_opencv if convention == "opencv" else _luts_fraction
    luts = build(hists, clip_limit, th * tw).reshape(*u8.shape[:-2], gy, gx, NBINS)
    out = _bilinear_lut_apply(u8, luts, (gy, gx))[..., :h0, :w0]
    if convention == "opencv":
        return _u8norm(out)
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# skimage equalize_adapthist convention
# ---------------------------------------------------------------------------


def _skimage_scale_in(img: torch.Tensor) -> torch.Tensor:
    """img_as_uint + rescale_intensity to 14-bit gray (int32), with the
    min and max of each image [..., H, W]."""
    u16 = torch.clamp(torch.round(img.to(torch.float32) * 65535.0), 0, 65535)
    vmin = torch.amin(u16, dim=(-2, -1), keepdim=True)
    vmax = torch.amax(u16, dim=(-2, -1), keepdim=True)
    span = vmax - vmin
    scaled = torch.where(
        span > 0,
        (u16 - vmin) / torch.clamp(span, min=1.0) * (NR_OF_GRAY - 1),
        torch.clamp(u16, 0, NR_OF_GRAY - 1),
    )
    return torch.round(scaled).to(torch.int32)


def skimage_geometry(shape: tuple[int, int], kernel_size: tuple[int, int]):
    """skimage's pad and region layout for an H0 x W0 image: the pads
    (pr0, pr1, pc0, pc1) — k//2 before, (k - s%k)%k + ceil(k/2) after —
    and the region grid (nr, nc), one fewer per dim than the blocks."""
    (h0, w0), (kr, kc) = shape, kernel_size
    if kr < 1 or kc < 1:
        raise ValueError(f"kernel_size must be >= 1, got {kernel_size}")
    pr0, pc0 = kr // 2, kc // 2
    pr1 = (kr - h0 % kr) % kr + -(-kr // 2)
    pc1 = (kc - w0 % kc) % kc + -(-kc // 2)
    nr = (h0 + pr0 + pr1) // kr - 1
    nc = (w0 + pc0 + pc1) // kc - 1
    return (pr0, pr1, pc0, pc1), (nr, nc)


def _skimage_binned(img: torch.Tensor, kernel_size: tuple[int, int],
                    nbins: int) -> torch.Tensor:
    """Scale in, pad both sides with numpy 'reflect', and bin:
    [..., H0, W0] float -> [..., H, W] int32 bins of the padded image."""
    (pr0, pr1, pc0, pc1), _ = skimage_geometry(img.shape[-2:], kernel_size)
    image = _pad_reflect(_skimage_scale_in(img), (pr0, pr1), (pc0, pc1))
    return image // (1 + NR_OF_GRAY // nbins)


def _clip_histogram_skimage(hist: torch.Tensor, clim: int, nbins: int,
                            with_steps: bool = False):
    """skimage clip_histogram on integer histograms [..., nbins].

    Phases 1-2 (clip, uniform spread, top-up of near-limit bins) are
    vectorized; phase 3, the strided redistribution sweep, is one loop
    over all regions at once with the reference's per-region state
    (``step``, sweep ``index``, ``wrapped``, ``stalled``): a region that
    has finished stays frozen while the others step. ``with_steps`` also
    returns each region's number of phase-3 steps.
    """
    lead = hist.shape[:-1]
    h = hist.reshape(-1, nbins).to(torch.int64)
    n = torch.clamp(h - clim, min=0).sum(-1)
    h = torch.clamp(h, max=clim)

    bin_incr = n // nbins
    upper = (clim - bin_incr)[:, None]
    low = h < upper
    n = n - low.sum(-1) * bin_incr
    h = h + torch.where(low, bin_incr[:, None], 0)
    # evaluated on the UPDATED hist, like skimage
    mid = (h >= upper) & (h < clim)
    n = n - torch.where(mid, clim - h, 0).sum(-1)
    h = torch.where(mid, clim, h)

    pos = torch.arange(nbins, device=h.device)
    sweep_start = n.clone()
    index = torch.zeros_like(n)
    stalled = torch.zeros_like(n, dtype=torch.bool)
    steps = torch.zeros_like(n)
    active = n > 0
    while bool(active.any()):
        under = h < clim
        step = torch.clamp(under.sum(-1) // torch.clamp(n, min=1), min=1)
        off = pos - index[:, None]
        sel = under & (off >= 0) & (off % step[:, None] == 0) & active[:, None]
        h = h + sel
        n = n - sel.sum(-1)
        index = index + active
        steps = steps + active
        wrapped = index == nbins
        stalled = stalled | (wrapped & (n == sweep_start))
        sweep_start = torch.where(wrapped, n, sweep_start)
        index = torch.where(wrapped, 0, index)
        active = (n > 0) & ~stalled
    out = h.to(torch.int32).reshape(*lead, nbins)
    return (out, steps.reshape(lead)) if with_steps else out


def _skimage_maps(hists: torch.Tensor, k_elems: int) -> torch.Tensor:
    """map_histogram: f32 cumsum x f32(16383 / k_elems), min, floor."""
    scale = float(np.float32((NR_OF_GRAY - 1) / k_elems))
    maps = torch.cumsum(hists.to(torch.float32), dim=-1) * scale
    return torch.floor(torch.clamp(maps, max=NR_OF_GRAY - 1))


def _skimage_apply(binned: torch.Tensor, maps: torch.Tensor,
                   kernel_size: tuple[int, int], origin: tuple[int, int],
                   out_shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear interpolation between the 4 neighbouring region maps, at
    the pixels of the crop that starts at ``origin`` of the padded
    ``binned`` [..., H, W] and has ``out_shape``.

    maps: [..., nr, nc, nbins] float32 integer-valued. The corner maps are
    the edge-replicated map grid (clamped indices); the weights are
    ``arange(k) / k`` by true division; the four ``sel * coeff`` terms are
    added in corner order and the sum is floored.
    """
    kr, kc = kernel_size
    (y0, x0), (h0, w0) = origin, out_shape
    *lead, nr, nc, nbins = maps.shape
    dev = binned.device
    ys = torch.arange(y0, y0 + h0, device=dev)
    xs = torch.arange(x0, x0 + w0, device=dev)
    wy = (ys % kr).to(torch.float32) / _const(binned, float(kr))
    wx = (xs % kc).to(torch.float32) / _const(binned, float(kc))
    by, bx = ys // kr, xs // kc
    my = [torch.clamp(by - 1 + e, 0, nr - 1)[:, None] for e in (0, 1)]
    mx = [torch.clamp(bx - 1 + e, 0, nc - 1)[None, :] for e in (0, 1)]

    flat = maps.reshape(*lead, nr * nc * nbins)
    v = binned[..., y0:y0 + h0, x0:x0 + w0].to(torch.int64)

    def pick(ey: int, ex: int) -> torch.Tensor:
        idx = ((my[ey] * nc + mx[ex]) * nbins + v).reshape(*lead, h0 * w0)
        return torch.gather(flat, -1, idx).reshape(*lead, h0, w0)

    cy = (1.0 - wy[:, None], wy[:, None])
    cx = (1.0 - wx[None, :], wx[None, :])
    acc = pick(0, 0) * (cy[0] * cx[0])
    for ey, ex in ((0, 1), (1, 0), (1, 1)):
        acc = acc + pick(ey, ex) * (cy[ey] * cx[ex])
    return torch.floor(acc)


def _skimage_stretch_out(result: torch.Tensor) -> torch.Tensor:
    """img_as_float + the final rescale_intensity, per image (the /65535
    cancels where the image is not flat)."""
    rmin = torch.amin(result, dim=(-2, -1), keepdim=True)
    rmax = torch.amax(result, dim=(-2, -1), keepdim=True)
    return torch.where(
        rmax > rmin,
        (result - rmin) / torch.clamp(rmax - rmin, min=1.0),
        torch.clamp(result / _const(result, 65535.0), 0.0, 1.0),
    )


def _clahe_skimage(img: torch.Tensor, kernel_size: tuple[int, int],
                   clip_limit: float, nbins: int) -> torch.Tensor:
    """skimage.exposure.equalize_adapthist on float [..., H0, W0]."""
    kr, kc = kernel_size
    h0, w0 = img.shape[-2:]
    (pr0, _, pc0, _), (nr, nc) = skimage_geometry((h0, w0), kernel_size)
    binned = _skimage_binned(img, kernel_size, nbins)
    k_elems = kr * kc
    clim = int(np.clip(clip_limit * k_elems, 1, None))
    regions = binned[..., pr0:pr0 + nr * kr, pc0:pc0 + nc * kc]
    hists = _tile_histograms(regions, (nr, nc), nbins).to(torch.int32)
    maps = _skimage_maps(_clip_histogram_skimage(hists, clim, nbins), k_elems)
    maps = maps.reshape(*binned.shape[:-2], nr, nc, nbins)
    result = _skimage_apply(binned, maps, kernel_size, (pr0, pc0), (h0, w0))
    return _skimage_stretch_out(result)


def skimage_kernel_size(shape: tuple[int, int], grid_size: tuple[int, int],
                        kernel_size=None) -> tuple[int, int]:
    """skimage's region size: given, or (max(H // gy, 1), max(W // gx, 1))
    — the default grid (8, 8) gives skimage's own default shape // 8."""
    if kernel_size is not None:
        return tuple(kernel_size)
    (h, w), (gy, gx) = shape, grid_size
    return max(h // gy, 1), max(w // gx, 1)


# ---------------------------------------------------------------------------
# kornia equalize_clahe convention
# ---------------------------------------------------------------------------


def _kornia_tile_geometry(
    shape: tuple[int, int], grid: tuple[int, int]
) -> tuple[int, int, int, int]:
    """kornia _compute_tiles(even_tile_size=True): tile = ceil(side /
    grid) rounded UP to even; the reflect pad must stay < dim."""
    h, w = shape
    gh, gw = grid
    th = -(-h // gh)
    th += th % 2
    tw = -(-w // gw)
    tw += tw % 2
    pv, pw = th * gh - h, tw * gw - w
    if pv >= h or pw >= w:
        raise ValueError(
            f"image size {tuple(shape)} and grid size {tuple(grid)} mismatch "
            f"for the kornia convention (reflect padding needs pad < dim)"
        )
    return th, tw, pv, pw


def _kornia_weights(n_blocks: int, size: int) -> np.ndarray:
    """linspace(0, 1) weights per half-tile block, zeroed on the first
    and last block (a border block's clamped axis)."""
    wts = np.broadcast_to(
        np.linspace(0.0, 1.0, size, dtype=np.float32)[None, :], (n_blocks, size)
    ).copy()
    wts[0] = 0.0
    wts[-1] = 0.0
    return wts.reshape(-1)


def _clahe_kornia(img: torch.Tensor, clip_limit: float,
                  grid_size: tuple[int, int]) -> torch.Tensor:
    """kornia.enhance.equalize_clahe on float [..., H0, W0].

    Border interpolation blocks fold into the one bilinear formula by
    clamping the neighbour-LUT indices and zeroing the border-axis
    weight, as the reference does."""
    x = img.to(torch.float32)
    h0, w0 = x.shape[-2:]
    gh, gw = grid_size
    th, tw, pv, pw = _kornia_tile_geometry((h0, w0), (gh, gw))
    p_px = th * tw

    # per-tile torch.histc(_, 256, 0, 1): floor(x*256), x == 1 in bin 255
    padded = _pad_reflect(x, (0, pv), (0, pw))
    idx256 = torch.clamp(torch.floor(padded * 256.0), max=255.0).to(torch.int32)
    hist = _tile_histograms(idx256, (gh, gw))
    if clip_limit > 0:
        # float clip at max(clip * P // 256, 1); even redistribution with
        # the first (excess % 256) bins topped up by one
        hist = torch.clamp(hist, max=float(max(clip_limit * p_px // NBINS, 1.0)))
        clipped = float(p_px) - hist.sum(-1, keepdim=True)
        residual = torch.remainder(clipped, NBINS)
        hist = hist + (clipped - residual) / NBINS
        bins = torch.arange(NBINS, dtype=torch.float32, device=x.device)
        hist = hist + (bins < residual).to(torch.float32)
    lut = torch.cumsum(hist, dim=-1) * float(np.float32(255.0 / p_px))
    luts = torch.floor(torch.clamp(lut, 0.0, 255.0))

    # half-tile interpolation grid over the crop (the pad is bottom/right
    # only); pixel bin = trunc(x * 255)
    th2, tw2 = th // 2, tw // 2
    nr, nc = 2 * gh, 2 * gw
    dev = x.device
    blk_y, blk_x = np.arange(h0) // th2, np.arange(w0) // tw2
    wy = torch.from_numpy(_kornia_weights(nr, th2)[:h0]).to(dev)[:, None]
    wx = torch.from_numpy(_kornia_weights(nc, tw2)[:w0]).to(dev)[None, :]
    ty = [torch.from_numpy(np.clip((blk_y + e) // 2, 0, gh - 1)).to(dev)[:, None]
          for e in (-1, 1)]
    tx = [torch.from_numpy(np.clip((blk_x + e) // 2, 0, gw - 1)).to(dev)[None, :]
          for e in (-1, 1)]
    v = torch.clamp(torch.floor(x * 255.0), 0.0, 255.0).to(torch.int64)
    *lead, _, _ = x.shape
    flat = luts.reshape(*lead, gh * gw * NBINS)

    def pick(a: int, b: int) -> torch.Tensor:
        idx = ((ty[a] * gw + tx[b]) * NBINS + v).reshape(*lead, h0 * w0)
        return torch.gather(flat, -1, idx).reshape(*lead, h0, w0)

    top = pick(0, 0) * (1.0 - wx) + pick(0, 1) * wx
    bot = pick(1, 0) * (1.0 - wx) + pick(1, 1) * wx
    res = top * (1.0 - wy) + bot * wy
    return res / _const(res, 255.0)


def clahe(
    img: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size: tuple[int, int] = (8, 8),
    convention: str = "opencv",
    nbins: int = NBINS,
    kernel_size: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Contrast-Limited Adaptive Histogram Equalization on float [0, 1].

    convention="opencv": OpenCV's exact integer algorithm on uint8 levels
    (clip = max(int(clip_limit * tile_area / 256), 1)), float levels / 255.
    convention="fraction": clip = max(clip_limit * tile_area, 1) float
    counts, one-pass redistribution, cdf / tile_area LUTs, the OpenCV
    blend, clipped to [0, 1].
    convention="skimage": skimage.exposure.equalize_adapthist; clip_limit
    is a fraction of region pixels, ``kernel_size`` the region size (None:
    (max(H // gy, 1), max(W // gx, 1))), ``nbins`` any value >= 2.
    convention="kornia": kornia.enhance.equalize_clahe, float output.
    """
    if img.dim() < 2:
        raise ValueError(f"clahe expects [..., H, W]; got {tuple(img.shape)}")
    check_convention(convention, nbins)
    grid = tuple(grid_size)
    if convention == "skimage":
        ks = skimage_kernel_size(img.shape[-2:], grid, kernel_size)
        return _clahe_skimage(img, ks, clip_limit, nbins)
    if convention == "kornia":
        return _clahe_kornia(img, clip_limit, grid)
    return _clahe_tiled(img, clip_limit, grid, convention)


# ---------------------------------------------------------------------------
# Global histogram equalization (one histogram per image)
# ---------------------------------------------------------------------------


def _image_hists(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """Integer histograms [B, nbins] of int64 bin indices [B, P] in
    [0, nbins): one ``scatter_add_`` of ones along each row (a bincount
    of ``idx + b * nbins`` took 4x as long on the card: PERF.md)."""
    hist = torch.zeros((idx.shape[0], nbins), dtype=torch.int64,
                       device=idx.device)
    return hist.scatter_add_(1, idx, torch.ones_like(idx))


def equalize_hist(img: torch.Tensor, nbins: int = NBINS) -> torch.Tensor:
    """Global histogram equalization, skimage semantics, per image of
    [..., H, W]: ``nbins`` bins over the image's own [min, max], the
    cumulative count over its total, and the linear interpolation of that
    CDF against the bin centres (float in [0, 1])."""
    return _equalize_hist(img, nbins, 2)


def _local(t: torch.Tensor, op: str) -> torch.Tensor:
    """A statistic of the tensor in hand: the default ``combine`` of the
    statistics-taking ops (a z band's is an all_reduce,
    ``parallel.volume_shard``)."""
    return t


def _equalize_hist(img: torch.Tensor, nbins: int, nd: int,
                   combine=_local) -> torch.Tensor:
    """``equalize_hist`` over the last ``nd`` axes of ``img``, one
    histogram each. The counts and their cumulative sum are int64, exact
    at any size; each partial sum is rounded to float32 once and divided
    by the rounded total (the reference's float32 cumsum of float32
    counts, which is the same while an image has < 2**24 pixels and
    drifts beyond). ``combine(t, "min" | "max" | "sum")`` turns a z band's
    min, max and counts into the whole volume's
    (``parallel.volume_shard``: an all_reduce)."""
    if nbins < 2:
        raise ValueError(f"nbins must be >= 2, got {nbins}")
    x = img.to(torch.float32)
    flat = x.reshape(-1, math.prod(x.shape[-nd:]))
    lo = combine(torch.amin(flat, dim=1, keepdim=True), "min")
    hi = combine(torch.amax(flat, dim=1, keepdim=True), "max")
    span = torch.maximum(hi - lo, _const(x, 1e-12))
    # bin index per pixel; pixels at `hi` land in the last bin
    idx = torch.clamp(((flat - lo) / span * nbins).to(torch.int64), 0,
                      nbins - 1)
    cdf = torch.cumsum(combine(_image_hists(idx, nbins), "sum"),
                       dim=1).to(torch.float32)
    cdf = cdf / cdf[:, -1:]
    width = span / _const(x, nbins)
    c0 = lo + 0.5 * width
    xi = (flat - c0) / width
    i = torch.clamp(torch.floor(xi).to(torch.int64), 0, nbins - 2)
    frac = torch.clamp(xi - i.to(torch.float32), 0.0, 1.0)
    c_lo = torch.gather(cdf, 1, i)
    c_hi = torch.gather(cdf, 1, i + 1)
    return (c_lo + frac * (c_hi - c_lo)).reshape(x.shape)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """kornia.enhance.equalize / PIL ImageOps.equalize per image of
    [..., H, W]: PIL's exact integer LUT of each image's uint8 histogram,

        step   = (sum(hist) - hist[last nonzero bin]) // 255
        lut[i] = clamp((step // 2 + sum(hist[:i])) // step, 0, 255)

    (the identity where step == 0), applied by gather; levels / 255."""
    x = img.to(torch.float32)
    u8 = _levels(x).reshape(-1, x.shape[-2] * x.shape[-1]).long()
    hist = _image_hists(u8, NBINS)
    bins = torch.arange(NBINS, device=x.device)
    total = hist.sum(dim=1, keepdim=True)
    last_idx = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    last = torch.where(bins == last_idx, hist, 0).sum(dim=1, keepdim=True)
    step = (total - last) // 255
    prev = torch.cumsum(hist, dim=1) - hist  # the counts strictly below i
    lut = torch.clamp((prev + step // 2) // torch.clamp_min(step, 1), 0, 255)
    lut = torch.where(step > 0, lut, bins)  # PIL's identity when step == 0
    out = torch.gather(lut, 1, u8).to(torch.float32)
    return (out / _const(out, 255.0)).reshape(x.shape)


# ---------------------------------------------------------------------------
# Histogram matching (skimage.exposure.match_histograms)
# ---------------------------------------------------------------------------


def reference_cdf(ref: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side half of histogram matching: the reference image's unique
    values and their cumulative quantiles, float32 (skimage
    ``_match_cumulative_cdf``'s template side)."""
    values, counts = np.unique(np.asarray(ref).ravel(), return_counts=True)
    quantiles = np.cumsum(counts) / ref.size
    return values.astype(np.float32), quantiles.astype(np.float32)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp) with its float32 arithmetic: the segment
    searchsorted(side='right') clipped to [1, len - 1], fp[i-1] + (delta /
    dx) * df (fp[i-1] where |dx| is below spacing(eps)), and fp's end
    values outside [xp[0], xp[-1]]. jnp.interp is jitted, and XLA
    contracts the last multiply-add into an FMA: it is rounded once here
    too (the product of two float32 values is exact in float64)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    slope = delta / torch.where(dx0, torch.ones_like(dx), dx)
    fused = (slope.double() * df.double() + fp[i - 1].double()).float()
    f = torch.where(dx0, fp[i - 1], fused)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def match_histograms(img: torch.Tensor, ref_values: torch.Tensor,
                     ref_quantiles: torch.Tensor) -> torch.Tensor:
    """skimage.exposure.match_histograms on float [0, 1] slices quantized to
    256 levels, each slice of [..., H, W] on its own: a level's quantile is
    the inclusive CDF of the slice's histogram (float32 count / pixels),
    and its output the reference value at that quantile (``_interp``),
    applied as a 256-entry table."""
    x = img.to(torch.float32)
    u8 = _levels(x).reshape(-1, x.shape[-2] * x.shape[-1]).long()
    hist = _image_hists(u8, NBINS)
    q = torch.cumsum(hist, dim=1).to(torch.float32) / _const(x, u8.shape[1])
    lut = _interp(q, ref_quantiles.to(x.device), ref_values.to(x.device))
    return torch.gather(lut, 1, u8).reshape(x.shape)
