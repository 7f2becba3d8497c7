"""Volumetric (3-D) ops, plain PyTorch: 3-D CLAHE, the 3-D filters and
morphology, the trilinear resample, and the whole-volume forms of the
statistics-taking 2-D ops.

Same algorithms and f32 operation order as ``mies_tpu.ops.volume3d``:

* ``clahe3d`` opencv / fraction: uint8 levels, exact integer counts over
  volumetric tiles, the 2-D conventions' LUT builds (clip value and LUT
  scale per tile volume), and the trilinear blend of the 8 neighbouring
  tiles' LUTs with OpenCV's f32-reciprocal weights per axis, x then y
  then z; epilogue ``clip(rint(v), 0, 255) / 255`` (opencv) or
  ``clip(v, 0, 1)`` (fraction).
* ``clahe3d`` skimage: ``equalize_adapthist`` on a [Z, H, W] volume, the
  2-D path with cubic regions: 14-bit scale-in and stretch over the whole
  volume, numpy 'reflect' pad on both sides of every axis, the iterative
  clip, floored maps, the 8-corner ``arange(k) / k`` blend, floor.
* ``gaussian_blur3d``: three scipy passes, z then y then x, each with its
  own border pad, taps in ascending order; ``unsharp_mask3d`` and
  ``difference_of_gaussians3d`` on it.
* ``guided_blur3d``: the self-guided dataflow on separable cubic box
  means (k taps of float32(1 / k) per axis).
* ``median_blur3d``: the middle wire of the k^3 Batcher network, cut to
  the comparators it depends on (126 at k 3), on strided views of the
  padded volume; min and max are exact, so it equals the full network.
* ``erode3d`` ... ``black_hat3d``: a cubic min or max as one sliding pass
  per axis ('ignore': a +-inf border the reduction never picks).
* ``resample3d``: the host-built align-corners linear interpolation
  matrices' two taps per output row, z then y then x, as float32 lerps.
* ``equalize_hist_volume``, ``normalize_volume``,
  ``rescale_intensity_volume``: the 2-D ops with the statistic (the
  histogram, the min and max) taken over the whole volume, as the
  reference's volume program takes it; the 2-D registry forms take each
  slice's.

The volumetric restorations, ridge, frequency and wavelet ops live beside
their 2-D forms (``ops.restoration``, ``.ridges``, ``.frequency``,
``.wavelet``). Functions take one [Z, H, W] volume and run on the tensor's
own device.
They are also the plain versions of the kernels of ``kernels.clahe3d``:
K8 (``_apply_luts_trilinear_gather`` + the epilogue) and K8s
(``_apply_maps_3d``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mies_tpu_torch.ops import filters as F
from mies_tpu_torch.ops import histogram as H
from mies_tpu_torch.ops import intensity as I

NBINS = H.NBINS
CONVENTIONS_3D = ("opencv", "fraction", "skimage")


def tile_shape_3d(shape, grid) -> tuple[int, int, int]:
    """(tz, th, tw) of the opencv/fraction grid; the volume must divide."""
    if any(g < 1 for g in grid):
        raise ValueError(f"grid_size must be >= 1, got {tuple(grid)}")
    if any(s % g for s, g in zip(shape, grid)):
        raise ValueError(
            f"volume {tuple(shape)} not divisible by grid {tuple(grid)}"
        )
    return tuple(s // g for s, g in zip(shape, grid))


def _tile_hists_3d(u8: torch.Tensor, grid) -> torch.Tensor:
    """Exact 256-bin counts over volumetric tiles: [Z, H, W] integer
    levels -> [gz * gy * gx, 256] float32."""
    gz, gy, gx = grid
    tz, th, tw = tile_shape_3d(u8.shape, grid)
    tiles = (u8.reshape(gz, tz, gy, th, gx, tw).permute(0, 2, 4, 1, 3, 5)
             .reshape(gz * gy * gx, tz * th * tw).to(torch.int64))
    hist = torch.zeros(gz * gy * gx, NBINS, dtype=torch.float32,
                       device=u8.device)
    return hist.scatter_add_(1, tiles, torch.ones_like(tiles, dtype=torch.float32))


def _axis_weights(n: int, t: int, g: int, device, offset: int = 0):
    """OpenCV per-axis interpolation at the positions ``offset`` ..
    ``offset + n - 1`` of the axis: ``f = idx * f32(1 / t) - 0.5``, the
    clamped lo / hi tile indices (hi from the unclipped floor) and the
    fraction ``f - floor(f)``. The float32 index is exact (< 2**24), so a
    band's weights at its global offset are the whole axis's."""
    inv = float(np.float32(1.0) / np.float32(t))
    f = torch.arange(offset, offset + n, dtype=torch.float32,
                     device=device) * inv - 0.5
    lo_f = torch.floor(f)
    a = f - lo_f
    lo = torch.clamp(lo_f.to(torch.int64), min=0)
    hi = torch.clamp(lo_f.to(torch.int64) + 1, max=g - 1)
    return lo, hi, a


def _apply_luts_trilinear_gather(u8: torch.Tensor, luts: torch.Tensor,
                                 grid, z_total: int | None = None,
                                 z0: int = 0) -> torch.Tensor:
    """Trilinear blend of the 8 neighbouring tiles' LUT entries at each
    voxel's level: [Z, H, W] integer levels x [gz, gy, gx, 256] float32
    LUTs -> [Z, H, W] float32, unrounded. The corner values, the f32
    fractions and the x -> y -> z lerp order of the reference's gather
    form. With ``z_total`` the input is the slices ``z0`` .. ``z0 + Z - 1``
    of a volume of ``z_total`` slices (a z band: the reference's
    ``_trilinear_zband_gather``), weighted at their global z."""
    gz, gy, gx = grid
    z, h, w = u8.shape
    tz, th, tw = tile_shape_3d(
        (z if z_total is None else z_total, h, w), grid)
    dev = u8.device
    zlo, zhi, za = _axis_weights(z, tz, gz, dev, z0)
    ylo, yhi, ya = _axis_weights(h, th, gy, dev)
    xlo, xhi, xa = _axis_weights(w, tw, gx, dev)
    flat = luts.reshape(-1)
    v = u8.to(torch.int64)

    def corner(zi, yi, xi):
        tile = (zi[:, None, None] * gy + yi[None, :, None]) * gx \
            + xi[None, None, :]
        return flat.take(tile * NBINS + v)

    zab, yab, xab = za[:, None, None], ya[None, :, None], xa[None, None, :]
    c00 = corner(zlo, ylo, xlo) * (1.0 - xab) + corner(zlo, ylo, xhi) * xab
    c01 = corner(zlo, yhi, xlo) * (1.0 - xab) + corner(zlo, yhi, xhi) * xab
    c10 = corner(zhi, ylo, xlo) * (1.0 - xab) + corner(zhi, ylo, xhi) * xab
    c11 = corner(zhi, yhi, xlo) * (1.0 - xab) + corner(zhi, yhi, xhi) * xab
    c0 = c00 * (1.0 - yab) + c01 * yab
    c1 = c10 * (1.0 - yab) + c11 * yab
    return c0 * (1.0 - zab) + c1 * zab


def luts_3d(hists: torch.Tensor, clip_limit: float, tile_vox: int,
            convention: str) -> torch.Tensor:
    """[..., 256] volumetric tile counts -> LUTs: opencv's integer LUTs
    (clip max(int(clip_limit * tile_vox / 256), 1)) or the fraction
    convention's cdf / tile_vox (clip max(clip_limit * tile_vox, 1))."""
    if convention == "opencv":
        return H._luts_opencv(hists, clip_limit, tile_vox)
    if convention == "fraction":
        return H._luts_fraction(hists, clip_limit, tile_vox)
    raise ValueError(f"unknown CLAHE convention: {convention!r}")


def finalize_3d(res: torch.Tensor, finalize: str) -> torch.Tensor:
    """The epilogue: "u8norm" (opencv) or "clip01" (fraction)."""
    if finalize == "u8norm":
        return H._u8norm(res)
    return torch.clamp(res, 0.0, 1.0)


def _clahe3d_tiled(vol: torch.Tensor, clip_limit: float, grid,
                   convention: str) -> torch.Tensor:
    x = vol.to(torch.float32)
    tz, th, tw = tile_shape_3d(x.shape, grid)
    u8 = H._levels(x)
    hists = _tile_hists_3d(u8, grid)
    luts = luts_3d(hists, clip_limit, tz * th * tw, convention)
    res = _apply_luts_trilinear_gather(u8, luts.reshape(*grid, NBINS), grid)
    return finalize_3d(res, "u8norm" if convention == "opencv" else "clip01")


# ---------------------------------------------------------------------------
# skimage equalize_adapthist on a volume
# ---------------------------------------------------------------------------


def skimage3d_kernel_size(shape, grid_size, kernel_size=None):
    """The region size: given, or (max(Z // gz, 1), max(H // gy, 1),
    max(W // gx, 1))."""
    if kernel_size is not None:
        ks = tuple(int(k) for k in kernel_size)
    else:
        ks = tuple(max(s // g, 1) for s, g in zip(shape, grid_size))
    if len(ks) != 3 or min(ks) < 1:
        raise ValueError(f"kernel_size must be 3 ints >= 1, got {ks}")
    return ks


def skimage3d_geometry(shape, kernel_size):
    """skimage's pads per axis, ``pad0 = k // 2`` before and ``pad1 = (k -
    s % k) % k + ceil(k / 2)`` after, and the region grid (one fewer per
    axis than the blocks of the padded volume)."""
    pad0 = tuple(k // 2 for k in kernel_size)
    pad1 = tuple((k - s % k) % k + -(-k // 2)
                 for k, s in zip(kernel_size, shape))
    ns = tuple((s + p0 + p1) // k - 1
               for s, p0, p1, k in zip(shape, pad0, pad1, kernel_size))
    return pad0, pad1, ns


def _index_pad(x: torch.Tensor, dim: int, pads, mode: str) -> torch.Tensor:
    """np.pad(..., mode) of one dim by index (any pad length)."""
    if not any(pads):
        return x
    idx = np.pad(np.arange(x.shape[dim]), pads, mode=mode)
    return x.index_select(dim, torch.as_tensor(idx, device=x.device))


def _skimage3d_binned(vol: torch.Tensor, kernel_size, nbins: int):
    """Scale the volume to 14-bit gray with its own min and max, pad every
    axis with numpy 'reflect', and bin: [Z, H, W] float -> the padded
    volume's int32 bins."""
    z, h, w = vol.shape
    # one image: the min and max run over the whole volume
    image = H._skimage_scale_in(vol.reshape(z * h, w)).reshape(z, h, w)
    pad0, pad1, _ = skimage3d_geometry(vol.shape, kernel_size)
    for dim in range(3):
        image = _index_pad(image, dim, (pad0[dim], pad1[dim]), "reflect")
    return image // (1 + H.NR_OF_GRAY // nbins)


def _edge_pad_maps(maps: torch.Tensor) -> torch.Tensor:
    """[nz, ny, nx, nbins] -> [nz + 2, ny + 2, nx + 2, nbins], each region
    axis edge-padded by one (skimage's np.pad(..., mode='edge'))."""
    for dim in range(3):
        maps = _index_pad(maps, dim, (1, 1), "edge")
    return maps


def _apply_maps_3d(binned: torch.Tensor, map_array: torch.Tensor,
                   kernel_size, origin, out_shape) -> torch.Tensor:
    """skimage's trilinear blend of the 8 neighbouring region maps at the
    voxels of the ``out_shape`` crop whose first corner is ``origin`` of
    the padded ``binned`` volume.

    map_array: [nz + 1, ny + 1, nx + 1, nbins] float32 integer-valued, the
    edge-padded maps (block b reads corners b and b + 1 per axis). The
    weights are ``arange(k) / k`` by true division; the 8 ``sel * coeff``
    terms, ``coeff = (cz * cy) * cx``, are added in corner order (z, y, x
    lexicographic) and the sum is floored."""
    ks = kernel_size
    nz1, ny1, nx1, nbins = map_array.shape
    dev = binned.device
    coords = [torch.arange(o, o + n, device=dev)
              for o, n in zip(origin, out_shape)]
    w = [(c % k).to(torch.float32) / H._const(map_array, float(k))
         for c, k in zip(coords, ks)]
    b = [c // k for c, k in zip(coords, ks)]
    (z0, y0, x0), (d0, d1, d2) = origin, out_shape
    v = binned[z0:z0 + d0, y0:y0 + d1, x0:x0 + d2].to(torch.int64)
    flat = map_array.reshape(-1)
    cz = (1.0 - w[0][:, None, None], w[0][:, None, None])
    cy = (1.0 - w[1][None, :, None], w[1][None, :, None])
    cx = (1.0 - w[2][None, None, :], w[2][None, None, :])
    acc = None
    for ez in range(2):
        for ey in range(2):
            for ex in range(2):
                cell = (((b[0] + ez)[:, None, None] * ny1
                         + (b[1] + ey)[None, :, None]) * nx1
                        + (b[2] + ex)[None, None, :])
                term = flat.take(cell * nbins + v) * ((cz[ez] * cy[ey]) * cx[ex])
                acc = term if acc is None else acc + term
    return torch.floor(acc)


def _skimage3d_stretch_out(result: torch.Tensor) -> torch.Tensor:
    """The final rescale over the whole volume."""
    z, h, w = result.shape
    return H._skimage_stretch_out(result.reshape(z * h, w)).reshape(z, h, w)


def _clahe3d_skimage(vol: torch.Tensor, kernel_size, clip_limit: float,
                     nbins: int = NBINS) -> torch.Tensor:
    """skimage equalize_adapthist on a [Z, H, W] volume with cubic regions
    of ``kernel_size``."""
    ks = tuple(int(k) for k in kernel_size)
    pad0, _, ns = skimage3d_geometry(vol.shape, ks)
    binned = _skimage3d_binned(vol, ks, nbins)
    k_elems = ks[0] * ks[1] * ks[2]
    clim = int(np.clip(clip_limit * k_elems, 1, None))
    regions = binned[tuple(slice(p, p + n * k) for p, n, k in zip(pad0, ns, ks))]
    regions = (regions.reshape(ns[0], ks[0], ns[1], ks[1], ns[2], ks[2])
               .permute(0, 2, 4, 1, 3, 5).reshape(-1, k_elems).to(torch.int64))
    hists = torch.zeros(regions.shape[0], nbins, dtype=torch.int32,
                        device=vol.device)
    hists.scatter_add_(1, regions, torch.ones_like(regions, dtype=torch.int32))
    hists = H._clip_histogram_skimage(hists, clim, nbins)
    maps = H._skimage_maps(hists, k_elems).reshape(*ns, nbins)
    result = _apply_maps_3d(binned, _edge_pad_maps(maps), ks, pad0, vol.shape)
    return _skimage3d_stretch_out(result)


def clahe3d(
    vol: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size=(4, 8, 8),
    convention: str = "opencv",
    kernel_size=None,
) -> torch.Tensor:
    """3-D CLAHE on a float [0, 1] volume [Z, H, W].

    convention="opencv"/"fraction": Z, H, W must be divisible by
    grid_size. convention="skimage": equalize_adapthist semantics on any
    shape; ``kernel_size`` defaults to (Z // gz, H // gy, W // gx), at
    least 1 per axis. Returns float32 [Z, H, W]."""
    F.check_volume(vol, "clahe3d")
    if convention not in CONVENTIONS_3D:
        raise ValueError(f"unknown CLAHE convention: {convention!r}")
    grid = tuple(int(g) for g in grid_size)
    if convention == "skimage":
        ks = skimage3d_kernel_size(vol.shape, grid, kernel_size)
        return _clahe3d_skimage(vol.to(torch.float32), ks, clip_limit)
    return _clahe3d_tiled(vol, clip_limit, grid, convention)


def gaussian_blur3d(
    vol: torch.Tensor, sigma: float = 1.0, truncate: float = 4.0,
    mode: str = "nearest",
) -> torch.Tensor:
    """Separable 3-D Gaussian over [Z, H, W]: scipy's taps (radius
    int(truncate * sigma + 0.5)) along z, then y, then x, each pass with
    its own border pad and its taps summed in ascending order."""
    F.check_volume(vol, "gaussian_blur3d")
    if sigma <= 0:
        return vol
    radius = int(truncate * float(sigma) + 0.5)
    return _pass3d(vol.to(torch.float32),
                   F.gaussian_kernel1d(float(sigma), radius), mode)


def _pass3d(x: torch.Tensor, taps: np.ndarray, mode: str) -> torch.Tensor:
    """The separable correlation with ``taps`` along z, y, then x, each
    pass with its own border pad (scipy's sequential correlate1d)."""
    for axis in (-3, -2, -1):
        x = F._conv1d_shifted(x, taps, axis, mode)
    return x


def guided_blur3d(
    vol: torch.Tensor, kernel_size: int = 3, eps: float = 1e-2,
    mode: str = "reflect",
) -> torch.Tensor:
    """Volumetric self-guided filter (He et al. 2010 on cubic windows): the
    guided dataflow on separable 3-D box means."""
    F.check_volume(vol, "guided_blur3d")
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    taps = np.full((kernel_size,), 1.0 / kernel_size, np.float32)

    def box(v):
        return v if kernel_size == 1 else _pass3d(v, taps, mode)

    return F.guided_dataflow(lambda u, v: (box(u), box(v)),
                             vol.to(torch.float32), eps)


def median_blur3d(vol: torch.Tensor, kernel_size: int = 3,
                  mode: str = "nearest") -> torch.Tensor:
    """3-D median over a cubic footprint (scipy.ndimage.median_filter,
    size k): the middle wire of the k^3 sorting network, the comparators
    run one after another on strided views (no [k^3, Z, H, W] stack)."""
    F.check_volume(vol, "median_blur3d")
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    k, r = kernel_size, kernel_size // 2
    x = vol.to(torch.float32)
    if r == 0:
        return x
    z, h, w = x.shape
    p = x
    for axis in (-3, -2, -1):
        p = F._pad_axis(p, r, axis, mode)
    vals = [p[dz:dz + z, dy:dy + h, dx:dx + w]
            for dz in range(k) for dy in range(k) for dx in range(k)]
    for i, j, keep_min, keep_max in F._median_network(len(vals)):
        a, b = vals[i], vals[j]
        if keep_min:
            vals[i] = torch.minimum(a, b)
        if keep_max:
            vals[j] = torch.maximum(a, b)
    return vals[len(vals) // 2]


def unsharp_mask3d(
    vol: torch.Tensor, radius: float = 1.0, amount: float = 1.0,
    mode: str = "nearest", clip: bool = True,
) -> torch.Tensor:
    """3-D unsharp masking: ``vol + amount * (vol - gaussian3d(vol))``,
    clipped to [0, 1]."""
    blurred = gaussian_blur3d(vol, sigma=radius, mode=mode)
    x = vol.to(torch.float32)
    out = x + amount * (x - blurred)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _extremum3d(vol: torch.Tensor, kernel_size: int, mode: str,
                maximum: bool) -> torch.Tensor:
    """Cubic min or max: one sliding pass per axis, z then y then x.
    'ignore' pads the constant the reduction never picks (+inf for a
    min, -inf for a max: scipy's grey morphology, mode='constant')."""
    F.check_volume(vol, "3-D morphology")
    k = int(kernel_size)
    if k % 2 != 1:
        raise ValueError("kernel_size must be odd")
    r = k // 2
    x = vol.to(torch.float32)
    if r == 0:
        return x
    for axis in (-3, -2, -1):
        if mode == "ignore":
            fill = float("-inf") if maximum else float("inf")
            xp = torch.nn.functional.pad(x, (0, 0) * (-1 - axis) + (r, r),
                                         value=fill)
        else:
            xp = F._pad_axis(x, r, axis, mode)
        win = xp.unfold(axis, k, 1)
        x = win.amax(-1) if maximum else win.amin(-1)
    return x


def erode3d(vol: torch.Tensor, kernel_size: int = 3,
            mode: str = "ignore") -> torch.Tensor:
    """Volumetric grayscale erosion over a cubic footprint
    (scipy.ndimage.grey_erosion, size (k, k, k))."""
    return _extremum3d(vol, kernel_size, mode, maximum=False)


def dilate3d(vol: torch.Tensor, kernel_size: int = 3,
             mode: str = "ignore") -> torch.Tensor:
    """Volumetric grayscale dilation (scipy.ndimage.grey_dilation)."""
    return _extremum3d(vol, kernel_size, mode, maximum=True)


def morph_open3d(vol: torch.Tensor, kernel_size: int = 3,
                 mode: str = "ignore") -> torch.Tensor:
    """3-D opening: dilate3d(erode3d(vol))."""
    return dilate3d(erode3d(vol, kernel_size, mode), kernel_size, mode)


def morph_close3d(vol: torch.Tensor, kernel_size: int = 3,
                  mode: str = "ignore") -> torch.Tensor:
    """3-D closing: erode3d(dilate3d(vol))."""
    return erode3d(dilate3d(vol, kernel_size, mode), kernel_size, mode)


def morph_gradient3d(vol: torch.Tensor, kernel_size: int = 3,
                     mode: str = "ignore") -> torch.Tensor:
    """3-D morphological gradient: dilate3d - erode3d."""
    return (dilate3d(vol, kernel_size, mode)
            - erode3d(vol, kernel_size, mode))


def top_hat3d(vol: torch.Tensor, kernel_size: int = 3,
              mode: str = "ignore") -> torch.Tensor:
    """3-D white top-hat: vol - open3d(vol)."""
    return vol.to(torch.float32) - morph_open3d(vol, kernel_size, mode)


def black_hat3d(vol: torch.Tensor, kernel_size: int = 3,
                mode: str = "ignore") -> torch.Tensor:
    """3-D black top-hat: close3d(vol) - vol."""
    return morph_close3d(vol, kernel_size, mode) - vol.to(torch.float32)


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 linear-interpolation matrix, align-corners:
    output sample i reads input coordinate i (n_in - 1) / (n_out - 1) (the
    centre for a single-sample axis); the reference's host matrix."""
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1:
        c = 0.5 * (n_in - 1)
        lo = int(np.floor(c))
        f = c - lo
        w[0, lo] = 1.0 - f
        if f > 0:
            w[0, lo + 1] = f
        return w
    coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(coords).astype(int), 0, max(n_in - 2, 0))
    f = (coords - lo).astype(np.float32)
    rows = np.arange(n_out)
    w[rows, lo] = 1.0 - f
    if n_in > 1:
        w[rows, lo + 1] += f
    return w


@functools.lru_cache(maxsize=32)
def _resize_taps(n_in: int, n_out: int, device: torch.device):
    """The two taps of each row of ``_linear_resize_matrix`` on
    ``device``: (lo, hi) input indices and their (w_lo, w_hi) weights, the
    matrix's own float32 entries (hi = lo and w_hi = 0 where a row has one
    tap). Kept: one host-to-device copy per shape pair."""
    m = _linear_resize_matrix(n_in, n_out)
    rows = np.arange(n_out)
    if n_out == 1:
        lo = np.full(1, int(np.floor(0.5 * (n_in - 1))))
    else:
        coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
        lo = np.clip(np.floor(coords).astype(int), 0, max(n_in - 2, 0))
    hi = np.minimum(lo + 1, n_in - 1)
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], np.float32(0.0)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (lo, hi, w_lo, w_hi))


def _lerp_rows(x: torch.Tensor, axis: int, taps, rows=slice(None),
               offset: int = 0) -> torch.Tensor:
    """Output rows ``rows`` of the linear resample along ``axis``: each
    ``x[lo] * w_lo + x[hi] * w_hi`` (two products, one add: the same
    float32 value wherever the row is computed), the input's rows
    ``offset`` onwards standing for the taps' index 0."""
    lo, hi, w_lo, w_hi = (t[rows] for t in taps)
    shape = [1] * x.dim()
    shape[axis] = -1
    return (x.index_select(axis, lo - offset) * w_lo.reshape(shape)
            + x.index_select(axis, hi - offset) * w_hi.reshape(shape))


def resample3d(vol: torch.Tensor, depth: int, height: int,
               width: int) -> torch.Tensor:
    """Trilinear resample of a [Z, H, W] volume to [depth, height, width]
    (align-corners coordinates; scipy.ndimage.map_coordinates(order=1) on
    that grid): z, then y, then x, each output row the two-tap lerp of
    the reference's host-built interpolation matrix (``_lerp_rows``); an
    axis of unchanged length skipped. The reference multiplies by the
    whole matrix, whose zero entries add nothing, so it differs only in
    how a library's product rounds the two taps' sum; the two-tap form
    rounds the same on any device and in any z band
    (``parallel.volume_shard.resample3d_zband``). Raw HU (int16) is cast to
    float32 first: resample, then window."""
    F.check_volume(vol, "resample3d")
    for name, v in (("depth", depth), ("height", height), ("width", width)):
        if int(v) < 1:
            raise ValueError(f"{name} must be >= 1")
    x = vol.to(torch.float32)
    for axis, n_out in enumerate((int(depth), int(height), int(width))):
        if x.shape[axis] != n_out:
            x = _lerp_rows(x, axis, _resize_taps(x.shape[axis], n_out,
                                                 x.device))
    return x


def difference_of_gaussians3d(
    vol: torch.Tensor, low_sigma: float = 1.0,
    high_sigma: float | None = None, truncate: float = 4.0,
    mode: str = "nearest",
) -> torch.Tensor:
    """Volumetric band-pass: ``gaussian3d(low) - gaussian3d(high)``,
    ``high_sigma`` 1.6 * ``low_sigma`` when omitted."""
    if high_sigma is None:
        high_sigma = float(low_sigma) * 1.6
    if high_sigma < low_sigma:
        raise ValueError(
            f"high_sigma ({high_sigma}) must be >= low_sigma ({low_sigma})"
        )
    x = vol.to(torch.float32)
    return (gaussian_blur3d(x, float(low_sigma), truncate, mode)
            - gaussian_blur3d(x, float(high_sigma), truncate, mode))


# ---------------------------------------------------------------------------
# The whole volume's statistics (the volume registry's forms of the 2-D ops)
# ---------------------------------------------------------------------------


def equalize_hist_volume(vol: torch.Tensor, nbins: int = NBINS) -> torch.Tensor:
    """Global histogram equalization with ONE histogram of the whole
    volume (skimage's equalize_hist on an n-d array); int64 counts, so
    exact past 2**24 voxels."""
    F.check_volume(vol, "equalize_hist (volume)")
    return H._equalize_hist(vol, nbins, 3)


def normalize_volume(vol: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Affine rescale of the whole volume's range to [0, 1]."""
    F.check_volume(vol, "normalize (volume)")
    return I._normalize_minmax(vol, eps, 3)


def rescale_intensity_volume(
    vol: torch.Tensor,
    in_range: tuple[float, float] | None = None,
    out_range: tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """skimage.exposure.rescale_intensity with the whole volume's (min,
    max) when ``in_range`` is None."""
    F.check_volume(vol, "rescale_intensity (volume)")
    return I._rescale_intensity(vol, in_range, out_range, 3)
