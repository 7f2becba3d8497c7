"""3-D CLAHE on the card: the kernels of ``csrc/clahe3d.cu`` and the
compositions of the volume conventions.

* opencv and fraction (``clahe3d_cuda``), in the TPU's own order
  (``mies_tpu.ops.volume3d.clahe3d``'s fast path): K1 (tile histograms,
  the Z slices as the batch) -> an int32 sum over each group of tz slices
  -> the LUT build in plain torch on the device -> K8 (trilinear apply,
  level quantize in the kernel, epilogue u8norm or clip01). On a z band
  of a z-sharded volume (``parallel.volume_shard.clahe3d_band``) the same
  up to the LUTs of the band's tiles, then K8z
  (``clahe3d_apply_lut_band``: K8 at the band's global z offset against
  the all-gathered LUT grid).
* skimage (``clahe3d_skimage_cuda``): the 14-bit scale-in, pad and binning
  in plain torch on the device -> K1 in bins mode over the region window of
  each padded slice, summed over each group of kz slices to the cubic
  regions' counts -> K6a (clip + redistribution + maps, k_elems = kz ky kx)
  -> the edge pad of the maps -> K8s (8-map blend + floor over the crop)
  -> the stretch over the volume in plain torch.

Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain version (``*_plain``, from ``ops.volume3d``) only for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.ops import filters as F
from mies_tpu_torch.ops import histogram as H
from mies_tpu_torch.ops import volume3d as V

NBINS = H.NBINS
MAX_GRID_DIM = 65535  # K8 puts its y and z cells on grid y and z, K8s
MAX_GRID_X = 2**31 - 1  # its y and z region blocks: Z is no grid dimension
THREADS = 256  # csrc/clahe3d.cu kThreads
# about a K8 block's share of a cell: 16,384 ran faster than 8,192 and
# 32,768 at [256, 512, 512] on an H100 (PERF.md); K8s takes K6's
# (kernels.clahe.SK_PIXELS_PER_BLOCK)
PIXELS_PER_BLOCK = 16384


# --- K8: trilinear LUT apply ------------------------------------------------


def apply_launch(shape, grid, aligned: bool) -> tuple[int, int, int]:
    """K8's blocks: (rows per block, strips per cell, column chunks per
    cell). A block owns up to ``rpb`` of its cell's (slice, row) pairs and
    up to THREADS of its column units (four columns each on 16-byte aligned
    rows, else one). A cell spans at most t + 1 positions of an axis (the
    f32 weights may move an edge by one), so ``strips`` covers (tz + 1)
    (th + 1) pairs and the chunks (tw + 1) columns; the kernel finds each
    cell's own edges by the blend's formula and leaves the rest of its
    blocks idle. The grid is ((gx + 1) col_splits strips, gy + 1, gz + 1)."""
    (gz, gy, gx), (tz, th, tw) = grid, V.tile_shape_3d(shape, grid)
    rpb = max(1, PIXELS_PER_BLOCK // (tw + 1))
    strips = -(-((tz + 1) * (th + 1)) // rpb)
    col_splits = -(-KC.max_units(tw + 1, aligned) // THREADS)
    if (gx + 1) * col_splits * strips > MAX_GRID_X or max(gy, gz) + 1 > \
            MAX_GRID_DIM or (tz + 1) * (th + 1) > MAX_GRID_X:
        raise ValueError(f"clahe3d_apply_lut: volume {tuple(shape)} at grid "
                         f"{tuple(grid)} exceeds the kernel's launch grid")
    return rpb, strips, col_splits


def clahe3d_apply_lut_plain(x: torch.Tensor, luts: torch.Tensor, grid,
                            finalize: str = "u8norm") -> torch.Tensor:
    """Plain version of K8: the gather form + the epilogue."""
    res = V._apply_luts_trilinear_gather(H._levels(x), luts, tuple(grid))
    return V.finalize_3d(res, finalize)


def clahe3d_apply_lut(x: torch.Tensor, luts: torch.Tensor, grid,
                      finalize: str = "u8norm") -> torch.Tensor:
    """K8: OpenCV trilinear LUT interpolation at each voxel's uint8 level,
    finalized as clip(rint(v), 0, 255) / 255 ("u8norm", integer LUTs) or
    clip(v, 0, 1) ("clip01", the fraction convention's LUTs).

    x: [Z, H, W] float32 in [0, 1], divisible by grid (gz, gy, gx); luts:
    [gz, gy, gx, 256] float32; both contiguous. Returns [Z, H, W] float32."""
    if _build.exporting():
        return torch.ops.mies.clahe3d_apply_lut(x, luts, list(grid), finalize)
    _build.check_tensor(x, "clahe3d_apply_lut: x")
    _build.check_tensor(luts, "clahe3d_apply_lut: luts", ndim=4)
    if finalize not in KC._FINALIZE:
        raise ValueError(f"finalize must be one of {sorted(KC._FINALIZE)}, "
                         f"got {finalize!r}")
    grid = tuple(int(g) for g in grid)
    tz, th, tw = V.tile_shape_3d(x.shape, grid)
    if tuple(luts.shape) != (*grid, NBINS):
        raise ValueError(f"luts: expected {(*grid, NBINS)}, got "
                         f"{tuple(luts.shape)}")
    KC._same_device(luts, x, "luts")
    if x.device.type == "cpu":
        return clahe3d_apply_lut_plain(x, luts, grid, finalize)
    out = torch.empty_like(x)
    aligned = (x.data_ptr() | out.data_ptr()) % 16 == 0 and x.shape[2] % 4 == 0
    launch = apply_launch(x.shape, grid, aligned)
    inv = [float(np.float32(1.0) / np.float32(t)) for t in (tz, th, tw)]
    _build.launch("clahe3d_apply", "mies_clahe3d_apply", x.device,
                  x.data_ptr(), luts.data_ptr(), out.data_ptr(), *x.shape,
                  *grid, tz, th, tw, *inv, *launch, int(aligned),
                  KC._FINALIZE[finalize])
    return out


# --- K8z: K8 on a z band at its global offset ---------------------------------


def _cell_of(p: int, inv: np.float32) -> int:
    """The interpolation cell of position p: floor(p * inv - 0.5) in
    float32, csrc/cells.cuh cell_of's correctly rounded arithmetic."""
    return int(np.floor(np.float32(p) * inv - np.float32(0.5)))


def band_launch(z_total: int, z0: int, zb: int, hw, grid, aligned: bool
                ) -> tuple[int, int, int, int, int]:
    """K8z's blocks: (first z cell, z cells, rows per block, strips per
    cell, column chunks per cell). The z cells are those that meet the
    band's global slices [z0, z0 + zb) (the cells of its first and last
    slice and those between); the rest is K8's ``apply_launch`` of the
    whole volume's tiles."""
    tz = z_total // grid[0]
    inv = np.float32(1.0) / np.float32(tz)
    cz0 = max(_cell_of(z0, inv), -1)
    ncz = _cell_of(z0 + zb - 1, inv) - cz0 + 1
    return (cz0, ncz, *apply_launch((z_total, *hw), grid, aligned))


def check_band(shape, grid, z_total: int, z0: int) -> tuple[int, int, int]:
    """The tile (tz, th, tw) of a band [zb, H, W] at global slice ``z0`` of
    a volume of ``z_total`` slices tiled by ``grid``; raises unless the band
    is whole tiles of it."""
    zb, h, w = shape
    tz, th, tw = V.tile_shape_3d((z_total, h, w), grid)
    if zb < 1 or zb % tz or z0 < 0 or z0 % tz or z0 + zb > z_total:
        raise ValueError(
            f"band of {zb} slices at z {z0} is not whole z tiles of "
            f"{tz} slices within {z_total}"
        )
    return tz, th, tw


def clahe3d_apply_lut_band_plain(band: torch.Tensor, luts: torch.Tensor,
                                 grid, z_total: int, z0: int,
                                 finalize: str = "u8norm") -> torch.Tensor:
    """Plain version of K8z: the gather form at the band's global z (the
    reference's ``_trilinear_zband_gather``) + the epilogue."""
    res = V._apply_luts_trilinear_gather(H._levels(band), luts, tuple(grid),
                                         z_total, z0)
    return V.finalize_3d(res, finalize)


def clahe3d_apply_lut_band(band: torch.Tensor, luts: torch.Tensor, grid,
                           z_total: int, z0: int,
                           finalize: str = "u8norm") -> torch.Tensor:
    """K8z: K8's blend and epilogue on a tile-aligned z band whose first
    slice is global slice ``z0`` of a volume of ``z_total`` slices tiled by
    ``grid``; the z weights are taken at the global slices.

    band: [zb, H, W] float32 in [0, 1]; luts: [gz, gy, gx, 256] float32,
    the whole volume's grid; both contiguous. Returns [zb, H, W] float32."""
    if _build.exporting():
        return torch.ops.mies.clahe3d_apply_lut_band(
            band, luts, list(grid), int(z_total), int(z0), finalize)
    _build.check_tensor(band, "clahe3d_apply_lut_band: band")
    _build.check_tensor(luts, "clahe3d_apply_lut_band: luts", ndim=4)
    if finalize not in KC._FINALIZE:
        raise ValueError(f"finalize must be one of {sorted(KC._FINALIZE)}, "
                         f"got {finalize!r}")
    grid = tuple(int(g) for g in grid)
    z_total, z0 = int(z_total), int(z0)
    tz, th, tw = check_band(band.shape, grid, z_total, z0)
    if tuple(luts.shape) != (*grid, NBINS):
        raise ValueError(f"luts: expected {(*grid, NBINS)}, got "
                         f"{tuple(luts.shape)}")
    KC._same_device(luts, band, "luts")
    if band.device.type == "cpu":
        return clahe3d_apply_lut_band_plain(band, luts, grid, z_total, z0,
                                            finalize)
    out = torch.empty_like(band)
    aligned = (band.data_ptr() | out.data_ptr()) % 16 == 0 and \
        band.shape[2] % 4 == 0
    launch = band_launch(z_total, z0, band.shape[0], band.shape[1:], grid,
                         aligned)
    inv = [float(np.float32(1.0) / np.float32(t)) for t in (tz, th, tw)]
    _build.launch("clahe3d_apply_band", "mies_clahe3d_apply_band",
                  band.device, band.data_ptr(), luts.data_ptr(),
                  out.data_ptr(), *band.shape, *grid, tz, th, tw, *inv, z0,
                  *launch, int(aligned), KC._FINALIZE[finalize])
    return out


def clahe3d_cuda(vol: torch.Tensor, clip_limit: float = 2.0,
                 grid_size=(4, 8, 8), convention: str = "opencv"
                 ) -> torch.Tensor:
    """opencv- or fraction-convention 3-D CLAHE of a [Z, H, W] float32
    volume: K1 over the slices -> per-z-tile int32 sums -> LUT build in
    plain torch -> K8. Same numbers as ops.volume3d.clahe3d."""
    if convention not in ("opencv", "fraction"):
        raise ValueError(f"clahe3d_cuda runs 'opencv' and 'fraction', not "
                         f"{convention!r}")
    grid = tuple(int(g) for g in grid_size)
    gz, gy, gx = grid
    tz, th, tw = V.tile_shape_3d(vol.shape, grid)
    hists = KC.tile_hists(vol, (gy, gx))  # [Z, gy, gx, 256]
    hists = hists.reshape(gz, tz, gy * gx, NBINS).sum(1, dtype=torch.int32)
    luts = V.luts_3d(hists.to(torch.float32), clip_limit, tz * th * tw,
                     convention)
    finalize = "u8norm" if convention == "opencv" else "clip01"
    return clahe3d_apply_lut(vol, luts.reshape(*grid, NBINS), grid, finalize)


# --- K8s: skimage 8-map blend -----------------------------------------------


def clahe3d_skimage_apply_plain(binned: torch.Tensor, map_array: torch.Tensor,
                                kernel_size, origin, out_shape
                                ) -> torch.Tensor:
    """Plain version of K8s."""
    return V._apply_maps_3d(binned, map_array, tuple(kernel_size),
                            tuple(origin), tuple(out_shape))


def skimage_launch(kernel_size, origin, out_shape, aligned: bool
                   ) -> tuple[int, int, int, int, int, int]:
    """K8s's blocks: (nbx, nby, nbz, rows per block, strips, column
    chunks). A block owns up to ``rpb`` (slice, row) pairs of one region
    block, cut to the crop (``kernels.clahe.region_span`` per axis), and up
    to THREADS of its column units; the grid is (nbx strips col_splits,
    nby, nbz), so any Z launches whose region blocks fit a grid axis."""
    (_, nz, ez), (_, ny, ey), (_, nx, ex) = (
        KC.region_span(o, n, k) for o, n, k in zip(origin, out_shape,
                                                    kernel_size))
    rpb = max(1, KC.SK_PIXELS_PER_BLOCK // ex)
    strips = -(-(ez * ey) // rpb)
    col_splits = -(-KC.max_units(ex, aligned) // THREADS)
    if nx * strips * col_splits > MAX_GRID_X or max(ny, nz) > MAX_GRID_DIM:
        raise ValueError(f"clahe3d_skimage_apply: crop {tuple(out_shape)} at "
                         f"regions {tuple(kernel_size)} exceeds the kernel's "
                         f"launch grid")
    return nx, ny, nz, rpb, strips, col_splits


def clahe3d_skimage_apply(binned: torch.Tensor, map_array: torch.Tensor,
                          kernel_size, origin, out_shape) -> torch.Tensor:
    """K8s: skimage's trilinear blend of the 8 neighbouring region maps,
    floored, at the voxels of the ``out_shape`` crop whose first corner is
    ``origin`` of the padded binned volume.

    binned: [Zp, Hp, Wp] int32 bins in [0, nbins); map_array: [nz + 1,
    ny + 1, nx + 1, nbins] float32, the edge-padded integer-valued maps
    (block b of an axis reads its corners b and b + 1); both contiguous.
    Returns [Z0, H0, W0] float32."""
    if _build.exporting():
        return torch.ops.mies.clahe3d_skimage_apply(
            binned, map_array, list(kernel_size), list(origin),
            list(out_shape))
    _build.check_tensor(binned, "clahe3d_skimage_apply: binned",
                        dtype=torch.int32)
    _build.check_tensor(map_array, "clahe3d_skimage_apply: map_array", ndim=4)
    KC._same_device(map_array, binned, "map_array")
    ks = tuple(int(k) for k in kernel_size)
    origin, out_shape = tuple(origin), tuple(out_shape)
    nz1, ny1, nx1, nbins = map_array.shape
    if min(ks) < 1 or min(out_shape) < 1 or min(origin) < 0 or any(
            o + n > s for o, n, s in zip(origin, out_shape, binned.shape)):
        raise ValueError(
            f"clahe3d_skimage_apply: crop {out_shape} at {origin} of "
            f"{tuple(binned.shape)} with regions {ks}"
        )
    if any((o + n - 1) // k + 1 >= m for o, n, k, m in
           zip(origin, out_shape, ks, (nz1, ny1, nx1))):
        raise ValueError(
            f"clahe3d_skimage_apply: map_array {tuple(map_array.shape)} does "
            f"not cover the crop {out_shape} at {origin} with regions {ks}"
        )
    if binned.device.type == "cpu":
        return clahe3d_skimage_apply_plain(binned, map_array, ks, origin,
                                           out_shape)
    KC._check_nbins(nbins)
    out = torch.empty(out_shape, dtype=torch.float32, device=binned.device)
    aligned = KC._vec_ok(binned, out, origin[2])
    launch = skimage_launch(ks, origin, out_shape, aligned)
    _build.launch("clahe3d_skimage_apply", "mies_clahe3d_skimage_apply",
                  binned.device, binned.data_ptr(), map_array.data_ptr(),
                  out.data_ptr(), binned.shape[1], binned.shape[2], ny1, nx1,
                  *ks, nbins, *origin, *out_shape, *launch, int(aligned))
    return out


def clahe3d_skimage_cuda(vol: torch.Tensor, kernel_size,
                         clip_limit: float = 0.01, nbins: int = NBINS
                         ) -> torch.Tensor:
    """skimage-convention 3-D CLAHE of a [Z, H, W] float32 volume with
    cubic regions of ``kernel_size``: plain scale-in and binning -> K1
    bins per slice, summed per kz slices -> K6a -> edge pad -> K8s ->
    plain stretch. Same numbers as ops.volume3d.clahe3d(convention=
    "skimage")."""
    _build.check_tensor(vol, "clahe3d_skimage: vol")
    KC._check_nbins(nbins)
    ks = tuple(int(k) for k in kernel_size)
    kz, ky, kx = ks
    pad0, _, ns = V.skimage3d_geometry(vol.shape, ks)
    binned = V._skimage3d_binned(vol, ks, nbins)
    k_elems = kz * ky * kx
    clim = int(np.clip(clip_limit * k_elems, 1, None))
    # the region slices of the padded volume: a contiguous run of slices
    slab = binned[pad0[0]:pad0[0] + ns[0] * kz]
    hists = KC.tile_hists_bins(slab, pad0[1:], ns[1:], (ky, kx), nbins)
    hists = hists.reshape(ns[0], kz, ns[1], ns[2], nbins).sum(
        1, dtype=torch.int32)
    maps = KC.skimage_maps(hists, clim, k_elems)
    result = clahe3d_skimage_apply(binned, V._edge_pad_maps(maps), ks, pad0,
                                   vol.shape)
    return V._skimage3d_stretch_out(result)


def clahe3d_volume(vol: torch.Tensor, clip_limit: float = 2.0,
                   grid_size=(4, 8, 8), convention: str = "opencv",
                   kernel_size=None) -> torch.Tensor:
    """The volume pipeline's clahe3d. For a CUDA tensor: opencv and
    fraction through K1 / K8, skimage through K1 bins / K6a / K8s. For a
    CPU tensor: ``ops.volume3d.clahe3d``, but while ``torch.export`` traces,
    through the kernels' ``mies`` ops (their plain versions on the CPU)."""
    if vol.device.type != "cuda" and not _build.exporting():
        return V.clahe3d(vol, clip_limit, grid_size, convention, kernel_size)
    F.check_volume(vol, "clahe3d")
    if convention not in V.CONVENTIONS_3D:
        raise ValueError(f"unknown CLAHE convention: {convention!r}")
    x = vol.to(torch.float32).contiguous()
    if convention == "skimage":
        ks = V.skimage3d_kernel_size(x.shape, grid_size, kernel_size)
        return clahe3d_skimage_cuda(x, ks, clip_limit)
    return clahe3d_cuda(x, clip_limit, grid_size, convention)


# --- the custom ops, for torch.export (kernels._build.register_op) ----------

# operations per voxel: K8 the level (4), three axis fractions (5 each),
# seven lerps (4 each) and the epilogue (u8norm 4, clip01 2); K8s three
# weights (3 each), 8 coefficients (2 each), 8 multiplies, 7 adds, the floor
APPLY3D_OPS = {"u8norm": 51, "clip01": 49}

_build.register_op(
    "clahe3d_apply_lut", clahe3d_apply_lut,
    "(Tensor x, Tensor luts, int[] grid, str finalize) -> Tensor",
    lambda x, *_: torch.empty_like(x),
    lambda x, luts, grid, finalize: APPLY3D_OPS[finalize] * x.numel())
_build.register_op(
    "clahe3d_apply_lut_band", clahe3d_apply_lut_band,
    "(Tensor band, Tensor luts, int[] grid, int z_total, int z0, "
    "str finalize) -> Tensor", lambda band, *_: torch.empty_like(band),
    lambda band, *args: APPLY3D_OPS[args[-1]] * band.numel())
_build.register_op(
    "clahe3d_skimage_apply", clahe3d_skimage_apply,
    "(Tensor binned, Tensor map_array, int[] kernel_size, int[] origin, "
    "int[] out_shape) -> Tensor",
    lambda binned, m, ks, origin, out_shape: binned.new_empty(
        out_shape, dtype=torch.float32),
    lambda binned, m, ks, origin, out_shape: 41 * int(np.prod(out_shape)))
