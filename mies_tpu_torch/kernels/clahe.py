"""CLAHE on the card: the kernels of ``csrc/clahe.cu`` and
``csrc/clahe_skimage.cu`` and the compositions of the four conventions.

* opencv (``clahe_cuda``): K1 counting the tiles and ending in their
  OpenCV LUTs (``tile_luts``: the clip, redistribution, cdf and rint that
  ``mies_tpu.kernels.clahe.clahe_tpu`` leaves to XLA) -> K2 (LUT apply,
  epilogue u8norm). fraction: K1 (tile histograms) -> the small LUT build
  in plain torch on the device -> K2 (epilogue clip01). K5
  (``clahe_apply_lut_band``) is K2 on one row band of a row-sharded slice
  (``parallel.clahe_shard``).
* skimage (``clahe_skimage_cuda``, after ``clahe_skimage_tpu``): the 14-bit
  scale-in, pad and binning in plain torch on the device -> K1 in bins
  mode (region histograms over the crop of the padded binned image) ->
  K6a (clip + redistribution + map build) -> K6 (map blend) -> the
  per-image stretch in plain torch.
* kornia has no kernel here, as it has none in the JAX package: it runs
  its plain torch on the device.

Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain version (``*_plain``, from ``ops.histogram``) only for a CPU tensor.
Any image shape runs: a ragged image's OpenCV bottom/right reflect-101 pad
(cv2's rule for opencv: both axes gain ``g - n % g`` when either is ragged;
the JAX package's ``(g - n % g) % g`` for fraction) is resolved inside K1,
and K2 and K6 write only the unpadded pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import histogram as H

NBINS = H.NBINS
MAX_BINS = 1024  # K6a's warp holds a region's bins, at most 32 a lane
THREADS = 256  # csrc/clahe_skimage.cu kThreads (K6)
# about a K6 or K8s block's share of an interpolation block, as K1 and K2
# take: 8,192 ran faster than 16,384 for K8s and no slower for K6 on an
# H100 (PERF.md)
SK_PIXELS_PER_BLOCK = 8192
MAX_GRID_X, MAX_GRID_YZ = 2**31 - 1, 65535
_FINALIZE = {"u8norm": 0, "clip01": 1}
EPILOGUE = {"opencv": "u8norm", "fraction": "clip01"}  # K2's, by convention


def _tile_shape(shape, grid_size, convention: str) -> tuple[int, int]:
    """(th, tw) of the image padded up to a multiple of the grid by the
    convention's rule (``ops.histogram.grid_pads``). The pad is resolved
    by index in K1 at any length, as cv2 does (more than one reflect-101
    bounce on an image shorter than its pad)."""
    gy, gx = grid_size
    if gy < 1 or gx < 1:
        raise ValueError(f"grid_size must be >= 1, got {grid_size}")
    h, w = shape
    ph, pw = H.grid_pads((h, w), (gy, gx), convention)
    return (h + ph) // gy, (w + pw) // gx


def _check_nbins(nbins: int) -> None:
    if not 2 <= nbins <= MAX_BINS:
        raise ValueError(
            f"nbins={nbins}: the skimage kernels take 2..{MAX_BINS} bins "
            f"(K6a holds at most 32 bins a lane of a warp)"
        )


def _same_device(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.device != b.device:
        raise ValueError(f"{what} on {a.device}, expected {b.device}")


# --- K1: tile histograms ----------------------------------------------------


def tile_hists_plain(x: torch.Tensor, grid_size,
                     convention: str = "opencv") -> torch.Tensor:
    """Plain version of K1: [B, H, W] f32 -> [B, gy, gx, 256] int32."""
    gy, gx = grid_size
    u8, _, _ = H._pad_reflect101(H._levels(x), (gy, gx), convention)
    counts = H._tile_histograms(u8, (gy, gx))
    return counts.reshape(x.shape[0], gy, gx, NBINS).to(torch.int32)


def tile_hists(x: torch.Tensor, grid_size,
               convention: str = "opencv") -> torch.Tensor:
    """K1: per-tile 256-bin counts of the uint8 levels of x.

    x: [B, H, W] float32 in [0, 1], contiguous. Returns [B, gy, gx, 256]
    int32 exact counts over the tiles of x padded (reflect-101) by the
    ``convention``'s rule (opencv or fraction)."""
    if _build.exporting():
        return torch.ops.mies.tile_hists(x, list(grid_size), convention)
    _build.check_tensor(x, "tile_hists: x")
    gy, gx = grid_size
    B, h, w = x.shape
    th, tw = _tile_shape((h, w), (gy, gx), convention)
    if x.device.type == "cpu":
        return tile_hists_plain(x, (gy, gx), convention)
    out = torch.empty((B, gy, gx, NBINS), dtype=torch.int32, device=x.device)
    _build.launch("tile_hists", "mies_tile_hists", x.device,
                  x.data_ptr(), out.data_ptr(), B, h, w, gy, gx, th, tw)
    return out


def tile_luts_plain(x: torch.Tensor, grid_size, clip_limit: float,
                    convention: str = "opencv") -> torch.Tensor:
    """Plain version of ``tile_luts``: the convention's LUT build
    (``ops.histogram._luts_opencv`` or ``_luts_fraction``) of K1's counts."""
    gy, gx = grid_size
    th, tw = _tile_shape(x.shape[-2:], (gy, gx), convention)
    counts = tile_hists_plain(x, (gy, gx), convention).reshape(
        x.shape[0], gy * gx, NBINS).to(torch.float32)
    build = H._luts_opencv if convention == "opencv" else H._luts_fraction
    return build(counts, clip_limit, th * tw).reshape(x.shape[0], gy, gx, NBINS)


def tile_luts(x: torch.Tensor, grid_size, clip_limit: float,
              convention: str = "opencv") -> torch.Tensor:
    """The tiles' LUTs of the opencv or fraction CLAHE of x, in the layout
    K2 and K5 read: [B, gy, gx, 256] float32, the tiles of x padded by the
    ``convention``'s rule.

    opencv: K1 ending in the LUTs, one launch: the per-tile 256-bin counts
    of x's uint8 levels, then OpenCV's integer clip at max(int(clip_limit *
    tile_area / 256), 1), the redistribution, the cdf and clip(rint(cdf *
    f32(255 / tile_area)), 0, 255); exact while a tile has fewer than
    2**24 pixels (the f32 integers of the reference): on the card larger
    tiles raise, on the CPU the plain build takes them.
    fraction: K1's counts (``tile_hists``), then the plain float clip and
    cdf / tile_area (``ops.histogram._luts_fraction``), whose float sums a
    kernel would not add in torch's order.

    x: [B, H, W] float32 in [0, 1], contiguous."""
    if _build.exporting():
        return torch.ops.mies.tile_luts(x, list(grid_size), float(clip_limit),
                                        convention)
    if convention not in ("opencv", "fraction"):
        raise ValueError(f"tile_luts builds opencv or fraction LUTs, not "
                         f"{convention!r}")
    _build.check_tensor(x, "tile_luts: x")
    gy, gx = grid_size
    B, h, w = x.shape
    th, tw = _tile_shape((h, w), (gy, gx), convention)
    if convention == "fraction":
        counts = tile_hists(x, (gy, gx), convention).reshape(B, gy * gx, NBINS)
        return H._luts_fraction(counts.to(torch.float32), clip_limit,
                                th * tw).reshape(B, gy, gx, NBINS)
    if x.device.type == "cpu":
        return tile_luts_plain(x, (gy, gx), clip_limit)
    if th * tw >= 2**24:
        raise ValueError(f"tile_luts: tiles of {th}x{tw} pixels reach 2**24, "
                         f"where the kernel's f32 counts stop being exact")
    out = torch.empty((B, gy, gx, NBINS), dtype=torch.float32, device=x.device)
    # counts and arrival counters of tiles split over several blocks
    scratch = torch.empty(B * gy * gx * (NBINS + 1), dtype=torch.int32,
                          device=x.device)
    clip = max(int(clip_limit * th * tw / NBINS), 1)
    lut_scale = float(np.float32(NBINS - 1) / np.float32(th * tw))
    _build.launch("tile_luts", "mies_tile_luts_opencv", x.device,
                  x.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, h, w,
                  gy, gx, th, tw, clip, lut_scale)
    return out


def tile_hists_bins_plain(bins: torch.Tensor, origin, grid_size, tile,
                          nbins: int) -> torch.Tensor:
    """Plain version of K1's bins mode: counts of the window of ``bins``."""
    (y0, x0), (gy, gx), (th, tw) = origin, grid_size, tile
    win = bins[:, y0:y0 + gy * th, x0:x0 + gx * tw]
    counts = H._tile_histograms(win, (gy, gx), nbins)
    return counts.reshape(bins.shape[0], gy, gx, nbins).to(torch.int32)


def tile_hists_bins(bins: torch.Tensor, origin, grid_size, tile,
                    nbins: int) -> torch.Tensor:
    """K1, bins mode: ``nbins``-bin counts of int32 bin indices over the
    gy x gx regions of th x tw pixels whose grid starts at ``origin``
    (row, column) of each slice, read in place.

    bins: [B, H, W] int32 in [0, nbins), contiguous. Returns
    [B, gy, gx, nbins] int32."""
    if _build.exporting():
        return torch.ops.mies.tile_hists_bins(bins, list(origin),
                                              list(grid_size), list(tile),
                                              int(nbins))
    _build.check_tensor(bins, "tile_hists_bins: bins", dtype=torch.int32)
    _check_nbins(nbins)
    (y0, x0), (gy, gx), (th, tw) = origin, grid_size, tile
    B, h, w = bins.shape
    if min(y0, x0) < 0 or min(gy, gx, th, tw) < 1 or \
            y0 + gy * th > h or x0 + gx * tw > w:
        raise ValueError(
            f"window at {tuple(origin)} of {gy}x{gx} regions of {th}x{tw} "
            f"does not fit a {h}x{w} slice"
        )
    if bins.device.type == "cpu":
        return tile_hists_bins_plain(bins, origin, grid_size, tile, nbins)
    out = torch.empty((B, gy, gx, nbins), dtype=torch.int32, device=bins.device)
    _build.launch("tile_hists_bins", "mies_tile_hists_bins", bins.device,
                  bins.data_ptr(), out.data_ptr(), B, h, w, y0, x0, gy, gx,
                  th, tw, nbins)
    return out


# --- K2: LUT apply ----------------------------------------------------------


def clahe_apply_lut_plain(x: torch.Tensor, luts: torch.Tensor, grid_size,
                          finalize: str = "u8norm",
                          convention: str = "opencv") -> torch.Tensor:
    """Plain version of K2: bilinear LUT blend + the epilogue."""
    return clahe_apply_lut_band_plain(
        x, luts, grid_size, _tile_shape(x.shape[-2:], grid_size, convention),
        0, finalize)


def clahe_apply_lut(x: torch.Tensor, luts: torch.Tensor, grid_size,
                    finalize: str = "u8norm",
                    convention: str = "opencv") -> torch.Tensor:
    """K2: OpenCV bilinear LUT interpolation at each pixel's uint8 level,
    finalized as clip(rint(v), 0, 255) / 255 ("u8norm", integer LUTs) or
    clip(v, 0, 1) ("clip01", the fraction convention's LUTs), with the
    tiles of ``convention``'s pad rule (as K1's).

    x: [B, H, W] float32 in [0, 1]; luts: [B, gy, gx, 256] float32, both
    contiguous. Returns [B, H, W] float32."""
    if _build.exporting():
        return torch.ops.mies.clahe_apply_lut(x, luts, list(grid_size),
                                              finalize, convention)
    _build.check_tensor(x, "clahe_apply_lut: x")
    _build.check_tensor(luts, "clahe_apply_lut: luts", ndim=4)
    if finalize not in _FINALIZE:
        raise ValueError(f"finalize must be one of {sorted(_FINALIZE)}, "
                         f"got {finalize!r}")
    gy, gx = grid_size
    B, h, w = x.shape
    if tuple(luts.shape) != (B, gy, gx, NBINS):
        raise ValueError(f"luts: expected {(B, gy, gx, NBINS)}, got "
                         f"{tuple(luts.shape)}")
    _same_device(luts, x, "luts")
    th, tw = _tile_shape((h, w), (gy, gx), convention)
    if x.device.type == "cpu":
        return clahe_apply_lut_plain(x, luts, (gy, gx), finalize, convention)
    out = torch.empty_like(x)
    inv_th = float(np.float32(1.0) / np.float32(th))
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    _build.launch("clahe_apply_lut", "mies_apply_lut", x.device,
                  x.data_ptr(), luts.data_ptr(), out.data_ptr(),
                  B, h, w, gy, gx, th, tw, inv_th, inv_tw,
                  _FINALIZE[finalize])
    return out


# --- K5: LUT apply on a row band of a row-sharded slice ---------------------


def _check_band(band_shape, grid_size, tile_shape, y_offset) -> None:
    """The tile-aligned band contract of ``parallel.clahe_shard``: whole
    tile rows of th, starting at a global row that is a multiple of th,
    inside the grid, and the slice's full width of gx tiles of tw."""
    (hb, w), (gy, gx), (th, tw) = band_shape, grid_size, tile_shape
    if min(th, tw) < 1 or hb % th or y_offset % th or y_offset < 0 \
            or y_offset + hb > gy * th or w != gx * tw:
        raise ValueError(
            f"band {tuple(band_shape)} at row {y_offset} is not tile-aligned "
            f"for grid {tuple(grid_size)} of {th}x{tw} tiles"
        )


def clahe_apply_lut_band_plain(band: torch.Tensor, luts: torch.Tensor,
                               grid_size, tile_shape, y_offset: int,
                               finalize: str = "u8norm") -> torch.Tensor:
    """Plain version of K5: the bilinear LUT blend at the band's global
    rows, then K2's epilogue."""
    res = H._bilinear_lut_apply(H._levels(band), luts, tuple(grid_size),
                                tile_shape=tuple(tile_shape),
                                y_offset=y_offset)
    if finalize == "u8norm":
        return H._u8norm(res)
    return torch.clamp(res, 0.0, 1.0)


def clahe_apply_lut_band(band: torch.Tensor, luts: torch.Tensor, grid_size,
                         tile_shape, y_offset: int,
                         finalize: str = "u8norm") -> torch.Tensor:
    """K5: K2's blend and epilogue on a tile-aligned row band whose first
    row is global row ``y_offset`` of a slice tiled by ``grid_size`` tiles
    of ``tile_shape``; the fractions are taken at the global rows.

    band: [B, hb, W] float32 in [0, 1]; luts: [B, gy, gx, 256] float32,
    the whole slice's grid; both contiguous. Returns [B, hb, W] float32."""
    if _build.exporting():
        return torch.ops.mies.clahe_apply_lut_band(
            band, luts, list(grid_size), list(tile_shape), int(y_offset),
            finalize)
    _build.check_tensor(band, "clahe_apply_lut_band: band")
    _build.check_tensor(luts, "clahe_apply_lut_band: luts", ndim=4)
    if finalize not in _FINALIZE:
        raise ValueError(f"finalize must be one of {sorted(_FINALIZE)}, "
                         f"got {finalize!r}")
    (gy, gx), (th, tw) = grid_size, tile_shape
    B, hb, w = band.shape
    if tuple(luts.shape) != (B, gy, gx, NBINS):
        raise ValueError(f"luts: expected {(B, gy, gx, NBINS)}, got "
                         f"{tuple(luts.shape)}")
    _same_device(luts, band, "luts")
    y_offset = int(y_offset)
    _check_band((hb, w), (gy, gx), (th, tw), y_offset)
    if band.device.type == "cpu":
        return clahe_apply_lut_band_plain(band, luts, (gy, gx), (th, tw),
                                          y_offset, finalize)
    out = torch.empty_like(band)
    inv_th = float(np.float32(1.0) / np.float32(th))
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    _build.launch("clahe_apply_lut_band", "mies_apply_lut_band", band.device,
                  band.data_ptr(), luts.data_ptr(), out.data_ptr(),
                  B, hb, w, gy, gx, th, tw, inv_th, inv_tw, y_offset,
                  _FINALIZE[finalize])
    return out


# --- K6a and K6: the skimage map build and blend ----------------------------


def skimage_maps_plain(hists: torch.Tensor, clim: int, k_elems: int
                       ) -> torch.Tensor:
    """Plain version of K6a: skimage clip + redistribution, then maps."""
    clipped = H._clip_histogram_skimage(hists, clim, hists.shape[-1])
    return H._skimage_maps(clipped, k_elems)


def skimage_maps(hists: torch.Tensor, clim: int, k_elems: int) -> torch.Tensor:
    """K6a: region maps from integer region histograms.

    hists: [B, nr, nc, nbins] int32 counts, contiguous; clim: the integer
    clip limit; k_elems: pixels per region. Returns float32 maps of the
    same shape, floor(min(cumsum(clipped) * f32(16383 / k_elems), 16383))."""
    if _build.exporting():
        return torch.ops.mies.skimage_maps(hists, int(clim), int(k_elems))
    _build.check_tensor(hists, "skimage_maps: hists", ndim=4, dtype=torch.int32)
    nbins = hists.shape[-1]
    _check_nbins(nbins)
    if hists.device.type == "cpu":
        return skimage_maps_plain(hists, clim, k_elems)
    out = torch.empty(hists.shape, dtype=torch.float32, device=hists.device)
    scale = float(np.float32((H.NR_OF_GRAY - 1) / k_elems))
    _build.launch("skimage_maps", "mies_skimage_maps", hists.device,
                  hists.data_ptr(), out.data_ptr(), hists.numel() // nbins,
                  nbins, int(clim), scale)
    return out


def skimage_apply_plain(binned: torch.Tensor, maps: torch.Tensor,
                        kernel_size, origin, out_shape) -> torch.Tensor:
    """Plain version of K6."""
    return H._skimage_apply(binned, maps, tuple(kernel_size), tuple(origin),
                            tuple(out_shape))


def region_span(origin: int, n: int, k: int) -> tuple[int, int, int]:
    """skimage's interpolation blocks of an axis (block b holds the padded
    positions [b k, (b + 1) k)) that meet the crop [origin, origin + n):
    the first one, their count, and the most crop positions one holds."""
    b0, b1 = origin // k, (origin + n - 1) // k
    if b0 == b1:
        return b0, 1, n
    ends = ((b0 + 1) * k - origin, origin + n - b1 * k)
    return b0, b1 - b0 + 1, max(*ends, k if b1 - b0 > 1 else 0)


def max_units(extent: int, aligned: bool) -> int:
    """The most column units of a row segment of ``extent`` columns
    (csrc/cells.cuh Units): a scalar head and tail of at most 3 columns
    each around units of 4 on aligned rows, else one column a unit."""
    return extent // 4 + 6 if aligned else extent


def skimage_launch(batch: int, kernel_size, origin, out_shape,
                   aligned: bool) -> tuple[int, int, int, int, int]:
    """K6's blocks: (nbx, nby, rows per block, strips, column chunks). A
    block owns up to ``rpb`` rows of one interpolation block of a slice,
    cut to the crop, and up to THREADS of its column units; the grid is
    (nbx strips col_splits, nby, batch)."""
    (kr, kc), (y0, x0), (h0, w0) = kernel_size, origin, out_shape
    _, nby, ext_y = region_span(y0, h0, kr)
    _, nbx, ext_x = region_span(x0, w0, kc)
    rpb = max(1, SK_PIXELS_PER_BLOCK // ext_x)
    strips = -(-ext_y // rpb)
    col_splits = -(-max_units(ext_x, aligned) // THREADS)
    if nbx * strips * col_splits > MAX_GRID_X or max(nby, batch) > \
            MAX_GRID_YZ:
        raise ValueError(f"skimage_apply: crop {tuple(out_shape)} of a batch "
                         f"of {batch} at regions {tuple(kernel_size)} exceeds "
                         f"the kernel's launch grid")
    return nbx, nby, rpb, strips, col_splits


def _vec_ok(binned: torch.Tensor, out: torch.Tensor, x0: int) -> bool:
    """K6 and K8s read bins and write out four columns at a time: rows of
    both 16-byte aligned, at columns that are multiples of 4 in both."""
    return ((binned.data_ptr() | out.data_ptr()) % 16 == 0
            and binned.shape[-1] % 4 == 0 and out.shape[-1] % 4 == 0
            and x0 % 4 == 0)


def skimage_apply(binned: torch.Tensor, maps: torch.Tensor, kernel_size,
                  origin, out_shape) -> torch.Tensor:
    """K6: skimage's bilinear blend of the four neighbouring region maps,
    floored, at the pixels of the ``out_shape`` crop whose top-left corner
    is ``origin`` of the padded binned image.

    binned: [B, H, W] int32 bins in [0, nbins); maps: [B, nr, nc, nbins]
    float32 integer-valued; both contiguous. Returns [B, H0, W0] float32."""
    if _build.exporting():
        return torch.ops.mies.skimage_apply(binned, maps, list(kernel_size),
                                            list(origin), list(out_shape))
    _build.check_tensor(binned, "skimage_apply: binned", dtype=torch.int32)
    _build.check_tensor(maps, "skimage_apply: maps", ndim=4)
    _same_device(maps, binned, "maps")
    (kr, kc), (y0, x0), (h0, w0) = kernel_size, origin, out_shape
    B, h, w = binned.shape
    _, nr, nc, nbins = maps.shape
    _check_nbins(nbins)
    if maps.shape[0] != B or min(kr, kc, h0, w0) < 1 or min(y0, x0) < 0 \
            or y0 + h0 > h or x0 + w0 > w:
        raise ValueError(
            f"skimage_apply: crop {tuple(out_shape)} at {tuple(origin)} of "
            f"{tuple(binned.shape)} with maps {tuple(maps.shape)}"
        )
    if binned.device.type == "cpu":
        return skimage_apply_plain(binned, maps, kernel_size, origin, out_shape)
    out = torch.empty((B, h0, w0), dtype=torch.float32, device=binned.device)
    aligned = _vec_ok(binned, out, x0)
    launch = skimage_launch(B, (kr, kc), (y0, x0), (h0, w0), aligned)
    _build.launch("skimage_apply", "mies_skimage_apply", binned.device,
                  binned.data_ptr(), maps.data_ptr(), out.data_ptr(), B, h, w,
                  nr, nc, kr, kc, nbins, y0, x0, h0, w0, *launch,
                  int(aligned))
    return out


# --- the conventions --------------------------------------------------------


def clahe_cuda(
    x: torch.Tensor, clip_limit: float = 2.0, grid_size=(8, 8),
    convention: str = "opencv",
) -> torch.Tensor:
    """opencv- or fraction-convention CLAHE of [B, H, W] float32: the
    tiles' LUTs (``tile_luts``: opencv K1 to the LUTs, fraction K1 -> the
    LUT build in plain torch on x's device) -> K2. Same numbers as
    ops.histogram.clahe."""
    if convention not in ("opencv", "fraction"):
        raise ValueError(f"clahe_cuda runs 'opencv' and 'fraction', not "
                         f"{convention!r}")
    luts = tile_luts(x, grid_size, clip_limit, convention)
    return clahe_apply_lut(x, luts, grid_size, EPILOGUE[convention], convention)


def clahe_skimage_cuda(
    batch: torch.Tensor, kernel_size, clip_limit: float = 0.01,
    nbins: int = NBINS,
) -> torch.Tensor:
    """skimage-convention CLAHE of [B, H, W] float32 with regions of
    ``kernel_size``: plain scale-in and binning -> K1 bins -> K6a -> K6 ->
    plain stretch. Same numbers as ops.histogram.clahe(convention=
    "skimage")."""
    _build.check_tensor(batch, "clahe_skimage: batch")
    _check_nbins(nbins)
    kr, kc = kernel_size
    h0, w0 = batch.shape[-2:]
    (pr0, _, pc0, _), (nr, nc) = H.skimage_geometry((h0, w0), (kr, kc))
    binned = H._skimage_binned(batch, (kr, kc), nbins)
    k_elems = kr * kc
    clim = int(np.clip(clip_limit * k_elems, 1, None))
    hists = tile_hists_bins(binned, (pr0, pc0), (nr, nc), (kr, kc), nbins)
    maps = skimage_maps(hists, clim, k_elems)
    result = skimage_apply(binned, maps, (kr, kc), (pr0, pc0), (h0, w0))
    return H._skimage_stretch_out(result)


def clahe_batched(
    batch: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size=(8, 8),
    convention: str = "opencv",
    nbins: int = NBINS,
    kernel_size=None,
) -> torch.Tensor:
    """The pipeline's batched CLAHE. For a CUDA tensor: skimage through
    K1 bins / K6a / K6, opencv through K1 to the LUTs / K2, fraction
    through K1 / plain LUT build / K2, kornia in
    plain torch on the card. For a CPU tensor: ``ops.histogram.clahe``, but
    while ``torch.export`` traces, through the kernels' ``mies`` ops (their
    plain versions on the CPU: the same numbers)."""
    H.check_convention(convention, nbins)
    grid = tuple(grid_size)
    if batch.device.type == "cuda" or _build.exporting():
        if convention == "skimage":
            ks = H.skimage_kernel_size(batch.shape[-2:], grid, kernel_size)
            return clahe_skimage_cuda(batch, ks, clip_limit, nbins)
        if convention in ("opencv", "fraction"):
            return clahe_cuda(batch, clip_limit, grid, convention)
    return H.clahe(batch, clip_limit, grid, convention, nbins, kernel_size)


# --- the custom ops, for torch.export (kernels._build.register_op) ----------


def _counts_fake(x, grid_size, *_):
    return x.new_empty((x.shape[0], *grid_size, NBINS), dtype=torch.int32)


def _luts_fake(x, grid_size, *_):
    return x.new_empty((x.shape[0], *grid_size, NBINS), dtype=torch.float32)


def _bins_fake(bins, origin, grid_size, tile, nbins):
    return bins.new_empty((bins.shape[0], *grid_size, nbins),
                          dtype=torch.int32)


def _crop_fake(binned, maps, kernel_size, origin, out_shape):
    return binned.new_empty((binned.shape[0], *out_shape),
                            dtype=torch.float32)


# operations of a call: K1 a level quantize (4) and a count per pixel, and
# about 20 integer operations per LUT entry for the clip, redistribution,
# two scans and the rint; K2 and K5 29 per pixel (u8norm) or 27 (clip01);
# K6a 16 + 2 log2(nbins) per bin of a region (the data-dependent sweeps of
# its phase 3 not counted); K6 16 per output pixel
APPLY_OPS = {"u8norm": 29, "clip01": 27}


def _luts_ops(x, grid_size, *_):
    return 5 * x.numel() + 20 * x.shape[0] * grid_size[0] * grid_size[1] \
        * NBINS


_build.register_op(
    "tile_hists", tile_hists,
    "(Tensor x, int[] grid_size, str convention) -> Tensor", _counts_fake,
    lambda x, *_: 5 * x.numel())
_build.register_op(
    "tile_luts", tile_luts,
    "(Tensor x, int[] grid_size, float clip_limit, str convention) -> Tensor",
    _luts_fake, _luts_ops)
_build.register_op(
    "tile_hists_bins", tile_hists_bins,
    "(Tensor bins, int[] origin, int[] grid_size, int[] tile, int nbins) -> "
    "Tensor", _bins_fake,
    lambda bins, origin, g, t, _: bins.shape[0] * g[0] * t[0] * g[1] * t[1])
_build.register_op(
    "clahe_apply_lut", clahe_apply_lut,
    "(Tensor x, Tensor luts, int[] grid_size, str finalize, str convention) "
    "-> Tensor", lambda x, *_: torch.empty_like(x),
    lambda x, luts, grid, finalize, _: APPLY_OPS[finalize] * x.numel())
_build.register_op(
    "clahe_apply_lut_band", clahe_apply_lut_band,
    "(Tensor band, Tensor luts, int[] grid_size, int[] tile_shape, "
    "int y_offset, str finalize) -> Tensor",
    lambda band, *_: torch.empty_like(band),
    lambda band, *args: APPLY_OPS[args[-1]] * band.numel())
_build.register_op(
    "skimage_maps", skimage_maps,
    "(Tensor hists, int clim, int k_elems) -> Tensor",
    lambda hists, *_: hists.new_empty(hists.shape, dtype=torch.float32),
    lambda hists, *_: hists.numel() * (16 + 2 * np.log2(hists.shape[-1])))
_build.register_op(
    "skimage_apply", skimage_apply,
    "(Tensor binned, Tensor maps, int[] kernel_size, int[] origin, "
    "int[] out_shape) -> Tensor", _crop_fake,
    lambda binned, m, ks, origin, out_shape: 16 * binned.shape[0]
    * out_shape[0] * out_shape[1])
