"""CLAHE on the card: K1 (tile histograms) -> LUT build -> K2 (LUT apply).

``clahe_cuda`` composes the two hand-written kernels of ``csrc/clahe.cu``
with the small LUT build (clip/redistribute, cumsum, rint) left to plain
torch on the device, as ``mies_tpu.kernels.clahe.clahe_tpu`` leaves it to
XLA. The kernel wrappers ``tile_hists`` and ``clahe_apply_lut`` launch
their kernel for a CUDA tensor and run their plain version (from
``ops.histogram``) only for a CPU tensor.

Any image shape runs: a ragged image's OpenCV bottom/right reflect-101
pad is resolved inside K1, and K2 writes only the unpadded pixels, so no
padded copy of the batch is ever made.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import histogram as H

NBINS = H.NBINS


def _tile_shape(shape, grid_size) -> tuple[int, int]:
    """(th, tw) of the image padded up to a multiple of the grid; the pad
    is one reflect-101 bounce, so it must be shorter than the image."""
    h, w = shape
    gy, gx = grid_size
    if gy < 1 or gx < 1:
        raise ValueError(f"grid_size must be >= 1, got {grid_size}")
    ph, pw = (gy - h % gy) % gy, (gx - w % gx) % gx
    if ph > h - 1 or pw > w - 1:
        raise ValueError(
            f"image {h}x{w} is too small for a {gy}x{gx} CLAHE grid"
        )
    return (h + ph) // gy, (w + pw) // gx


def tile_hists_plain(x: torch.Tensor, grid_size) -> torch.Tensor:
    """Plain version of K1: [B, H, W] f32 -> [B, gy, gx, 256] int32."""
    gy, gx = grid_size
    u8, _, _ = H._pad_reflect101(H._levels(x), (gy, gx))
    counts = H._tile_histograms(u8, (gy, gx))
    return counts.reshape(x.shape[0], gy, gx, NBINS).to(torch.int32)


def tile_hists(x: torch.Tensor, grid_size) -> torch.Tensor:
    """K1: per-tile 256-bin counts of the uint8 levels of x.

    x: [B, H, W] float32 in [0, 1], contiguous. Returns [B, gy, gx, 256]
    int32 exact counts over the reflect-101-padded tiles."""
    _build.check_tensor(x, "tile_hists: x")
    gy, gx = grid_size
    B, h, w = x.shape
    th, tw = _tile_shape((h, w), (gy, gx))
    if x.device.type == "cpu":
        return tile_hists_plain(x, (gy, gx))
    out = torch.empty((B, gy, gx, NBINS), dtype=torch.int32, device=x.device)
    _build.launch("tile_hists", "mies_tile_hists", x.device,
                  x.data_ptr(), out.data_ptr(), B, h, w, gy, gx, th, tw)
    return out


def clahe_apply_lut_plain(x: torch.Tensor, luts: torch.Tensor, grid_size
                          ) -> torch.Tensor:
    """Plain version of K2: bilinear LUT blend + u8norm epilogue."""
    th, tw = _tile_shape(x.shape[-2:], grid_size)
    res = H._bilinear_lut_apply(H._levels(x), luts, tuple(grid_size),
                                tile_shape=(th, tw))
    return H._u8norm(res)


def clahe_apply_lut(x: torch.Tensor, luts: torch.Tensor, grid_size
                    ) -> torch.Tensor:
    """K2: OpenCV bilinear LUT interpolation at each pixel's uint8 level,
    finalized as clip(rint(v), 0, 255) / 255.

    x: [B, H, W] float32 in [0, 1]; luts: [B, gy, gx, 256] float32
    (integer-valued), both contiguous. Returns [B, H, W] float32."""
    _build.check_tensor(x, "clahe_apply_lut: x")
    _build.check_tensor(luts, "clahe_apply_lut: luts", ndim=4)
    gy, gx = grid_size
    B, h, w = x.shape
    if tuple(luts.shape) != (B, gy, gx, NBINS):
        raise ValueError(f"luts: expected {(B, gy, gx, NBINS)}, got "
                         f"{tuple(luts.shape)}")
    if luts.device != x.device:
        raise ValueError(f"luts on {luts.device}, x on {x.device}")
    th, tw = _tile_shape((h, w), (gy, gx))
    if x.device.type == "cpu":
        return clahe_apply_lut_plain(x, luts, (gy, gx))
    out = torch.empty_like(x)
    inv_th = float(np.float32(1.0) / np.float32(th))
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    _build.launch("clahe_apply_lut", "mies_apply_lut", x.device,
                  x.data_ptr(), luts.data_ptr(), out.data_ptr(),
                  B, h, w, gy, gx, th, tw, inv_th, inv_tw)
    return out


def clahe_cuda(
    x: torch.Tensor, clip_limit: float = 2.0, grid_size=(8, 8)
) -> torch.Tensor:
    """OpenCV-convention CLAHE of [B, H, W] float32: K1 -> LUT build in
    plain torch on x's device -> K2. Same numbers as ops.histogram.clahe."""
    gy, gx = grid_size
    th, tw = _tile_shape(x.shape[-2:], (gy, gx))
    hists = tile_hists(x, (gy, gx)).reshape(x.shape[0], gy * gx, NBINS)
    luts = H._luts_opencv(hists.to(torch.float32), clip_limit, th * tw)
    return clahe_apply_lut(x, luts.reshape(x.shape[0], gy, gx, NBINS), (gy, gx))


def clahe_batched(
    batch: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size=(8, 8),
    convention: str = "opencv",
    nbins: int = NBINS,
    kernel_size=None,
) -> torch.Tensor:
    """The pipeline's batched CLAHE: the kernels for a CUDA tensor, the
    plain ``ops.histogram.clahe`` over the batch for a CPU tensor."""
    H.check_convention(convention, nbins)
    if batch.device.type == "cuda":
        return clahe_cuda(batch, clip_limit, tuple(grid_size))
    return H.clahe(batch, clip_limit, tuple(grid_size), convention, nbins,
                   kernel_size)
