"""OpenCV-convention CLAHE, plain PyTorch.

Same algorithm and f32 operation order as ``mies_tpu.ops.histogram.clahe``
with ``convention="opencv"``: uint8 levels, integer tile histograms,
OpenCV's exact clip + redistribution, rint'ed uint8 LUTs, the bilinear
blend with f32 reciprocal weights, and a final rint. Eager torch does
not contract multiply-adds into FMAs, so on the CPU this is bit-exact
against ``cv2.createCLAHE`` (tests/test_torch_ops.py).

The skimage, fraction and kornia conventions are not ported yet (see
ROADMAP.md); asking for them raises ``NotImplementedError``.

Functions take float32 ``[..., H, W]`` (any leading batch dims) and run
on the tensor's own device; they are also the plain versions of the K1
(tile histograms) and K2 (LUT apply) kernels.
"""

from __future__ import annotations

import numpy as np
import torch

NBINS = 256


def check_convention(convention: str, nbins: int = NBINS) -> None:
    if convention != "opencv":
        raise NotImplementedError(
            f"clahe convention {convention!r} is not ported to "
            f"mies_tpu_torch yet (only 'opencv'; see ROADMAP.md)"
        )
    if nbins != NBINS:
        raise NotImplementedError(
            f"nbins={nbins}: the opencv convention has 256 bins"
        )


def _levels(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> int32 uint8 levels: clip(round(x * 255), 0, 255)
    (torch.round rounds half to even, like jnp.round and cvRound)."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int32)


def _u8norm(res: torch.Tensor) -> torch.Tensor:
    """OpenCV saturate + renormalize: clip(rint(res), 0, 255) / 255, by
    true division (a tensor divisor: CUDA torch would multiply by the
    reciprocal of a Python scalar)."""
    return torch.clamp(torch.round(res), 0, 255) / res.new_full((), 255.0)


def _pad_reflect101(
    img: torch.Tensor, grid: tuple[int, int]
) -> tuple[torch.Tensor, int, int]:
    """Pad H, W up to multiples of the tile grid with BORDER_REFLECT_101
    on the bottom/right only, as OpenCV's ``copyMakeBorder`` does
    (numpy mode 'reflect' index arithmetic)."""
    h, w = img.shape[-2:]
    gy, gx = grid
    ph = (gy - h % gy) % gy
    pw = (gx - w % gx) % gx
    if ph:
        idx = np.pad(np.arange(h), (0, ph), mode="reflect")
        img = img.index_select(-2, torch.as_tensor(idx, device=img.device))
    if pw:
        idx = np.pad(np.arange(w), (0, pw), mode="reflect")
        img = img.index_select(-1, torch.as_tensor(idx, device=img.device))
    return img, ph, pw


def _tile_histograms(u8: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """Per-tile 256-bin histograms of integer levels [..., H, W] (H, W
    divisible by the grid) -> [..., gy*gx, 256] float32 counts."""
    gy, gx = grid
    *lead, h, w = u8.shape
    th, tw = h // gy, w // gx
    tiles = u8.reshape(*lead, gy, th, gx, tw).transpose(-3, -2)
    tiles = tiles.reshape(*lead, gy * gx, th * tw).to(torch.int64)
    hist = torch.zeros(*lead, gy * gx, NBINS, dtype=torch.float32,
                       device=u8.device)
    return hist.scatter_add_(-1, tiles, torch.ones_like(tiles, dtype=torch.float32))


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


def _bilinear_lut_apply(
    u8: torch.Tensor,
    luts: torch.Tensor,
    grid: tuple[int, int],
    tile_shape: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Bilinearly interpolate per pixel between the 4 neighbouring tile LUTs.

    u8:   [..., H, W] integer levels (the padded image, or any top-left
          crop of it when ``tile_shape`` gives the padded tile size).
    luts: [..., gy, gx, 256] float32.
    Returns float32 [..., H, W] of interpolated LUT values (un-rounded).

    OpenCV weights: ``txf = x * (1/tw) - 0.5`` with the f32 reciprocal;
    ``tx1 = max(floor(txf), 0)``; ``tx2 = min(floor(txf) + 1, gx - 1)``
    (the UNCLIPPED floor); ``xa = txf - floor(txf)``; x then y lerp.
    """
    gy, gx = grid
    *lead, h, w = u8.shape
    th, tw = tile_shape if tile_shape is not None else (h // gy, w // gx)
    dev = u8.device
    inv_th = float(np.float32(1.0) / np.float32(th))
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    yf = torch.arange(h, dtype=torch.float32, device=dev) * inv_th - 0.5
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


def clahe(
    img: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size: tuple[int, int] = (8, 8),
    convention: str = "opencv",
    nbins: int = NBINS,
    kernel_size: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Contrast-Limited Adaptive Histogram Equalization on float [0, 1].

    convention="opencv": quantize to uint8 levels, run OpenCV's exact
    integer algorithm (clip = max(int(clip_limit * tile_area / 256), 1),
    integer redistribution, uint8 LUT via rint, bilinear blend, final
    rint) and return float levels / 255. ``kernel_size`` belongs to the
    skimage convention and is accepted for signature parity only.
    """
    if img.dim() < 2:
        raise ValueError(f"clahe expects [..., H, W]; got {tuple(img.shape)}")
    check_convention(convention, nbins)
    gy, gx = grid_size
    h0, w0 = img.shape[-2:]
    u8, _, _ = _pad_reflect101(_levels(img.to(torch.float32)), (gy, gx))
    h, w = u8.shape[-2:]
    th, tw = h // gy, w // gx
    hists = _tile_histograms(u8, (gy, gx))
    luts = _luts_opencv(hists, clip_limit, th * tw)
    luts = luts.reshape(*u8.shape[:-2], gy, gx, NBINS)
    out = _bilinear_lut_apply(u8, luts, (gy, gx))
    return _u8norm(out[..., :h0, :w0])
