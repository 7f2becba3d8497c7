"""clahe, OpenCV convention (cv2.createCLAHE): uint8 levels, integer tile
histograms of the image padded bottom and right by BORDER_REFLECT_101 up
to the grid, OpenCV's integer clip and redistribution, rint'ed LUTs
scaled by the float32 255 / tile_area, the bilinear blend with float32
reciprocal weights, and clip(rint(.)) / 255. Counts stay integer-valued
float32 whatever the compute dtype: they are counts, not pixel values."""

from __future__ import annotations

import numpy as np
import torch

NBINS = 256


def _reflect101(x: torch.Tensor, axis: int, after: int) -> torch.Tensor:
    if after == 0:
        return x
    idx = np.pad(np.arange(x.shape[axis]), (0, after), mode="reflect")
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def _clip_redistribute(hist: torch.Tensor, clip: float) -> torch.Tensor:
    excess = torch.clamp(hist - clip, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip)
    incr = torch.floor(excess / NBINS)
    residual = excess - incr * NBINS
    hist = hist + incr
    step = torch.clamp(torch.floor(hist.new_full((), float(NBINS))
                                   / torch.clamp(residual, min=1.0)), min=1.0)
    i = torch.arange(NBINS, dtype=torch.float32, device=hist.device)
    gets_one = (torch.remainder(i, step) == 0) & (torch.floor(i / step)
                                                  < residual)
    return hist + gets_one.to(torch.float32)


def apply(img: torch.Tensor, dtype, info, clip_limit: float = 2.0,
          grid_size=(8, 8), convention: str = "opencv") -> torch.Tensor:
    if convention != "opencv":
        raise ValueError(f"clahe reference: convention {convention!r} not "
                         f"held")
    gy, gx = (int(g) for g in grid_size)
    x = img.to(dtype)
    b, h0, w0 = x.shape
    lev = torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int32)
    if h0 % gy or w0 % gx:  # cv2 pads both axes when either is ragged
        lev = _reflect101(_reflect101(lev, -2, gy - h0 % gy), -1,
                          gx - w0 % gx)
    h, w = lev.shape[-2:]
    th, tw = h // gy, w // gx
    tiles = lev.reshape(b, gy, th, gx, tw).transpose(-3, -2)
    tiles = tiles.reshape(b, gy * gx, th * tw).to(torch.int64)
    hist = torch.zeros(b, gy * gx, NBINS, dtype=torch.float32,
                       device=x.device)
    hist.scatter_add_(-1, tiles, torch.ones_like(tiles, dtype=torch.float32))
    area = th * tw
    clip = float(max(int(clip_limit * area / NBINS), 1))
    cdf = torch.cumsum(_clip_redistribute(hist, clip), dim=-1)
    scale = float(np.float32(NBINS - 1) / np.float32(area))
    luts = torch.clamp(torch.round(cdf * scale), 0, 255).to(dtype)
    luts = luts.reshape(b, gy * gx * NBINS)

    inv_th = float(np.float32(1.0) / np.float32(th))
    inv_tw = float(np.float32(1.0) / np.float32(tw))
    yf = torch.arange(h, dtype=torch.float32, device=x.device) * inv_th - 0.5
    xf = torch.arange(w, dtype=torch.float32, device=x.device) * inv_tw - 0.5
    y1f, x1f = torch.floor(yf), torch.floor(xf)
    ya = (yf - y1f)[:, None].to(dtype)
    xa = (xf - x1f)[None, :].to(dtype)
    ty1 = torch.clamp(y1f.to(torch.int64), min=0)[:, None]
    tx1 = torch.clamp(x1f.to(torch.int64), min=0)[None, :]
    ty2 = torch.clamp(y1f.to(torch.int64) + 1, max=gy - 1)[:, None]
    tx2 = torch.clamp(x1f.to(torch.int64) + 1, max=gx - 1)[None, :]
    v = lev.to(torch.int64)

    def pick(ty, tx):
        idx = ((ty * gx + tx) * NBINS + v).reshape(b, h * w)
        return torch.gather(luts, -1, idx).reshape(b, h, w)

    top = pick(ty1, tx1) * (1.0 - xa) + pick(ty1, tx2) * xa
    bot = pick(ty2, tx1) * (1.0 - xa) + pick(ty2, tx2) * xa
    res = (top * (1.0 - ya) + bot * ya)[..., :h0, :w0]
    return torch.clamp(torch.round(res), 0, 255) / torch.full(
        (), 255.0, dtype=dtype, device=x.device)


def operations(shape, info, grid_size=(8, 8), **params) -> int:
    b, h, w = shape
    gy, gx = (int(g) for g in grid_size)
    # 5 a pixel to the histograms (scale, round, two clamps, count), 20 a
    # bin for a tile's LUT, 29 a pixel for the blend and the epilogue
    return 34 * b * h * w + 20 * NBINS * gy * gx * b
