"""denoise_nl_means (skimage fast mode, the symmetric-pair loop) on each
slice: over the half table of shifts t, the patch SSD S_t(p) of the
numpy-'reflect' extension (rows of a column summed, then columns in
ascending order), D = max(S - 2 sigma^2 s^2, 0) / (h^2 s^2), w = exp(-D)
where D <= 5, both ends of each pair accumulated;
out = (sum w u + 2 u) / (sum w + 2)."""

from __future__ import annotations

import itertools

import numpy as np
import torch

DISTANCE_CUTOFF = 5.0


def half_shift_table(d: int) -> list[tuple[int, int]]:
    """The lexicographically positive half of [-d, d]^2 as offsets t + d."""
    out = []
    for t in itertools.product(range(-d, d + 1), repeat=2):
        for c in t:
            if c > 0:
                out.append((t[0] + d, t[1] + d))
                break
            if c < 0:
                break
    return out


def params(shape, patch_size: int, patch_distance: int, h: float,
           sigma: float):
    s = patch_size if patch_size % 2 == 1 else patch_size + 1
    d = int(patch_distance)
    if any(s // 2 + d > n - 1 for n in shape):
        raise ValueError(f"NL-means s={s}, d={d} does not fit {shape}")
    sn = float(s) ** 2
    inv_h2sn = float(np.float32(1.0 / (float(h) * float(h) * sn)))
    bias = float(np.float32(2.0 * float(sigma) * float(sigma) * sn))
    return s, d, bias, inv_h2sn


def _pad(x: torch.Tensor, r: int, np_mode: str) -> torch.Tensor:
    for axis in (-2, -1):
        idx = np.pad(np.arange(x.shape[axis]), r, mode=np_mode)
        x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return x


def apply(img: torch.Tensor, dtype, info, patch_size: int = 7,
          patch_distance: int = 11, h: float = 0.1,
          sigma: float = 0.0) -> torch.Tensor:
    x = img.to(dtype)
    hh, ww = x.shape[-2:]
    s, d, bias, inv_h2sn = params((hh, ww), patch_size, patch_distance, h,
                                  sigma)
    o = s // 2
    up = _pad(_pad(x, o + d, "reflect"), d, "edge")
    eh, ew = hh + 2 * d + 2 * o, ww + 2 * d + 2 * o
    base = up[:, d:d + eh, d:d + ew]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy, dx in half_shift_table(d):
        diff = base - up[:, dy:dy + eh, dx:dx + ew]
        sq = diff * diff
        rows = sq[:, 0:eh - (s - 1), :]
        for j in range(1, s):
            rows = rows + sq[:, j:eh - (s - 1) + j, :]
        ssd = rows[:, :, 0:ew - (s - 1)]
        for j in range(1, s):
            ssd = ssd + rows[:, :, j:ew - (s - 1) + j]
        dist = torch.clamp_min(ssd - bias, 0.0) * inv_h2sn
        w = torch.where(dist <= DISTANCE_CUTOFF, torch.exp(-dist), 0.0)
        w_f = w[:, d:d + hh, d:d + ww]
        v_f = up[:, o + d + dy:o + d + dy + hh, o + d + dx:o + d + dx + ww]
        w_r = w[:, 2 * d - dy:2 * d - dy + hh, 2 * d - dx:2 * d - dx + ww]
        v_r = up[:, o + 3 * d - dy:o + 3 * d - dy + hh,
                 o + 3 * d - dx:o + 3 * d - dx + ww]
        num = num + (w_f * v_f + w_r * v_r)
        den = den + (w_f + w_r)
    return (num + 2.0 * x) / (den + 2.0)


def operations(shape, info, patch_size: int = 7, patch_distance: int = 11,
               **params_) -> int:
    b, h, w = shape
    s = patch_size if patch_size % 2 == 1 else patch_size + 1
    pairs = len(half_shift_table(int(patch_distance)))
    # per pair: difference and square, the s-wide box along rows and
    # columns, the weight (bias, max, scale, cutoff, exp, select) and the
    # two ends' accumulations (2 multiplies, 4 adds)
    return pairs * (14 + 2 * (s - 1)) * b * h * w
