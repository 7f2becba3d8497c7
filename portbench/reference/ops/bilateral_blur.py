"""bilateral_blur (kornia semantics): over the odd k x k window, summed
in row-major window order, w = exp(-(I(q) - I(p))^2 / (2 sigma_color^2))
times the spatial exp(-|p - q|^2 / (2 sigma_space^2)); out = sum w I(q) /
sum w. Borders by index, scipy's modes."""

from __future__ import annotations

import numpy as np
import torch

_NP_MODE = {"nearest": "edge", "edge": "edge", "reflect": "symmetric",
            "mirror": "reflect"}


def spatial_weights(k: int, sigma_space: float) -> np.ndarray:
    r = k // 2
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    return np.exp(-(dy ** 2 + dx ** 2) / (2.0 * float(sigma_space) ** 2)
                  ).astype(np.float32).ravel()


def _pad(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    for axis in (-2, -1):
        idx = np.pad(np.arange(x.shape[axis]), r, mode=_NP_MODE[mode])
        x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return x


def apply(img: torch.Tensor, dtype, info, kernel_size: int = 5,
          sigma_color: float = 0.1, sigma_space: float = 1.5,
          mode: str = "reflect") -> torch.Tensor:
    img = img.to(dtype)
    k = int(kernel_size)
    r = k // 2
    spatial = spatial_weights(k, sigma_space)
    h, w = img.shape[-2:]
    p = _pad(img, r, mode)
    two_sc2 = img.new_full((), 2.0 * float(sigma_color) ** 2)
    num = den = None
    for i in range(k * k):
        oy, ox = divmod(i, k)
        q = p[..., oy:oy + h, ox:ox + w]
        d = q - img
        wgt = torch.exp(-(d * d) / two_sc2) * float(spatial[i])
        num = wgt * q if num is None else num + wgt * q
        den = wgt if den is None else den + wgt
    return num / den


def operations(shape, info, kernel_size: int = 5, **params) -> int:
    b, h, w = shape
    k = int(kernel_size)
    # one weight per unordered pair (difference, square, scale, exp, times
    # the spatial weight), three per tap, the final divide: 136 at k 5
    return ((k * k - 1) // 2 * 5 + k * k * 3 + 1) * b * h * w
