"""median_blur (skimage.filters.median, behavior='ndimage'): the median of
the odd k x k window, borders by index in scipy's modes (the default
'nearest' repeats the edge). The k * k shifted views are stacked and
``torch.median`` takes the middle one: an exact median of an odd count,
whatever the order of the values."""

from __future__ import annotations

import numpy as np
import torch

_NP_MODE = {"nearest": "edge", "edge": "edge", "reflect": "symmetric",
            "mirror": "reflect", "wrap": "wrap"}


def _pad(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    for axis in (-2, -1):
        idx = np.pad(np.arange(x.shape[axis]), r, mode=_NP_MODE[mode])
        x = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return x


def apply(img: torch.Tensor, dtype, info, kernel_size: int = 3,
          mode: str = "nearest") -> torch.Tensor:
    img = img.to(dtype)
    k = int(kernel_size)
    if k == 1:
        return img
    r = k // 2
    h, w = img.shape[-2:]
    p = _pad(img, r, mode)
    views = torch.stack([p[..., dy:dy + h, dx:dx + w]
                         for dy in range(k) for dx in range(k)])
    return views.median(dim=0).values


def operations(shape, info, kernel_size: int = 3, **params) -> int:
    b, h, w = shape
    k = int(kernel_size)
    # the comparisons of a selection network for the middle of k * k
    # values: Paeth's 19 at k 3; otherwise the fewest any selection needs,
    # k * k - 1 (a lower count keeps the chain's roofline share honest)
    return (19 if k == 3 else k * k - 1) * b * h * w
