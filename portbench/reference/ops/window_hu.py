"""window_hu: clip((hu - (center - width / 2)) / width, 0, 1), a true
division by a tensor (CUDA torch multiplies by the reciprocal of a Python
scalar)."""

from __future__ import annotations

import torch


def apply(hu: torch.Tensor, dtype, info, center: float,
          width: float) -> torch.Tensor:
    x = hu.to(dtype)
    lo = float(center) - float(width) / 2.0
    return torch.clamp((x - lo) / torch.full((), float(width), dtype=dtype,
                                             device=x.device), 0.0, 1.0)


def operations(shape, info, **params) -> int:
    b, h, w = shape
    return 4 * b * h * w  # subtract, divide, two clamps
