"""unsharp_mask (skimage semantics): img + amount * (img - gaussian(img,
sigma=radius)), clipped to [0, 1]; the Gaussian truncated at 4 sigma, a
separable pass of ascending-tap shifted adds per axis with scipy's
'nearest' border."""

from __future__ import annotations

import numpy as np
import torch

TRUNCATE = 4.0


def taps(sigma: float) -> np.ndarray:
    radius = int(TRUNCATE * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _pass(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    r = len(k) // 2
    n = x.shape[axis]
    idx = torch.as_tensor(np.pad(np.arange(n), r, mode="edge"),
                          device=x.device)
    xp = x.index_select(axis, idx)
    acc = float(k[0]) * xp.narrow(axis, 0, n)
    for t in range(1, len(k)):
        acc = acc + float(k[t]) * xp.narrow(axis, t, n)
    return acc


def apply(img: torch.Tensor, dtype, info, radius: float = 1.0,
          amount: float = 1.0, mode: str = "nearest",
          clip: bool = True) -> torch.Tensor:
    if mode != "nearest":
        raise ValueError(f"unsharp_mask reference: mode {mode!r} not held")
    img = img.to(dtype)
    blurred = img
    if radius > 0:
        k = taps(radius)
        blurred = _pass(_pass(img, k, -2), k, -1)
    out = img + amount * (img - blurred)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def operations(shape, info, radius: float = 1.0, **params) -> int:
    b, h, w = shape
    # two passes of a multiply and an add per tap; subtract, scale, add,
    # and the two clamps
    return (4 * len(taps(radius)) + 5) * b * h * w
