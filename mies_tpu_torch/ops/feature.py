"""Canny edge detection, plain PyTorch: ``mies_tpu.ops.feature``
(skimage.feature.canny semantics).

  1. Gaussian smoothing (``sigma``, border ``mode``) by the port's
     shifted adds;
  2. scipy's Sobel gradients ([-1, 0, 1] x [1, 2, 1], 'reflect', no
     normalization), magnitude sqrt(gy^2 + gx^2);
  3. non-maximum suppression against the magnitude interpolated at
     p +/- u, u the gradient normalized to the pixel ring, as dense
     blends of shifted views (border pixels are never maxima);
  4. double threshold (absolute, or per-slice quantiles of the magnitude
     with linear interpolation, jnp.quantile's arithmetic) and hysteresis:
     weak edges 8-connected to a strong one survive.

Hysteresis grows the strong mask through the weak one by 3 x 3 dilation
until it stops changing. The reference tests for that after every step
(a device sum under ``lax.while_loop``); here the whole batch runs
``HYSTERESIS_CHECK_EVERY`` steps between tests, one host read each. A
fixpoint is idempotent, so the extra steps change nothing, and a slice
that has converged stays as it is while the others grow.

Every function takes float32 ``[..., H, W]``; canny returns float32 {0, 1}.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.filters import _sep_conv2d, _sqrt_rn, gaussian_blur

# dilation steps between two convergence tests of the hysteresis
HYSTERESIS_CHECK_EVERY = 16


def _sobel_scipy(x: torch.Tensor, axis: int) -> torch.Tensor:
    """scipy.ndimage.sobel along ``axis`` (0 rows, 1 columns): [-1, 0, 1]
    along it, [1, 2, 1] along the other, 'reflect', unnormalized."""
    deriv = np.array([-1.0, 0.0, 1.0], np.float32)
    smooth = np.array([1.0, 2.0, 1.0], np.float32)
    ky, kx = (deriv, smooth) if axis == 0 else (smooth, deriv)
    return _sep_conv2d(x, ky, kx, "reflect")


def _nms_interpolated(gy: torch.Tensor, gx: torch.Tensor,
                      mag: torch.Tensor) -> torch.Tensor:
    """Dense non-maximum suppression (step 3): bool [..., H, W]."""
    h, w = mag.shape[-2:]
    ay, ax = gy.abs(), gx.abs()
    y_major = ay >= ax
    denom = torch.where(y_major, ay, ax)
    frac = torch.where(y_major, ax, ay) / torch.clamp_min(
        denom, float(np.float32(1e-30)))
    same_sign = (gy * gx) >= 0
    mp = F.pad(mag, (1, 1, 1, 1))

    def sh(dy, dx):  # [y, x] reads (y + dy, x + dx)
        return mp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    def blend(straight, corner):
        return corner * frac + straight * (1.0 - frac)

    ym_plus = blend(sh(1, 0), torch.where(same_sign, sh(1, 1), sh(1, -1)))
    ym_minus = blend(sh(-1, 0), torch.where(same_sign, sh(-1, -1), sh(-1, 1)))
    xm_plus = blend(sh(0, 1), torch.where(same_sign, sh(1, 1), sh(-1, 1)))
    xm_minus = blend(sh(0, -1), torch.where(same_sign, sh(-1, -1), sh(1, -1)))
    c_plus = torch.where(y_major, ym_plus, xm_plus)
    c_minus = torch.where(y_major, ym_minus, xm_minus)
    keep = (c_plus <= mag) & (c_minus <= mag) & (mag > 0)
    keep[..., 0, :] = False
    keep[..., -1, :] = False
    keep[..., :, 0] = False
    keep[..., :, -1] = False
    return keep


def hysteresis(strong: torch.Tensor, weak: torch.Tensor,
               every: int = HYSTERESIS_CHECK_EVERY) -> tuple[torch.Tensor, int]:
    """Grow ``strong & weak`` through ``weak`` by 8-connected dilation to
    its fixpoint, on the whole batch at once. Returns (mask, the dilation
    steps run); the pixel count is read on the host once every ``every``
    steps, and the growth stops at the first read that finds no change."""
    lead, (h, w) = strong.shape[:-2], strong.shape[-2:]
    m = (strong & weak).to(torch.float32).reshape(-1, 1, h, w)
    wk = weak.to(torch.float32).reshape(-1, 1, h, w)
    count, steps = int(m.sum().item()), 0
    while True:
        for _ in range(every):
            m = F.max_pool2d(m, 3, 1, 1) * wk
        steps += every
        now = int(m.sum().item())
        if now == count:
            return m.reshape(*lead, h, w) > 0, steps
        count = now


def quantile_slices(x: torch.Tensor, q: float) -> torch.Tensor:
    """Each slice's ``q`` quantile of [..., H, W] -> [..., 1, 1] by
    jnp.quantile's linear rule: the sorted values at floor and ceil of
    q (n - 1), weighted by (1 - f, f), all in float32."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    n = h * w
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - lo)
    lw = np.float32(np.float32(1.0) - hw)
    lo, hi = int(min(max(lo, 0), n - 1)), int(min(max(hi, 0), n - 1))
    srt = torch.sort(x.reshape(-1, n), dim=-1).values
    out = srt[:, lo] * float(lw) + srt[:, hi] * float(hw)
    return out.reshape(*lead, 1, 1)


def canny_with_steps(
    img: torch.Tensor,
    sigma: float = 1.0,
    low_threshold: float | None = None,
    high_threshold: float | None = None,
    use_quantiles: bool = False,
    mode: str = "constant",
) -> tuple[torch.Tensor, int]:
    """``canny`` and the number of hysteresis dilation steps it ran."""
    if low_threshold is None:
        low_threshold = 0.1
    if high_threshold is None:
        high_threshold = 0.2
    if use_quantiles and not (
        0.0 <= low_threshold <= 1.0 and 0.0 <= high_threshold <= 1.0
    ):
        raise ValueError("quantile thresholds must be in [0, 1]")
    if low_threshold > high_threshold:
        raise ValueError(
            f"low_threshold ({low_threshold}) must be <= high_threshold "
            f"({high_threshold})"
        )
    x = img.to(torch.float32)
    sm = gaussian_blur(x, float(sigma), 4.0, mode)
    gy = _sobel_scipy(sm, 0)
    gx = _sobel_scipy(sm, 1)
    mag = _sqrt_rn(gy * gy + gx * gx)
    maxima = _nms_interpolated(gy, gx, mag)
    if use_quantiles:
        lo = quantile_slices(mag, float(low_threshold))
        hi = quantile_slices(mag, float(high_threshold))
    else:
        lo = float(np.float32(low_threshold))
        hi = float(np.float32(high_threshold))
    weak = maxima & (mag >= lo)
    strong = weak & (mag >= hi)
    edges, steps = hysteresis(strong, weak)
    return edges.to(torch.float32), steps


def canny(
    img: torch.Tensor,
    sigma: float = 1.0,
    low_threshold: float | None = None,
    high_threshold: float | None = None,
    use_quantiles: bool = False,
    mode: str = "constant",
) -> torch.Tensor:
    """skimage.feature.canny on float [0, 1] slices (module docstring).
    Defaults low 0.1, high 0.2 (absolute); ``use_quantiles`` reads them as
    quantiles of each slice's gradient magnitude. float32 {0, 1}."""
    return canny_with_steps(img, sigma, low_threshold, high_threshold,
                            use_quantiles, mode)[0]
