"""Spatial filters, plain PyTorch.

Same semantics and operation order as ``mies_tpu.ops.filters``:
  * gaussian_blur  -> skimage.filters.gaussian (truncate 4, scipy pads
    applied per 1-D pass, ascending-tap shifted adds);
  * unsharp_mask   -> img + amount * (img - gaussian(img, radius)), clipped;
  * bilateral_blur -> kornia.filters.bilateral_blur (explicit odd window);
  * median_blur    -> skimage.filters.median (odd square footprint);
  * guided_blur    -> kornia.filters.guided_blur (He et al., box means).

Borders are built by INDEX from numpy's ``np.pad`` arithmetic: the
reference's default bilateral mode 'reflect' is numpy 'symmetric', which
``torch.nn.functional.pad`` does not have (its 'reflect' is numpy
'reflect'). No ``F.conv2d``: cuDNN runs it in TF32 on the card and its
reduction order is not the scipy tap order.

Every function takes float32 ``[..., H, W]`` (any leading batch dims) and
runs on the tensor's own device. These are also the plain versions the
K3/K4 kernels are held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_PAD_MODE = {
    "nearest": "edge",
    "edge": "edge",  # alias (skimage spelling of 'nearest')
    "reflect": "symmetric",  # scipy 'reflect' (d c b a | a b c d) == np 'symmetric'
    "mirror": "reflect",  # scipy 'mirror'  (d c b | a b c d | c b a) == np 'reflect'
    "constant": "constant",
    "wrap": "wrap",
}


def _pad_axis(x: torch.Tensor, r: int, axis: int, mode: str) -> torch.Tensor:
    """Pad ``axis`` (negative) by ``r`` on both sides, np.pad semantics."""
    if r == 0:
        return x
    np_mode = _PAD_MODE[mode]
    if np_mode == "constant":
        return F.pad(x, (0, 0) * (-1 - axis) + (r, r))
    return x.index_select(axis, _pad_index(x.shape[axis], r, np_mode, x.device))


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, r: int, np_mode: str, device: torch.device) -> torch.Tensor:
    """The np.pad source index of each row of an axis of n padded by r, on
    ``device`` (kept: one blocking host-to-device copy per shape, not one
    per pass)."""
    idx = np.pad(np.arange(n), r, mode=np_mode)
    return torch.as_tensor(idx, device=device)


def check_volume(vol: torch.Tensor, what: str) -> None:
    """Refuse anything but one [Z, H, W] volume, naming the op."""
    if vol.dim() != 3:
        raise ValueError(f"{what} expects [Z, H, W]; got {tuple(vol.shape)}")


def _pad2d(img: torch.Tensor, ry: int, rx: int, mode: str) -> torch.Tensor:
    return _pad_axis(_pad_axis(img, ry, -2, mode), rx, -1, mode)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage-compatible 1-D Gaussian taps (host-side, static)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    return k.astype(np.float32)


def _conv1d_shifted(
    x: torch.Tensor, taps: np.ndarray, axis: int, mode: str
) -> torch.Tensor:
    """1-D correlation along ``axis`` as explicit shifted adds in
    ascending-tap order (scipy.ndimage.correlate1d's summation order):
    acc = t0 * x0; acc = acc + ti * xi. Separate multiply and add ops, so
    nothing fuses them into an FMA."""
    r = len(taps) // 2
    n = x.shape[axis]
    xp = _pad_axis(x, r, axis, mode)
    acc = float(taps[0]) * xp.narrow(axis, 0, n)
    for t in range(1, len(taps)):
        acc = acc + float(taps[t]) * xp.narrow(axis, t, n)
    return acc


def _sep_conv2d(
    img: torch.Tensor, ky: np.ndarray, kx: np.ndarray, mode: str
) -> torch.Tensor:
    """Separable correlation: the vertical pass, then the horizontal one,
    each with its own border pad (scipy's sequential correlate1d)."""
    x = img.to(torch.float32)
    if len(ky) > 1:
        x = _conv1d_shifted(x, np.asarray(ky, np.float32), -2, mode)
    if len(kx) > 1:
        x = _conv1d_shifted(x, np.asarray(kx, np.float32), -1, mode)
    return x


def gaussian_blur(
    img: torch.Tensor,
    sigma: float = 1.0,
    truncate: float = 4.0,
    mode: str = "nearest",
) -> torch.Tensor:
    """Gaussian blur, skimage.filters.gaussian semantics.

    Kernel radius = int(truncate * sigma + 0.5) (scipy.ndimage). sigma=0
    is the identity.
    """
    if sigma <= 0:
        return img
    radius = int(truncate * float(sigma) + 0.5)
    k = gaussian_kernel1d(float(sigma), radius)
    return _sep_conv2d(img, k, k, mode)


def box_blur(img: torch.Tensor, kernel_size: int = 3,
             mode: str = "reflect") -> torch.Tensor:
    """Normalized box (mean) filter with an odd square window: two
    separable passes of k taps of float32(1/k)."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    k = np.full((kernel_size,), 1.0 / kernel_size, np.float32)
    return _sep_conv2d(img, k, k, mode)


def guided_blur(
    img: torch.Tensor,
    kernel_size: int = 3,
    eps: float = 1e-2,
    mode: str = "reflect",
    guide: torch.Tensor | None = None,
) -> torch.Tensor:
    """Guided filter (He et al. 2010), kornia.filters.guided_blur
    semantics, self-guided by default: five box means of the port's
    ``box_blur`` (the self-guided dataflow pairs them as the reference's
    ``_guided_dataflow`` does, ``guided_dataflow`` here)."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")

    def box(x):
        return box_blur(x, kernel_size, mode)

    if guide is None:
        return guided_dataflow(lambda u, v: (box(u), box(v)), img, eps)
    g = guide
    mean_i = box(g)
    mean_p = box(img)
    corr_i = box(g * g)
    corr_ip = box(g * img)
    var_i = corr_i - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box(a) * g + box(b)


def guided_dataflow(box2, x: torch.Tensor, eps: float) -> torch.Tensor:
    """The self-guided He-et-al dataflow on a box-mean pair function
    ``box2(u, v) -> (box(u), box(v))``: ``guided_blur``'s, and the row
    band's, whose pair function extends both arrays with one halo
    exchange (``mies_tpu_torch.parallel.halo``)."""
    mean_i, corr_i = box2(x, x * x)
    var_i = corr_i - mean_i * mean_i
    a = var_i / (var_i + eps)
    b = mean_i - a * mean_i
    fa, fb = box2(a, b)
    return fa * x + fb


@functools.lru_cache(maxsize=32)
def _median_network(n: int) -> tuple:
    """Batcher's odd-even mergesort on n wires (the reference's
    comparators), cut to those the middle wire depends on: a tuple of
    (i, j, keep_min, keep_max), the min going to wire i and the max to
    wire j, each kept only where a later comparator or the output
    reads it."""
    pairs, p = [], 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    needed, kept = {n // 2}, []
    for i, j in reversed(pairs):
        lo, hi = i in needed, j in needed
        if lo or hi:
            kept.append((i, j, lo, hi))
            needed |= {i, j}
    return tuple(reversed(kept))


def median_blur(img: torch.Tensor, kernel_size: int = 3,
                mode: str = "nearest") -> torch.Tensor:
    """Median filter with an odd square footprint,
    skimage.filters.median(behavior='ndimage') semantics.

    The window's k*k values are strided views of the padded image (no
    stacked copy); the median is the middle wire of a sorting network cut
    to the comparators it depends on (torch.minimum / torch.maximum).
    Every exact median of an odd count is the same float, so this equals
    the reference's full network bit for bit."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    if kernel_size == 1:
        return img
    r = kernel_size // 2
    h, w = img.shape[-2:]
    p = _pad2d(img, r, r, mode)
    vals = [p[..., dy:dy + h, dx:dx + w]
            for dy in range(kernel_size) for dx in range(kernel_size)]
    for i, j, keep_min, keep_max in _median_network(len(vals)):
        a, b = vals[i], vals[j]
        if keep_min:
            vals[i] = torch.minimum(a, b)
        if keep_max:
            vals[j] = torch.maximum(a, b)
    return vals[len(vals) // 2]


def lee_filter(
    img: torch.Tensor,
    kernel_size: int = 5,
    sigma: float | None = None,
    mode: str = "reflect",
) -> torch.Tensor:
    """Lee despeckle filter (Lee, IEEE TPAMI 1980): ``m + k (x - m)`` with
    ``m, v`` the window mean and variance and ``k = v / (v + sigma^2)``.
    ``sigma=None`` takes sigma^2 as each slice's own mean local variance
    (per slice of [..., H, W], as the reference under ``vmap``)."""
    if kernel_size % 2 != 1 or kernel_size < 3:
        raise ValueError("kernel_size must be odd and >= 3")
    if sigma is not None and sigma <= 0:
        raise ValueError("sigma must be > 0 (or omitted to estimate)")
    x = img.to(torch.float32)
    m = box_blur(x, kernel_size, mode)
    v = torch.clamp_min(box_blur(x * x, kernel_size, mode) - m * m, 0.0)
    if sigma is None:
        noise_var = v.mean(dim=(-2, -1), keepdim=True)
    else:
        noise_var = float(np.float32(float(sigma) * float(sigma)))
    k = v / (v + noise_var + 1e-12)
    return m + k * (x - m)


def unsharp_mask(
    img: torch.Tensor,
    radius: float = 1.0,
    amount: float = 1.0,
    mode: str = "nearest",
    clip: bool = True,
) -> torch.Tensor:
    """Unsharp masking, skimage.filters.unsharp_mask semantics:
    ``img + amount * (img - gaussian(img, sigma=radius))``."""
    blurred = gaussian_blur(img, sigma=radius, mode=mode)
    out = img + amount * (img - blurred)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def spatial_weights(kernel_size: int, sigma_space: float) -> np.ndarray:
    """Row-major k*k bilateral spatial weights, float32, computed on the
    host by the reference's numpy arithmetic."""
    r = kernel_size // 2
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    return (
        np.exp(-(dy**2 + dx**2) / (2.0 * float(sigma_space) ** 2))
        .astype(np.float32)
        .ravel()
    )


def bilateral_blur(
    img: torch.Tensor,
    kernel_size: int = 5,
    sigma_color: float = 0.1,
    sigma_space: float = 1.5,
    mode: str = "reflect",
) -> torch.Tensor:
    """Bilateral filter, kornia.filters.bilateral_blur semantics.

    weight(p, q) = exp(-(|p-q|^2) / (2 sigma_space^2))
                 * exp(-(I(p)-I(q))^2 / (2 sigma_color^2))
    out(p) = sum_q w * I(q) / sum_q w   over the odd square window,
    summed in row-major window order.
    """
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    r = kernel_size // 2
    spatial = spatial_weights(kernel_size, sigma_space)
    h, w = img.shape[-2:]
    p = _pad2d(img, r, r, mode)
    # a tensor divisor: CUDA torch turns division by a Python scalar into
    # a multiply by its reciprocal, which is not the reference's division
    two_sc2 = img.new_full((), 2.0 * float(sigma_color) ** 2)
    num = den = None
    for i in range(kernel_size * kernel_size):
        oy, ox = divmod(i, kernel_size)
        q = p[..., oy : oy + h, ox : ox + w]
        d = q - img
        wgt = torch.exp(-(d * d) / two_sc2) * float(spatial[i])
        num = wgt * q if num is None else num + wgt * q
        den = wgt if den is None else den + wgt
    return num / den
