"""Spatial filters, plain PyTorch.

Same semantics and operation order as ``mies_tpu.ops.filters``:
  * gaussian_blur  -> skimage.filters.gaussian (truncate 4, scipy pads
    applied per 1-D pass, ascending-tap shifted adds);
  * unsharp_mask   -> img + amount * (img - gaussian(img, radius)), clipped;
  * bilateral_blur -> kornia.filters.bilateral_blur (explicit odd window);
  * median_blur    -> skimage.filters.median (odd square footprint);
  * guided_blur    -> kornia.filters.guided_blur (He et al., box means);
  * the edge magnitudes (sobel, scharr, prewitt, farid, roberts), laplace,
    laplacian_sharpen, difference_of_gaussians, retinex and kuwahara as
    shifted adds in the reference's order;
  * gabor, gabor_bank and motion_blur -> scipy.ndimage.convolve with a
    dense kernel, one ``F.conv2d``.

Borders are built by INDEX from numpy's ``np.pad`` arithmetic: the
reference's default bilateral mode 'reflect' is numpy 'symmetric', which
``torch.nn.functional.pad`` does not have (its 'reflect' is numpy
'reflect'). ``F.conv2d`` serves only the dense kernels: its reduction
order is not the scipy tap order, so the separable filters stay shifted
adds (the row-band sharding needs their bits to be independent of the
image size), and it runs in float32 on the card because
``mies_tpu_torch`` turns TF32 off at import.

Every function takes float32 ``[..., H, W]`` (any leading batch dims) and
runs on the tensor's own device. These are also the plain versions the
K3/K4 kernels are held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.histogram import _const

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
    summed in row-major window order: the self-guided
    ``joint_bilateral_blur``.
    """
    return joint_bilateral_blur(img, img, kernel_size, sigma_color,
                                sigma_space, mode)


def joint_bilateral_blur(
    img: torch.Tensor,
    guide: torch.Tensor,
    kernel_size: int = 5,
    sigma_color: float = 0.1,
    sigma_space: float = 1.5,
    mode: str = "reflect",
) -> torch.Tensor:
    """Joint (cross) bilateral filter, kornia.filters.joint_bilateral_blur
    semantics: the range weights come from ``guide``, the values from
    ``img`` (of the same shape), summed in row-major window order. With
    ``guide is img`` it is ``bilateral_blur`` bit for bit. A library
    function: a chain's stage has no second input."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    if guide.shape != img.shape:
        raise ValueError(
            f"guide shape {tuple(guide.shape)} != image shape "
            f"{tuple(img.shape)}")
    r = kernel_size // 2
    spatial = spatial_weights(kernel_size, sigma_space)
    h, w = img.shape[-2:]
    p = _pad2d(img, r, r, mode)
    g = p if guide is img else _pad2d(guide, r, r, mode)
    # a tensor divisor: CUDA torch turns division by a Python scalar into
    # a multiply by its reciprocal, which is not the reference's division
    two_sc2 = img.new_full((), 2.0 * float(sigma_color) ** 2)
    num = den = None
    for i in range(kernel_size * kernel_size):
        oy, ox = divmod(i, kernel_size)
        q = p[..., oy : oy + h, ox : ox + w]
        d = g[..., oy : oy + h, ox : ox + w] - guide
        wgt = torch.exp(-(d * d) / two_sc2) * float(spatial[i])
        num = wgt * q if num is None else num + wgt * q
        den = wgt if den is None else den + wgt
    return num / den


def denoise_bilateral(
    img: torch.Tensor,
    sigma_color: float = 0.1,
    sigma_spatial: float = 1.0,
    mode: str = "edge",
) -> torch.Tensor:
    """skimage.restoration.denoise_bilateral-style entry point: the
    bilateral filter over the window ``max(5, 2 * ceil(3 sigma) + 1)``."""
    return bilateral_blur(img, denoise_bilateral_window(sigma_spatial),
                          sigma_color, sigma_spatial, mode)


def denoise_bilateral_window(sigma_spatial: float) -> int:
    """denoise_bilateral's odd window: max(5, 2 * ceil(3 sigma) + 1)."""
    return max(5, 2 * int(np.ceil(3.0 * float(sigma_spatial))) + 1)


# ---------------------------------------------------------------------------
# Edges and Laplacians (skimage.filters / scipy.ndimage semantics)
# ---------------------------------------------------------------------------

_DERIV = np.array([-1.0, 0.0, 1.0], np.float32) / 2.0
# np.float32(sqrt(2)): the magnitudes' [0, 1]-bounding scale
_SQRT2 = float(np.sqrt(2.0).astype(np.float32))


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on any device: the
    float64 root of a float32 value rounds to the float32 one exactly. The
    CPU's vectorized ``torch.sqrt`` is off by an ulp on about an eighth of
    inputs, and a root an ulp apart moves TV's output by ulps on the card
    against the CPU, enough to flip a CLAHE level downstream."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _magnitude(gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) / sqrt(2), a true division."""
    return _sqrt_rn(gx * gx + gy * gy) / _const(gy, _SQRT2)


def _edge_magnitude(img: torch.Tensor, smooth: np.ndarray, edge: np.ndarray,
                    mode: str) -> torch.Tensor:
    """sqrt(gy^2 + gx^2) / sqrt(2) over separable smooth x derivative
    taps, the skimage.filters gradient-magnitude convention shared by
    sobel, scharr, prewitt and farid."""
    gy = _sep_conv2d(img, edge, smooth, mode)
    gx = _sep_conv2d(img, smooth, edge, mode)
    return _magnitude(gy, gx)


def sobel_edges(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Sobel gradient magnitude (skimage.filters.sobel): axis kernels
    [1, 2, 1]/4 x [-1, 0, 1]/2."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32) / 4.0
    return _edge_magnitude(img, smooth, _DERIV, mode)


def scharr_edges(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Scharr gradient magnitude (skimage.filters.scharr): axis kernels
    [3, 10, 3]/16 x [-1, 0, 1]/2."""
    smooth = np.array([3.0, 10.0, 3.0], np.float32) / 16.0
    return _edge_magnitude(img, smooth, _DERIV, mode)


def prewitt_edges(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Prewitt gradient magnitude (skimage.filters.prewitt): axis kernels
    [1, 1, 1]/3 x [-1, 0, 1]/2."""
    smooth = np.array([1.0, 1.0, 1.0], np.float32) / 3.0
    return _edge_magnitude(img, smooth, _DERIV, mode)


# Farid & Simoncelli (2004) optimal 5-tap interpolator and derivative, at
# the reference's precision
_FARID_P = np.array(
    [0.0376593171958126, 0.249153396177344, 0.426374573253687,
     0.249153396177344, 0.0376593171958126], np.float32,
)
_FARID_D1 = np.array(
    [0.109603762960254, 0.276690988455557, 0.0,
     -0.276690988455557, -0.109603762960254], np.float32,
)


def farid_edges(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Farid gradient magnitude (skimage.filters.farid): the
    Farid-Simoncelli 5-tap interpolator/derivative pair."""
    return _edge_magnitude(img, _FARID_P, _FARID_D1, mode)


def roberts_edges(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Roberts cross gradient magnitude (skimage.filters.roberts): the
    forward cross differences x[i+1, j+1] - x[i, j] and x[i+1, j] -
    x[i, j+1] on the ``mode``-padded image, sqrt(pos^2 + neg^2) / sqrt(2)."""
    h, w = img.shape[-2:]
    x = _pad2d(img.to(torch.float32), 1, 1, mode)
    pos = x[..., 2:2 + h, 2:2 + w] - x[..., 1:1 + h, 1:1 + w]
    neg = x[..., 2:2 + h, 1:1 + w] - x[..., 1:1 + h, 2:2 + w]
    return _sqrt_rn(pos * pos + neg * neg) / _const(img, _SQRT2)


def laplace(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """4-neighbour Laplacian, scipy.ndimage.laplace: the sum of the
    per-axis [1, -2, 1] second differences."""
    taps = np.array([1.0, -2.0, 1.0], np.float32)
    one = np.ones(1, np.float32)
    return _sep_conv2d(img, taps, one, mode) + _sep_conv2d(img, one, taps, mode)


def laplacian_sharpen(img: torch.Tensor, alpha: float = 0.2,
                      mode: str = "reflect") -> torch.Tensor:
    """Sharpen by the 4-neighbour Laplacian: clip(img - alpha * lap(img),
    0, 1), lap summed up + down + left + right - 4 img."""
    h, w = img.shape[-2:]
    p = _pad2d(img, 1, 1, mode)
    lap = (p[..., 0:h, 1:1 + w] + p[..., 2:2 + h, 1:1 + w]
           + p[..., 1:1 + h, 0:w] + p[..., 1:1 + h, 2:2 + w] - 4.0 * img)
    return torch.clamp(img - alpha * lap, 0.0, 1.0)


def difference_of_gaussians(
    img: torch.Tensor,
    low_sigma: float = 1.0,
    high_sigma: float | None = None,
    truncate: float = 4.0,
    mode: str = "nearest",
) -> torch.Tensor:
    """Band-pass by Gaussian difference (skimage.filters.
    difference_of_gaussians): gaussian(low_sigma) - gaussian(high_sigma),
    high_sigma 1.6 * low_sigma by default."""
    if high_sigma is None:
        high_sigma = float(low_sigma) * 1.6
    if high_sigma < low_sigma:
        raise ValueError(
            f"high_sigma ({high_sigma}) must be >= low_sigma ({low_sigma})"
        )
    x = img.to(torch.float32)
    return (gaussian_blur(x, float(low_sigma), truncate, mode)
            - gaussian_blur(x, float(high_sigma), truncate, mode))


# ---------------------------------------------------------------------------
# Dense 2-D kernels: Gabor and motion blur
# ---------------------------------------------------------------------------


def _gabor_sigma_prefactor(bandwidth: float) -> float:
    b = float(bandwidth)
    return (1.0 / np.pi * np.sqrt(np.log(2.0) / 2.0)
            * (2.0**b + 1.0) / (2.0**b - 1.0))


@functools.lru_cache(maxsize=64)
def gabor_kernel(
    frequency: float,
    theta: float = 0.0,
    bandwidth: float = 1.0,
    sigma_x: float | None = None,
    sigma_y: float | None = None,
    n_stds: int = 3,
    offset: float = 0.0,
) -> np.ndarray:
    """Complex 2-D Gabor kernel (skimage.filters.gabor_kernel): the
    sigma-from-bandwidth prefactor, the rotated support ceil(max(n_stds
    sx |cos|, n_stds sy |sin|, 1)) and the 1/(2 pi sx sy) normalization.
    Host-side, complex128."""
    if sigma_x is None:
        sigma_x = _gabor_sigma_prefactor(bandwidth) / float(frequency)
    if sigma_y is None:
        sigma_y = _gabor_sigma_prefactor(bandwidth) / float(frequency)
    ct, st = np.cos(float(theta)), np.sin(float(theta))
    x0 = int(np.ceil(max(abs(n_stds * sigma_x * ct),
                         abs(n_stds * sigma_y * st), 1.0)))
    y0 = int(np.ceil(max(abs(n_stds * sigma_y * ct),
                         abs(n_stds * sigma_x * st), 1.0)))
    y, x = np.meshgrid(
        np.arange(-y0, y0 + 1, dtype=np.float64),
        np.arange(-x0, x0 + 1, dtype=np.float64),
        indexing="ij",
    )
    rotx = x * ct + y * st
    roty = -x * st + y * ct
    g = np.exp(-0.5 * (rotx**2 / sigma_x**2 + roty**2 / sigma_y**2))
    g /= 2.0 * np.pi * sigma_x * sigma_y
    return g * np.exp(1j * (2.0 * np.pi * float(frequency) * rotx
                            + float(offset)))


def _dense_conv2d(xp: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """VALID scipy.ndimage.convolve of border-padded slices with a stack
    of dense kernels: xp [..., Hp, Wp], kernels [C, kh, kw] (unflipped,
    host float64) -> [..., C, Hp - kh + 1, Wp - kw + 1] float32. One
    ``conv2d`` over the slices as a batch of one channel, the C flipped
    kernels as output channels (a convolution is a correlation with the
    flipped taps). TF32 is off (``mies_tpu_torch`` turns it off at import),
    so cuDNN sums in float32; its order is not scipy's, so the result is
    atol-level, not bit-level, against the reference."""
    kernels = np.asarray(kernels)
    c, kh, kw = kernels.shape
    lead, (hp, wp) = xp.shape[:-2], xp.shape[-2:]
    taps = torch.from_numpy(np.ascontiguousarray(
        kernels[:, None, ::-1, ::-1]).astype(np.float32)).to(xp.device)
    out = F.conv2d(xp.to(torch.float32).reshape(-1, 1, hp, wp), taps)
    return out.reshape(*lead, c, hp - kh + 1, wp - kw + 1)


def _gabor_kernels(frequency, thetas, bandwidth, sigma_x, sigma_y, n_stds,
                   offset) -> list[np.ndarray]:
    return [
        gabor_kernel(float(frequency), float(th), float(bandwidth),
                     None if sigma_x is None else float(sigma_x),
                     None if sigma_y is None else float(sigma_y),
                     int(n_stds), float(offset))
        for th in thetas
    ]


def gabor_response(
    img: torch.Tensor,
    frequency: float,
    theta: float = 0.0,
    bandwidth: float = 1.0,
    sigma_x: float | None = None,
    sigma_y: float | None = None,
    n_stds: int = 3,
    offset: float = 0.0,
    mode: str = "reflect",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(real, imag) Gabor responses, skimage.filters.gabor: the image
    convolved with the kernel's real and imaginary parts."""
    (g,) = _gabor_kernels(frequency, (theta,), bandwidth, sigma_x, sigma_y,
                          n_stds, offset)
    ry, rx = g.shape[0] // 2, g.shape[1] // 2
    xp = _pad2d(img.to(torch.float32), ry, rx, mode)
    out = _dense_conv2d(xp, np.stack([g.real, g.imag]))
    return out[..., 0, :, :], out[..., 1, :, :]


def gabor(
    img: torch.Tensor,
    frequency: float = 0.1,
    theta: float = 0.0,
    bandwidth: float = 1.0,
    sigma_x: float | None = None,
    sigma_y: float | None = None,
    n_stds: int = 3,
    offset: float = 0.0,
    mode: str = "reflect",
    output: str = "magnitude",
) -> torch.Tensor:
    """Gabor texture filter as a chain stage: ``output`` selects the
    magnitude sqrt(re^2 + im^2), the real or the imaginary response."""
    if output not in ("magnitude", "real", "imag"):
        raise ValueError(
            f"output must be 'magnitude', 'real' or 'imag', got {output!r}")
    re, im = gabor_response(img, frequency, theta, bandwidth, sigma_x,
                            sigma_y, n_stds, offset, mode)
    if output == "magnitude":
        return _sqrt_rn(re * re + im * im)
    return re if output == "real" else im


def gabor_bank(
    img: torch.Tensor,
    frequency: float = 0.1,
    n_orientations: int = 8,
    bandwidth: float = 1.0,
    sigma_x: float | None = None,
    sigma_y: float | None = None,
    n_stds: int = 3,
    offset: float = 0.0,
    mode: str = "reflect",
    output: str = "max",
) -> torch.Tensor:
    """Orientation-pooled Gabor energy: the magnitudes at theta_k = k pi /
    n_orientations, pooled by 'max' or 'mean'. Every orientation's kernel
    pair is zero-padded to the bank's largest support and the 2N kernels
    run as one conv2d."""
    if n_orientations < 1:
        raise ValueError("n_orientations must be >= 1")
    if output not in ("max", "mean"):
        raise ValueError(f"output must be 'max' or 'mean', got {output!r}")
    n = int(n_orientations)
    kernels = _gabor_kernels(frequency, [k * np.pi / n for k in range(n)],
                             bandwidth, sigma_x, sigma_y, n_stds, offset)
    ry = max(g.shape[0] // 2 for g in kernels)
    rx = max(g.shape[1] // 2 for g in kernels)
    stack = np.zeros((2 * n, 2 * ry + 1, 2 * rx + 1), np.float64)
    for i, g in enumerate(kernels):
        gy, gx = g.shape[0] // 2, g.shape[1] // 2
        sl = (slice(ry - gy, ry + gy + 1), slice(rx - gx, rx + gx + 1))
        stack[2 * i][sl] = g.real
        stack[2 * i + 1][sl] = g.imag
    xp = _pad2d(img.to(torch.float32), ry, rx, mode)
    resp = _dense_conv2d(xp, stack)
    re, im = resp[..., 0::2, :, :], resp[..., 1::2, :, :]
    mags = _sqrt_rn(re * re + im * im)  # [..., N, H, W]
    if output == "max":
        return mags.amax(dim=-3)
    return mags.mean(dim=-3)


@functools.lru_cache(maxsize=64)
def motion_blur_kernel(kernel_size: int, angle: float,
                       direction: float = 0.0) -> np.ndarray:
    """Directional motion-blur PSF (kornia.filters.motion_blur's recipe):
    a horizontal line of linspace weights, uniform at ``direction`` 0,
    rotated ``angle`` degrees counter-clockwise about the centre
    (scipy.ndimage.rotate, order 1, shape kept), clipped at 0 and
    normalized to sum 1. Host-side, float64."""
    from scipy import ndimage

    k = int(kernel_size)
    if k % 2 != 1 or k < 3:
        raise ValueError("kernel_size must be odd and >= 3")
    d = (min(max(float(direction), -1.0), 1.0) + 1.0) / 2.0
    kern = np.zeros((k, k), np.float64)
    kern[k // 2, :] = np.linspace(d, 1.0 - d, k)
    if float(angle) % 360.0 != 0.0:
        kern = ndimage.rotate(kern, float(angle), reshape=False, order=1)
        kern = np.clip(kern, 0.0, None)
    return kern / kern.sum()


def motion_blur(
    img: torch.Tensor,
    kernel_size: int = 9,
    angle: float = 0.0,
    direction: float = 0.0,
    mode: str = "constant",
) -> torch.Tensor:
    """Directional motion blur: the image correlated with
    ``motion_blur_kernel`` (a convolution with the flipped kernel) over
    the ``mode``-padded image."""
    kern = motion_blur_kernel(int(kernel_size), float(angle), float(direction))
    r = kern.shape[0] // 2
    xp = _pad2d(img.to(torch.float32), r, r, mode)
    flipped = np.ascontiguousarray(kern[::-1, ::-1])
    return _dense_conv2d(xp, flipped[None])[..., 0, :, :]


# ---------------------------------------------------------------------------
# Retinex and Kuwahara
# ---------------------------------------------------------------------------


def retinex(
    img: torch.Tensor,
    sigmas: tuple = (2.0, 8.0, 30.0),
    weights: tuple | None = None,
    eps: float = 1.0 / 255.0,
    gain: float = 1.0,
    rescale: str = "clip",
    mode: str = "nearest",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Multiscale retinex (Jobson, Rahman & Woodell 1997): sum_k w_k
    (log(I + eps) - log(G_sigma_k(I) + eps)). 'clip' maps it through
    clip(0.5 + gain * msr, 0, 1); 'minmax' stretches each slice to its own
    range. Each scale's blur is ``gaussian_blur(sigma_k)``'s shifted adds:
    sigma 30 is two passes of 241 taps."""
    if not sigmas or any(s <= 0 for s in sigmas):
        raise ValueError("sigmas must be a non-empty tuple of numbers > 0")
    if weights is None:
        weights = (1.0 / len(sigmas),) * len(sigmas)
    if len(weights) != len(sigmas):
        raise ValueError(
            f"weights must match sigmas ({len(sigmas)}), got {len(weights)}")
    if rescale not in ("clip", "minmax"):
        raise ValueError(f"rescale must be 'clip' or 'minmax', got {rescale!r}")
    if eps <= 0:
        raise ValueError("eps must be > 0")
    x = img.to(torch.float32)
    e32 = float(np.float32(eps))
    logx = torch.log(x + e32)
    msr = torch.zeros_like(x)
    for s, w in zip(sigmas, weights):
        k = gaussian_kernel1d(float(s), int(truncate * float(s) + 0.5))
        blur = _sep_conv2d(x, k, k, mode)
        msr = msr + float(np.float32(w)) * (logx - torch.log(blur + e32))
    if rescale == "minmax":
        lo = msr.amin(dim=(-2, -1), keepdim=True)
        hi = msr.amax(dim=(-2, -1), keepdim=True)
        return (msr - lo) / torch.clamp_min(hi - lo, float(np.float32(1e-12)))
    return torch.clamp(0.5 + float(np.float32(gain)) * msr, 0.0, 1.0)


def kuwahara(img: torch.Tensor, kernel_size: int = 5,
             mode: str = "reflect") -> torch.Tensor:
    """Kuwahara smoother (Kuwahara et al. 1976): each pixel takes the mean
    of the lowest-variance of its four (r+1) x (r+1) corner quadrants; a
    tie keeps the earlier of (top-left, top-right, bottom-left,
    bottom-right) (strict <). The quadrant sums are one pair of
    shifted-window sums of x and x^2, q rows then q columns, in the
    reference's order."""
    if kernel_size % 2 != 1 or kernel_size < 3:
        raise ValueError("kernel_size must be odd and >= 3")
    r = kernel_size // 2
    q = r + 1
    h, w = img.shape[-2:]
    xp = _pad2d(img.to(torch.float32), r, r, mode)

    def win_sums(a):
        rs = a[..., 0:h + r, :]
        for t in range(1, q):
            rs = rs + a[..., t:t + h + r, :]
        out = rs[..., :, 0:w + r]
        for t in range(1, q):
            out = out + rs[..., :, t:t + w + r]
        return out

    inv_n = float(np.float32(1.0 / (q * q)))
    s1 = win_sums(xp) * inv_n
    s2 = win_sums(xp * xp) * inv_n
    vfull = torch.clamp_min(s2 - s1 * s1, 0.0)
    offs = ((0, 0), (0, r), (r, 0), (r, r))
    best_m = s1[..., 0:h, 0:w]
    best_v = vfull[..., 0:h, 0:w]
    for dy, dx in offs[1:]:
        mq = s1[..., dy:dy + h, dx:dx + w]
        vq = vfull[..., dy:dy + h, dx:dx + w]
        take = vq < best_v
        best_m = torch.where(take, mq, best_m)
        best_v = torch.where(take, vq, best_v)
    return best_m
