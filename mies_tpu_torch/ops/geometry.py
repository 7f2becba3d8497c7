"""Geometry-family ops, plain PyTorch: ``mies_tpu.ops.geometry``.

  * resize          -> jax.image.resize: each resized axis one product with
    the library's own weight matrix (triangle, Keys cubic, Lanczos 3 / 5;
    the kernel widened by 1/scale when shrinking with antialias; columns
    normalized), built on the host in float32; 'nearest' by float32
    offsets and a floor;
  * center_crop, flip, rot90 -> views and copies (zero padding when the
    crop is larger than the image, torchvision's rule);
  * affine_warp, rotate, perspective_warp -> scipy.ndimage order-1
    sampling: four clamped point gathers per output pixel, blended top
    row, bottom row, then between them; 'constant' reads ``cval`` for any
    sample point outside the input, 'nearest' clamps the coordinates;
  * normalize_meanstd / denormalize_meanstd -> kornia's mean/std pair.

Every op takes float32 ``[..., H, W]`` (any leading batch dims); the warp
coordinates are the same for every slice. The normalize pair is pointwise
and also serves the volume program. Divides are true divisions (a 0-d
tensor divisor: CUDA torch multiplies by the reciprocal of a Python
scalar), as the reference divides.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mies_tpu_torch.ops.histogram import _const

RESIZE_METHODS = ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")


def normalize_meanstd(img: torch.Tensor, mean: float = 0.5,
                      std: float = 0.5) -> torch.Tensor:
    """kornia.enhance.normalize semantics: ``(x - mean) / std``."""
    return (img - mean) / _const(img, std)


def denormalize_meanstd(img: torch.Tensor, mean: float = 0.5,
                        std: float = 0.5) -> torch.Tensor:
    """Inverse of normalize_meanstd: ``x * std + mean``."""
    return img * std + mean


# ---------------------------------------------------------------------------
# resize: jax.image.resize's weights (jax/_src/image/scale.py)
# ---------------------------------------------------------------------------

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values
    is exact in float64): the multiply-adds XLA contracts on the CPU."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = _fma(_fma(_F32(1.5), x, _F32(-2.5)) * x, x, _F32(1.0))
    far = _fma(_fma(_fma(_F32(-0.5), x, _F32(2.5)), x, _F32(-4.0)), x,
               _F32(2.0))
    out = np.where(x >= _F32(1.0), far, out)
    return np.where(x >= _F32(2.0), _F32(0.0), out)


def _lanczos(radius: float, x: np.ndarray) -> np.ndarray:
    rad, pi = _F32(radius), _F32(np.pi)
    y = rad * np.sin(pi * x) * np.sin(pi * x / rad)
    with np.errstate(divide="ignore", invalid="ignore"):
        den = np.where(x != 0, _F32(np.pi**2) * (x * x), _F32(1.0))
        out = np.where(x > _F32(1e-3), y / den, _F32(1.0))
    return np.where(x > rad, _F32(0.0), out).astype(_F32)


_KERNELS = {
    "bilinear": _triangle,
    "bicubic": _keys_cubic,
    "lanczos3": functools.partial(_lanczos, 3.0),
    "lanczos5": functools.partial(_lanczos, 5.0),
}


@functools.lru_cache(maxsize=64)
def resize_weights(m: int, n: int, method: str, antialias: bool) -> np.ndarray:
    """[m, n] float32 weights taking an axis of m samples to n (jax's
    ``compute_weight_mat`` at scale n / m, translation 0), with its float32
    arithmetic in its order; the sample positions and the cubic's
    polynomials as fused multiply-adds, as XLA compiles them on the CPU
    (within 2e-7 of the jitted reference's weights, 5e-6 without)."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(_F32(inv_scale), _F32(1.0)) if antialias else _F32(1.0)
    sample_f = _fma(np.arange(n, dtype=_F32) + _F32(0.5), _F32(inv_scale),
                    _F32(-0.5))
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=_F32)[:, None])
    weights = _KERNELS[method](x / kernel_scale).astype(_F32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=_F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = weights / np.where(total != 0, total, _F32(1.0))
    weights = np.where(np.abs(total) > _F32(1000.0 * np.finfo(np.float32).eps),
                       norm, _F32(0.0))
    inside = (sample_f >= _F32(-0.5)) & (sample_f <= _F32(m - 0.5))
    return np.where(inside[None, :], weights, _F32(0.0)).astype(_F32)


@functools.lru_cache(maxsize=64)
def _nearest_index(m: int, n: int, device: torch.device) -> torch.Tensor:
    """jax's nearest offsets: floor((arange(n) + 0.5) * m / n) in float32."""
    off = (np.arange(n, dtype=_F32) + _F32(0.5)) * _F32(m) / _F32(n)
    return torch.as_tensor(np.floor(off).astype(np.int64), device=device)


@functools.lru_cache(maxsize=64)
def _weights_on(m: int, n: int, method: str, antialias: bool,
                device: torch.device) -> torch.Tensor:
    return torch.as_tensor(resize_weights(m, n, method, antialias),
                           device=device)


def resize(
    img: torch.Tensor,
    height: int,
    width: int,
    method: str = "bilinear",
    antialias: bool = True,
) -> torch.Tensor:
    """Resize [..., H, W] to [..., height, width], jax.image.resize
    semantics (method one of RESIZE_METHODS). An axis whose size does not
    change is left as it is, as jax skips it; the two products run rows
    first unless the column product is the cheaper first step (the order
    jax's einsum takes by operation count)."""
    if method not in RESIZE_METHODS:
        raise ValueError(f"method must be one of {RESIZE_METHODS}, got {method!r}")
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    height, width = int(height), int(width)
    if method == "nearest":
        if height != h:
            x = x.index_select(-2, _nearest_index(h, height, x.device))
        if width != w:
            x = x.index_select(-1, _nearest_index(w, width, x.device))
        return x

    def rows(v):
        wts = _weights_on(h, height, method, bool(antialias), v.device)
        return torch.matmul(wts.t(), v)

    def cols(v):
        wts = _weights_on(w, width, method, bool(antialias), v.device)
        return torch.matmul(v, wts)

    if height == h and width == w:
        return x
    if height == h:
        return cols(x)
    if width == w:
        return rows(x)
    if h * w * width + h * height * width < h * w * height + height * w * width:
        return rows(cols(x))
    return cols(rows(x))


def center_crop(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The central [height, width] window (torchvision: zero padding where
    the crop is larger than the image)."""
    h, w = img.shape[-2:]
    if height > h or width > w:
        ph, pw = max(height - h, 0), max(width - w, 0)
        img = torch.nn.functional.pad(
            img, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        h, w = img.shape[-2:]
    top = (h - height) // 2
    left = (w - width) // 2
    return img[..., top:top + height, left:left + width]


def flip(img: torch.Tensor, horizontal: bool = True,
         vertical: bool = False) -> torch.Tensor:
    """Mirror the image along the requested axes."""
    dims = [d for d, on in ((-1, horizontal), (-2, vertical)) if on]
    return torch.flip(img, dims) if dims else img


def rot90(img: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Rotate by k * 90 degrees counter-clockwise (numpy's rot90)."""
    return torch.rot90(img, int(k) % 4, dims=(-2, -1))


# ---------------------------------------------------------------------------
# warps: scipy.ndimage order-1 sampling
# ---------------------------------------------------------------------------


def _bilinear_sample(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                     mode: str, cval: float) -> torch.Tensor:
    """Sample every slice of ``img`` [..., H, W] at the float32 coordinates
    (iy, ix) [Ho, Wo], scipy order-1 semantics: 'nearest' clamps the
    coordinates to [0, n - 1] first (the edge-replicated input);
    'constant' reads ``cval`` for a point outside [0, n - 1] with no
    interpolation against the edge. The four corners are point gathers of
    the flattened slice at clamped indices, blended top = tl (1 - fx) +
    tr fx, bot likewise, out = top (1 - fy) + bot fy."""
    if mode not in ("nearest", "constant"):
        raise ValueError(f"unsupported warp mode {mode!r}")
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.to(torch.float32).reshape(-1, h * w)
    if mode == "nearest":
        iy = torch.clamp(iy, 0.0, h - 1.0)
        ix = torch.clamp(ix, 0.0, w - 1.0)
    y0, x0 = torch.floor(iy), torch.floor(ix)
    fy, fx = iy - y0, ix - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    ya, yb = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)
    xa, xb = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)

    def at(yy, xx):
        return flat[:, (yy * w + xx).reshape(-1)].reshape(-1, *iy.shape)

    top = at(ya, xa) * (1.0 - fx) + at(ya, xb) * fx
    bot = at(yb, xa) * (1.0 - fx) + at(yb, xb) * fx
    out = top * (1.0 - fy) + bot * fy
    if mode == "constant":
        inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        out = torch.where(inside, out, out.new_full((), float(np.float32(cval))))
    return out.reshape(*lead, *iy.shape)


def _axis_terms(coef: float, add: float, n: int, dev) -> torch.Tensor:
    """float32(coef * arange(n) + add), computed in float64 on the host."""
    t = coef * np.arange(n, dtype=np.float64) + add
    return torch.as_tensor(t.astype(np.float32), device=dev)


def affine_warp(
    img: torch.Tensor,
    matrix,
    offset,
    mode: str = "constant",
    cval: float = 0.0,
) -> torch.Tensor:
    """scipy.ndimage.affine_transform(order=1): out[o] = in[matrix @ o +
    offset], ``matrix`` the 2x2 output->input map [[myy, myx], [mxy,
    mxx]]. Each coordinate is the float32 sum of a per-row and a
    per-column term, each computed in float64 on the host."""
    h, w = img.shape[-2:]
    m = np.asarray(matrix, dtype=np.float64)
    off = np.asarray(offset, dtype=np.float64)
    dev = img.device
    iy = (_axis_terms(m[0, 0], off[0], h, dev)[:, None]
          + _axis_terms(m[0, 1], 0.0, w, dev)[None, :])
    ix = (_axis_terms(m[1, 0], off[1], h, dev)[:, None]
          + _axis_terms(m[1, 1], 0.0, w, dev)[None, :])
    return _bilinear_sample(img, iy, ix, mode, cval)


def rotate(img: torch.Tensor, angle: float, mode: str = "constant",
           cval: float = 0.0) -> torch.Tensor:
    """Rotation about the image centre, bilinear, shape kept:
    scipy.ndimage.rotate(angle, reshape=False, order=1). A multiple of 90
    degrees is the exact permutation where it keeps the shape (and, for a
    non-square slice with h - w even, the rotated slice shifted into place
    with ``cval`` around it), as the reference takes it."""
    h, w = img.shape[-2:]
    if float(angle) % 90.0 == 0.0:
        k = int(round(float(angle) / 90.0)) % 4
        if k == 0:
            return img.to(torch.float32)
        if k == 2 or h == w:
            return rot90(img, k).to(torch.float32)
        if (h - w) % 2 == 0 and mode != "nearest":
            # integer coordinates: out[y, x] = rot90(img, k)[y - d1, x + d1]
            d1 = (h - w) // 2
            rot = rot90(img, k).to(torch.float32)  # [..., w, h]
            out = rot.new_full((*img.shape[:-2], h, w), float(np.float32(cval)))
            y0, y1 = max(0, d1), min(h, d1 + w)
            x0, x1 = max(0, -d1), min(w, h - d1)
            if y1 > y0 and x1 > x0:
                out[..., y0:y1, x0:x1] = rot[..., y0 - d1:y1 - d1,
                                             x0 + d1:x1 + d1]
            return out
    a = np.deg2rad(float(angle))
    c, s = np.cos(a), np.sin(a)
    m = np.array([[c, s], [-s, c]], dtype=np.float64)
    center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    return affine_warp(img, m, center - m @ center, mode=mode, cval=cval)


def perspective_warp(img: torch.Tensor, matrix, mode: str = "constant",
                     cval: float = 0.0) -> torch.Tensor:
    """Projective warp, bilinear, shape kept: ``[yi, xi, wi] = matrix @
    [yo, xo, 1]``, sampled at (yi / wi, xi / wi) (scipy.ndimage.
    geometric_transform(order=1) with that map). Each homogeneous term is
    the float32 sum of a row and a column term computed in float64."""
    m = np.asarray(matrix, dtype=np.float64)
    if m.shape != (3, 3):
        raise ValueError(f"matrix must be 3x3, got {m.shape}")
    if m[2, 2] == 0.0:
        raise ValueError("matrix[2, 2] must be nonzero")
    h, w = img.shape[-2:]
    dev = img.device

    def terms(row):
        return (_axis_terms(m[row, 0], m[row, 2], h, dev)[:, None]
                + _axis_terms(m[row, 1], 0.0, w, dev)[None, :])

    den = terms(2)
    return _bilinear_sample(img, terms(0) / den, terms(1) / den, mode, cval)
