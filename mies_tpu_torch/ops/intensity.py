"""Point-wise intensity transforms and CT Hounsfield-unit windowing, plain
PyTorch.

Same semantics and f32 operation order as ``mies_tpu.ops.intensity``:
``skimage.exposure.adjust_gamma/adjust_log/adjust_sigmoid/
rescale_intensity``, the kornia/PIL enhance ops and the HU window
``clip((hu - (c - w/2)) / w, 0, 1)``.

Every op takes ``[..., H, W]``. The reference compiler maps its ops over
the batch, so a statistic of the image (``normalize``'s and
``rescale_intensity``'s min and max) is taken per image, over the last two
axes; the volume forms (``ops.volume3d``) take it over the last three, the
whole [Z, H, W] volume, as the reference's volume program does. Wherever the reference divides, the port divides by a tensor: torch
runs ``python_scalar / tensor`` as a reciprocal times the scalar, and CUDA
torch runs ``tensor / python_scalar`` as a multiply by the reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.ops.filters import _pad2d
from mies_tpu_torch.ops.histogram import _const, _local

# Standard clinical CT windows (center, width) in Hounsfield units.
HU_PRESETS: dict[str, tuple[float, float]] = {
    "soft_tissue": (40.0, 400.0),
    "lung": (-600.0, 1500.0),
    "bone": (400.0, 1800.0),
    "brain": (40.0, 80.0),
    "liver": (60.0, 160.0),
    "mediastinum": (50.0, 350.0),
    "stroke": (40.0, 40.0),
    "subdural": (75.0, 215.0),
    "abdomen": (50.0, 400.0),
}


def _image_min_max(img: torch.Tensor, nd: int = 2,
                   combine=_local) -> tuple[torch.Tensor, torch.Tensor]:
    """Each image's own min and max over its last ``nd`` axes, shaped to
    broadcast over it. ``combine(t, "min" | "max")`` turns a z band's into
    the whole volume's (``parallel.volume_shard``: an all_reduce)."""
    dims = tuple(range(-nd, 0))
    return (combine(torch.amin(img, dim=dims, keepdim=True), "min"),
            combine(torch.amax(img, dim=dims, keepdim=True), "max"))


def adjust_gamma(img: torch.Tensor, gamma: float = 1.0,
                 gain: float = 1.0) -> torch.Tensor:
    """Gamma correction: ``gain * img ** gamma`` (skimage semantics)."""
    return gain * torch.pow(img, gamma)


def adjust_log(img: torch.Tensor, gain: float = 1.0,
               inv: bool = False) -> torch.Tensor:
    """``gain * log2(1 + img)``, or ``gain * (2**img - 1)`` with inv."""
    if inv:
        return gain * (torch.exp2(img) - 1.0)
    return gain * torch.log2(1.0 + img)


def adjust_sigmoid(img: torch.Tensor, cutoff: float = 0.5, gain: float = 10.0,
                   inv: bool = False) -> torch.Tensor:
    """Sigmoid contrast: ``1 / (1 + exp(gain * (cutoff - img)))``."""
    s = _const(img, 1.0) / (1.0 + torch.exp(gain * (cutoff - img)))
    if inv:
        return 1.0 - s
    return s


def invert(img: torch.Tensor) -> torch.Tensor:
    """Photometric inversion for float [0,1] images: ``1 - img``."""
    return 1.0 - img


def normalize_minmax(img: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Affine rescale of each image's own range to [0, 1]."""
    return _normalize_minmax(img, eps, 2)


def _normalize_minmax(img: torch.Tensor, eps: float, nd: int,
                      combine=_local) -> torch.Tensor:
    lo, hi = _image_min_max(img, nd, combine)
    return (img - lo) / torch.maximum(hi - lo, _const(img, eps))


def rescale_intensity(
    img: torch.Tensor,
    in_range: tuple[float, float] | None = None,
    out_range: tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """skimage.exposure.rescale_intensity: clip to ``in_range`` (each
    image's own (min, max) when None), then the affine map to
    ``out_range``."""
    return _rescale_intensity(img, in_range, out_range, 2)


def _rescale_intensity(img: torch.Tensor, in_range, out_range,
                       nd: int, combine=_local) -> torch.Tensor:
    if in_range is None:
        imin, imax = _image_min_max(img, nd, combine)
    else:
        imin, imax = _const(img, in_range[0]), _const(img, in_range[1])
    omin, omax = out_range
    x = torch.clamp(img, imin, imax)
    scale = _const(img, omax - omin) / torch.maximum(imax - imin,
                                                      _const(img, 1e-12))
    return (x - imin) * scale + omin


def adjust_brightness(img: torch.Tensor, factor: float = 0.0) -> torch.Tensor:
    """kornia.enhance.adjust_brightness: ``clip(img + factor, 0, 1)``."""
    return torch.clamp(img + factor, 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor: float = 1.0) -> torch.Tensor:
    """kornia.enhance.adjust_contrast: ``clip(img * factor, 0, 1)``."""
    return torch.clamp(img * factor, 0.0, 1.0)


def solarize(img: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Invert pixels at or above the threshold (kornia/PIL semantics)."""
    return torch.where(img >= threshold, 1.0 - img, img)


def posterize(img: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Keep the top ``bits`` bits of each uint8 level round(x * 255)
    (kornia/PIL semantics), back to float by / 255."""
    if not 1 <= int(bits) <= 8:
        raise ValueError("bits must be in [1, 8]")
    keep = 256 - (1 << (8 - int(bits)))
    u = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.int32)
    kept = (u & keep).to(torch.float32)
    return kept / _const(kept, 255.0)


def sharpness(img: torch.Tensor, factor: float = 1.0) -> torch.Tensor:
    """kornia.enhance.sharpness-style blend between PIL's 3x3 SMOOTH
    kernel ([[1,1,1],[1,5,1],[1,1,1]]/13, applied to interior pixels only)
    and the original by ``factor``, clipped to [0, 1]. The interior is the
    whole image's: a row band would need its global rows."""
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    p = _pad2d(x, 1, 1, "nearest")
    k = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            # float32(k / 13) taps, added in row-major order from zero
            tap = float(np.float32(k[dy][dx] / 13.0))
            acc = acc + tap * p[..., dy:dy + h, dx:dx + w]
    rows = torch.arange(h, device=x.device)[:, None]
    cols = torch.arange(w, device=x.device)[None, :]
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    smoothed = torch.where(interior, acc, img)
    return torch.clamp(smoothed + factor * (img - smoothed), 0.0, 1.0)


def is_low_contrast(
    img: torch.Tensor,
    fraction_threshold: float = 0.05,
    lower_percentile: float = 1.0,
    upper_percentile: float = 99.0,
) -> torch.Tensor:
    """skimage.exposure.is_low_contrast for float [0, 1] images: the span
    between the lower and upper percentiles of the whole input (float32,
    ``jnp.percentile``'s linear interpolation) is below
    ``fraction_threshold`` of the [0, 1] range. A 0-d bool tensor on the
    input's device, with no host read."""
    flat = img.to(torch.float32).reshape(-1)
    lo = _percentile(flat, lower_percentile)
    hi = _percentile(flat, upper_percentile)
    return (hi - lo) < fraction_threshold


def _percentile(flat: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(flat, p)`` (linear): the float32 position
    ``p / 100 * (n - 1)`` is computed on the host from the size alone,
    its two order statistics by ``torch.kthvalue``, which takes any size
    (``torch.quantile`` refuses more than 2**24 elements)."""
    n = flat.numel()
    pos = np.float32(p) / np.float32(100.0) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(1) - w_high
    i_low = int(min(max(low, 0), n - 1))
    i_high = int(min(max(high, 0), n - 1))
    v_low = torch.kthvalue(flat, i_low + 1).values
    v_high = (v_low if i_high == i_low
              else torch.kthvalue(flat, i_high + 1).values)
    return v_low * float(w_low) + v_high * float(w_high)


def window_hu(
    hu: torch.Tensor,
    center: float | None = None,
    width: float | None = None,
    preset: str | None = None,
) -> torch.Tensor:
    """CT Hounsfield-unit windowing to float [0, 1]:
    ``clip((hu - (center - width/2)) / width, 0, 1)`` in float32.

    ``preset`` names a standard clinical window (``HU_PRESETS``); explicit
    center/width override the preset's. int16 or float input.
    """
    if preset is not None:
        if preset not in HU_PRESETS:
            raise ValueError(
                f"unknown HU preset {preset!r}; available: "
                f"{sorted(HU_PRESETS)}"
            )
        pc, pw = HU_PRESETS[preset]
        center = pc if center is None else center
        width = pw if width is None else width
    if center is None or width is None:
        raise ValueError("window_hu needs center+width or a preset")
    x = hu.to(torch.float32)
    lo = float(center) - float(width) / 2.0
    return torch.clamp((x - lo) / _const(x, width), 0.0, 1.0)
