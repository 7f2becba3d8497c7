"""Grayscale morphology with flat structuring elements, plain PyTorch.

Same semantics as ``mies_tpu.ops.morphology`` (cv2-compatible):

  * erode / dilate  -> cv2.erode / cv2.dilate with
    ``cv2.getStructuringElement(shape, (k, k))`` (rect / ellipse / cross,
    the ellipse rows by cvRound, half to even);
  * morph_open/close/gradient, top_hat, black_hat
                    -> cv2.morphologyEx MORPH_OPEN / CLOSE / GRADIENT /
                       TOPHAT / BLACKHAT;
  * mode='ignore' (default) -> cv2's default morphology border: the
    outside never wins the min or max (a +inf pad for erode, -inf for
    dilate). Any ``filters._PAD_MODE`` name is an explicit border instead
    ('nearest' == cv2.BORDER_REPLICATE).

Min and max are exact in any order, so the window is reduced in whatever
form takes the fewest launches: a rect element as a row pass and a column
pass, each one ``amax``/``amin`` over an unfolded view of the padded
image; an ellipse or a cross (rows of centred spans) as one row pass per
distinct span width and then one min or max per element row.

The rolling ball (``rolling_ball``, ``subtract_background``) is the
non-flat opening of ``mies_tpu.ops.morphology``: a min of x - s and a max
of x + s over the ball's heights s, each term a shifted view, reduced in
the reference's order (bit-equal by construction), optionally on a
pyramid-shrunken image (ImageJ's schedule).

Every function takes float32 ``[..., H, W]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.filters import _pad2d
from mies_tpu_torch.ops.pyramid import pyr_down, pyr_up

_SE_SHAPES = ("rect", "ellipse", "cross")
# cv2's default morphology border: a constant the reduction ignores
_IGNORE = "ignore"


@functools.lru_cache(maxsize=64)
def structuring_element(kernel_size: int, shape: str = "rect") -> tuple:
    """cv2.getStructuringElement for a square (k, k) element, as a
    tuple-of-tuples bool mask. The ellipse row at dy from the centre has
    the half-width cvRound(r * sqrt(1 - (dy / r)^2)) (np.rint: half to
    even, as cvRound)."""
    k = int(kernel_size)
    if k < 1 or k % 2 != 1:
        raise ValueError("kernel_size must be an odd int >= 1")
    if shape not in _SE_SHAPES:
        raise ValueError(f"shape must be one of {_SE_SHAPES}")
    r = k // 2
    se = np.zeros((k, k), dtype=bool)
    if shape == "rect" or k == 1:
        se[:] = True
    elif shape == "cross":
        se[r, :] = True
        se[:, r] = True
    else:  # ellipse
        inv_r2 = 1.0 / (r * r) if r else 0.0
        for i in range(k):
            dy = i - r
            if abs(dy) <= r:
                dx = int(np.rint(r * np.sqrt((r * r - dy * dy) * inv_r2)))
                se[i, max(r - dx, 0): min(r + dx + 1, k)] = True
    return tuple(map(tuple, se.tolist()))


def _sliding(p: torch.Tensor, k: int, dim: int, maximum: bool) -> torch.Tensor:
    """min or max over every length-k window along ``dim`` of p ('valid':
    the output is k - 1 shorter), one reduction over an unfolded view."""
    if k == 1:
        return p
    win = p.unfold(dim, k, 1)
    return win.amax(-1) if maximum else win.amin(-1)


def _extremum(img: torch.Tensor, kernel_size: int, shape: str, mode: str,
              maximum: bool) -> torch.Tensor:
    """min or max over the structuring element's shifted windows."""
    k = int(kernel_size)
    se = np.asarray(structuring_element(k, shape), dtype=bool)
    r = k // 2
    if r == 0:
        return img
    h, w = img.shape[-2:]
    if mode == _IGNORE:
        fill = float("-inf") if maximum else float("inf")
        p = F.pad(img, (r, r, r, r), value=fill)
    else:
        p = _pad2d(img, r, r, mode)
    if shape == "rect":
        # 'valid' over the (h + 2r, w + 2r) pad is exactly (h, w)
        return _sliding(_sliding(p, k, -1, maximum), k, -2, maximum)
    # the element's rows are centred spans: one row pass per distinct
    # width, then the k rows combined
    widths = [int(se[dy].sum()) for dy in range(k)]
    by_width = {wd: _sliding(p, wd, -1, maximum) for wd in set(widths)}
    red = torch.maximum if maximum else torch.minimum
    out = None
    for dy, wd in enumerate(widths):
        c0 = r - wd // 2
        v = by_width[wd][..., dy:dy + h, c0:c0 + w]
        out = v if out is None else red(out, v)
    return out


def erode(img: torch.Tensor, kernel_size: int = 3, shape: str = "rect",
          mode: str = _IGNORE) -> torch.Tensor:
    """Grayscale erosion (cv2.erode): min over the structuring element."""
    return _extremum(img, kernel_size, shape, mode, maximum=False)


def dilate(img: torch.Tensor, kernel_size: int = 3, shape: str = "rect",
           mode: str = _IGNORE) -> torch.Tensor:
    """Grayscale dilation (cv2.dilate): max over the structuring element."""
    return _extremum(img, kernel_size, shape, mode, maximum=True)


def morph_open(img: torch.Tensor, kernel_size: int = 3, shape: str = "rect",
               mode: str = _IGNORE) -> torch.Tensor:
    """Opening: dilate(erode(img)), which removes small bright specks."""
    return dilate(erode(img, kernel_size, shape, mode),
                  kernel_size, shape, mode)


def morph_close(img: torch.Tensor, kernel_size: int = 3, shape: str = "rect",
                mode: str = _IGNORE) -> torch.Tensor:
    """Closing: erode(dilate(img)), which fills small dark gaps."""
    return erode(dilate(img, kernel_size, shape, mode),
                 kernel_size, shape, mode)


def morph_gradient(img: torch.Tensor, kernel_size: int = 3,
                   shape: str = "rect", mode: str = _IGNORE) -> torch.Tensor:
    """Morphological gradient: dilate - erode (edge outlines)."""
    return (dilate(img, kernel_size, shape, mode)
            - erode(img, kernel_size, shape, mode))


def top_hat(img: torch.Tensor, kernel_size: int = 3, shape: str = "rect",
            mode: str = _IGNORE) -> torch.Tensor:
    """White top-hat: img - open(img), the small bright structures."""
    return img - morph_open(img, kernel_size, shape, mode)


def black_hat(img: torch.Tensor, kernel_size: int = 3, shape: str = "rect",
              mode: str = _IGNORE) -> torch.Tensor:
    """Black top-hat: close(img) - img, the small dark structures."""
    return morph_close(img, kernel_size, shape, mode) - img


# ---------------------------------------------------------------------------
# Rolling-ball background (Sternberg 1983): non-flat ball morphology
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _ball_table(radius: float, intensity: float) -> np.ndarray:
    """[k, k] float32 ellipsoid heights intensity * sqrt(1 - d^2 / r^2)
    (skimage's ellipsoid_kernel; intensity == radius is the ball), -inf
    outside d^2 <= r^2: erosion reads img - s (+inf never wins the min),
    dilation e + s (-inf never wins the max)."""
    R = int(np.ceil(radius))
    dy, dx = np.mgrid[-R:R + 1, -R:R + 1].astype(np.float64)
    d2 = (dy * dy + dx * dx) / (radius * radius)
    s = intensity * np.sqrt(np.maximum(1.0 - d2, 0.0))
    s[d2 > 1.0] = -np.inf
    return s.astype(np.float32)


def _rb_pass(rows_padded: torch.Tensor, table: np.ndarray,
             maximum: bool) -> torch.Tensor:
    """One non-flat erode (min of x - s) or dilate (max of x + s) pass.
    ``rows_padded`` is [..., h + 2R, W] with the row border applied (+inf
    rows for the min pass, -inf for the max: the outside never wins); the
    columns are padded here. For each of the k table rows, the k shifted
    terms of one row slab reduced in order, then folded into the running
    result: 2 k^2 elementwise launches, exact in any order."""
    k = table.shape[0]
    R = k // 2
    h = rows_padded.shape[-2] - 2 * R
    w = rows_padded.shape[-1]
    fill = float("-inf") if maximum else float("inf")
    p = F.pad(rows_padded, (R, R), value=fill)
    red = torch.maximum if maximum else torch.minimum
    acc = None
    for i in range(k):
        slab = p[..., i:i + h, :]
        m = None
        for dx in range(k):
            t = float(table[i, dx])
            v = slab[..., dx:dx + w] + t if maximum else slab[..., dx:dx + w] - t
            m = v if m is None else red(m, v)
        acc = m if acc is None else red(acc, m)
    return acc


def _imagej_shrink(radius: float) -> int:
    """ImageJ's RollingBall shrink schedule: radius <= 10 exact, <= 30 on a
    half-size image, <= 100 a quarter, else an eighth."""
    if radius <= 10:
        return 1
    if radius <= 30:
        return 2
    if radius <= 100:
        return 4
    return 8


def _resolve_downscale(downscale, radius: float) -> int:
    if downscale == "auto":
        return _imagej_shrink(float(radius))
    if not (isinstance(downscale, int) and not isinstance(downscale, bool)
            and downscale >= 1 and downscale & (downscale - 1) == 0):
        raise ValueError(
            "downscale must be 'auto' or a power-of-two int >= 1, "
            f"got {downscale!r}"
        )
    return downscale


def rolling_ball(
    img: torch.Tensor,
    radius: float = 25.0,
    intensity: float | None = None,
    downscale: int | str = 1,
) -> torch.Tensor:
    """Background by the rolling-ball algorithm (skimage.restoration.
    rolling_ball's contract): grayscale opening by the non-flat ball of
    ``radius``, heights ``intensity`` (radius by default). ``downscale``
    (a power of two or "auto", ImageJ's schedule) computes it on a
    ``pyr_down``-shrunken image with radius / downscale and ``pyr_up``s
    it back."""
    if not (isinstance(radius, (int, float)) and radius > 0):
        raise ValueError(f"radius must be a number > 0, got {radius!r}")
    if intensity is None:
        intensity = float(radius)
    if not (isinstance(intensity, (int, float)) and intensity > 0):
        raise ValueError(f"intensity must be a number > 0, got {intensity!r}")
    downscale = _resolve_downscale(downscale, radius)
    x = img.to(torch.float32)
    if downscale > 1:
        shapes = [tuple(x.shape[-2:])]
        small = x
        for _ in range(downscale.bit_length() - 1):
            small = pyr_down(small)
            shapes.append(tuple(small.shape[-2:]))
        bg = rolling_ball(small, radius / downscale, float(intensity))
        for target in reversed(shapes[:-1]):
            bg = pyr_up(bg, target)
        return bg
    # the opening: the min pass under +inf rows, the max pass under -inf
    table = _ball_table(float(radius), float(intensity))
    R = table.shape[0] // 2
    e = _rb_pass(F.pad(x, (0, 0, R, R), value=float("inf")), table, False)
    return _rb_pass(F.pad(e, (0, 0, R, R), value=float("-inf")), table, True)


def subtract_background(
    img: torch.Tensor,
    radius: float = 25.0,
    intensity: float | None = None,
    light_background: bool = False,
    downscale: int | str = "auto",
) -> torch.Tensor:
    """ImageJ-style background subtraction: clip(img - rolling_ball(img),
    0, 1); ``light_background`` inverts, flattens and re-inverts. Default
    intensity radius / 255 (ImageJ's 8-bit equivalence), default
    downscale "auto" (ImageJ's shrink schedule)."""
    if intensity is None:
        if not (isinstance(radius, (int, float)) and radius > 0):
            raise ValueError(f"radius must be a number > 0, got {radius!r}")
        intensity = float(radius) / 255.0
    downscale = _resolve_downscale(downscale, radius)
    x = img.to(torch.float32)
    if light_background:
        inv = 1.0 - x
        return 1.0 - torch.clamp(
            inv - rolling_ball(inv, radius, intensity, downscale), 0.0, 1.0)
    return torch.clamp(x - rolling_ball(x, radius, intensity, downscale),
                       0.0, 1.0)
