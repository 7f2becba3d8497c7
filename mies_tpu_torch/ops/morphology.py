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

Every function takes float32 ``[..., H, W]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.filters import _pad2d

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
