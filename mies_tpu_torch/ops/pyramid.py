"""Laplacian-pyramid ops, plain PyTorch: cv2-exact pyrDown / pyrUp and
MUSICA contrast enhancement (Vuylsteke & Schoeters, SPIE 2167, 1994).

Same semantics and f32 operation order as ``mies_tpu.ops.pyramid``, on
float32 ``[..., H, W]`` (every leading index a slice):

  * ``pyr_down``: Burt-Adelson 5-tap [1,4,6,4,1]/16 per axis with
    BORDER_REFLECT_101 ('mirror'), then even-index decimation: ceil(n/2)
    per axis, == cv2.pyrDown;
  * ``pyr_up``: zero insertion to (2h, 2w), the same filter times 4,
    cropped to ``out_shape`` after filtering (cv2's odd dstsize), computed
    as a polyphase pass: the inserted zeros add exact +0 terms.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.ops.filters import _conv1d_shifted

# Burt-Adelson generating kernel (cv2.pyrDown/pyrUp's fixed filter)
_BURT = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown: Burt blur + even-index decimation -> ceil(n/2). The
    rows are decimated before the column pass (the same values: the
    column pass acts on each row alone)."""
    if min(img.shape[-2:]) < 2:
        raise ValueError(f"pyr_down needs dims >= 2, got {tuple(img.shape)}")
    x = img.to(torch.float32)
    r = _conv1d_shifted(x, _BURT, -2, "mirror")[..., ::2, :]
    return _conv1d_shifted(r, _BURT, -1, "mirror")[..., ::2]


def _axis_up(a: torch.Tensor, ax: int) -> torch.Tensor:
    """Polyphase zero-insert + 5-tap Burt along ``ax`` (-2 or -1): even
    outputs take taps (k0, k2, k4) on (a[i-1], a[i], a[i+1]), odd outputs
    (k1, k3) on (a[i], a[i+1]); REFLECT_101 of the 2n grid puts the left
    pad on a[1] and the right pads back on a[n-1]."""
    n = a.shape[ax]
    if n == 1:  # degenerate deepest level: every neighbour is a itself
        prev = nxt = a
    else:
        prev = torch.cat([a.narrow(ax, 1, 1), a.narrow(ax, 0, n - 1)], dim=ax)
        nxt = torch.cat([a.narrow(ax, 1, n - 1), a.narrow(ax, n - 1, 1)],
                        dim=ax)
    b = [float(t) for t in _BURT]
    ev = b[0] * prev + b[2] * a + b[4] * nxt
    od = b[1] * a + b[3] * nxt
    shape = list(a.shape)
    shape[ax] = 2 * n
    dim = a.dim() + ax  # the positive axis
    return torch.stack([ev, od], dim=dim + 1).reshape(shape)


def pyr_up(img: torch.Tensor,
           out_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """cv2.pyrUp: zero-insert to (2h, 2w), Burt blur x4, crop to
    ``out_shape`` (default (2h, 2w); each dim 2n or 2n - 1)."""
    h, w = img.shape[-2:]
    if out_shape is None:
        out_shape = (2 * h, 2 * w)
    oh, ow = out_shape
    if not (2 * h - 1 <= oh <= 2 * h and 2 * w - 1 <= ow <= 2 * w):
        raise ValueError(
            f"out_shape {out_shape} incompatible with pyr_up from "
            f"({h}, {w}): each dim must be 2n or 2n-1"
        )
    x = img.to(torch.float32)
    return (4.0 * _axis_up(_axis_up(x, -2), -1))[..., :oh, :ow]


def laplacian_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[L_0 .. L_{levels-1}, G_levels]: L_k = G_k - pyr_up(G_{k+1}) cropped
    to G_k's shape; the last entry is the low-pass residual."""
    if levels < 1:
        raise ValueError("levels must be >= 1")
    g = [img.to(torch.float32)]
    for _ in range(levels):
        g.append(pyr_down(g[-1]))
    out = [g[k] - pyr_up(g[k + 1], tuple(g[k].shape[-2:]))
           for k in range(levels)]
    out.append(g[levels])
    return out


def musica(
    img: torch.Tensor,
    levels: int = 4,
    p: float = 0.5,
    gain: float | tuple = 1.0,
    m: float = 1.0,
    clip: bool = True,
) -> torch.Tensor:
    """MUSICA multiscale contrast amplification of each 2-D slice: every
    Laplacian band maps through ``gain_k * m * sign(l) * (|l| / m)**p``
    (``gain`` one number or one per level, finest first), the low-pass
    residual passes unchanged, and the pyramid reconstructs."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"p must be in (0, 1], got {p}")
    if m <= 0:
        raise ValueError("m must be > 0")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if min(img.shape[-2:]) < 2 ** levels:
        raise ValueError(
            f"image {tuple(img.shape)} too small for {levels} pyramid levels"
        )
    gains = (list(gain) if isinstance(gain, (tuple, list))
             else [float(gain)] * levels)
    if len(gains) != levels:
        raise ValueError(
            f"gain must be one number or {levels} (one per level), "
            f"got {len(gains)}"
        )
    bands = laplacian_pyramid(img, levels)
    out = bands[levels]  # low-pass residual, untouched
    m32 = np.float32(m)
    for k in reversed(range(levels)):
        lk = bands[k]
        if p == 1.0:
            enh = float(np.float32(gains[k])) * lk
        else:
            scale = float(np.float32(gains[k]) * m32)
            mag = torch.abs(lk) / lk.new_full((), float(m32))
            enh = scale * torch.sign(lk) * torch.pow(mag, float(np.float32(p)))
        out = pyr_up(out, tuple(lk.shape[-2:])) + enh
    return torch.clamp(out, 0.0, 1.0) if clip else out
