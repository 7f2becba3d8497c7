"""denoise_tv (skimage denoise_tv_chambolle) on each slice: Chambolle's
dual projection, each slice stopping on its own when
|E_prev - E| < eps E_init (energies summed in float64, rounded to
float32), keeping the out of the step in which its test turned true.
Records each slice's steps in ``info["denoise_tv.steps"]``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _step(x, p1, p2, tau_w):
    d = -(p1 + p2)
    d = d + F.pad(p1[:, :-1, :], (0, 0, 1, 0))
    d = d + F.pad(p2[:, :, :-1], (1, 0))
    cand = x + d
    g1 = F.pad(cand[:, 1:, :] - cand[:, :-1, :], (0, 0, 0, 1))
    g2 = F.pad(cand[:, :, 1:] - cand[:, :, :-1], (0, 1))
    norm = torch.sqrt(g1 * g1 + g2 * g2)
    factor = 1.0 + tau_w * norm
    return (cand, d * d, norm, (p1 - 0.25 * g1) / factor,
            (p2 - 0.25 * g2) / factor)


def apply(img: torch.Tensor, dtype, info, weight: float = 0.1,
          eps: float = 2e-4, max_num_iter: int = 200) -> torch.Tensor:
    x = img.to(dtype)
    n, hh, ww = x.shape
    w32 = np.float32(weight)
    eps32 = float(np.float32(eps))
    tau_w = float(np.float32(0.25) / w32)
    size_t = x.new_full((), float(np.float32(float(hh * ww))))
    p1 = torch.zeros_like(x)
    p2 = torch.zeros_like(x)
    out = x.clone()
    it = torch.zeros(n, dtype=torch.int32, device=x.device)
    e_prev = x.new_zeros(n)
    e_init = x.new_zeros(n)
    stop = torch.zeros(n, dtype=torch.bool, device=x.device)
    for _ in range(int(max_num_iter)):
        cand, dd, norm, np1, np2 = _step(x, p1, p2, tau_w)
        e = dd.double().sum((1, 2)).float()
        e = (e + float(w32) * norm.double().sum((1, 2)).float()) / size_t
        e_init_n = torch.where(it == 0, e, e_init)
        stop_n = (it > 0) & (torch.abs(e_prev - e) < eps32 * e_init_n)
        active = ~stop
        m = active[:, None, None]
        out = torch.where(m, cand, out)
        p1 = torch.where(m, np1, p1)
        p2 = torch.where(m, np2, p2)
        e_prev = torch.where(active, e, e_prev)
        e_init = torch.where(active, e_init_n, e_init)
        stop = torch.where(active, stop_n, stop)
        it = it + active.to(torch.int32)
    if info is not None:
        info.setdefault("denoise_tv.steps", []).append(it)
    return out


def operations(shape, info, max_num_iter: int = 200, **params) -> int:
    b, h, w = shape
    steps = info.get("denoise_tv.steps") if info else None
    # 22 a pixel and step, for the steps each slice needs
    total = int(steps.sum()) if steps is not None else b * int(max_num_iter)
    return 22 * total * h * w
