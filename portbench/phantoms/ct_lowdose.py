"""int16 low-dose CT slices in Hounsfield units: an elliptical
soft-tissue body (40 HU) in air (-1000) with a fat rim (-100), two lungs
(-850), a contrast-filled vessel (200) and a bone ring (700), smoothed
edges, plus quantum noise (sigma 25 HU); each slice shifted and scaled
(``chip_smoke.py _ct_batch``, in torch and vectorised over the batch)."""

from __future__ import annotations

import torch

DTYPE = torch.int16


def make(b: int, h: int, w: int, gen: torch.Generator,
         device) -> torch.Tensor:
    u = torch.rand((b, 4), generator=gen, device=device)
    cy = (h / 2 + 40.0 * u[:, 0] - 20.0)[:, None, None]
    cx = (w / 2 + 40.0 * u[:, 1] - 20.0)[:, None, None]
    ry = (h * (0.36 + 0.06 * u[:, 2]))[:, None, None]
    rx = (w * (0.42 + 0.05 * u[:, 3]))[:, None, None]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    r = torch.sqrt(((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2)
    hu = torch.where(r < 1.0, 40.0, -1000.0)
    hu = torch.where((r > 0.93) & (r < 1.0), -100.0, hu)
    for side in (-1.0, 1.0):
        rl = torch.sqrt(((y - cy + 0.1 * ry) / (0.55 * ry)) ** 2
                        + ((x - cx - side * 0.45 * rx) / (0.3 * rx)) ** 2)
        hu = torch.where(rl < 1.0, -850.0, hu)
    hu = torch.where(torch.abs(r - 0.85) < 0.025, 700.0, hu)
    vessel = (y - cy - 0.3 * ry) ** 2 + (x - cx) ** 2 < (0.08 * rx) ** 2
    hu = torch.where(vessel, 200.0, hu)
    hu = 0.25 * (hu + torch.roll(hu, 1, -2) + torch.roll(hu, 1, -1)
                 + torch.roll(hu, (1, 1), (-2, -1)))
    hu = hu + 25.0 * torch.randn((b, h, w), generator=gen, device=device)
    return torch.clamp(torch.round(hu), -1024, 3071).to(DTYPE)
