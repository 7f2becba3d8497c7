"""uint8 chest-X-ray-like slices: a smooth lung glow, rib texture and
noise, each slice shifted and scaled (``chip_smoke.py _xray_batch``, in
torch and vectorised over the batch)."""

from __future__ import annotations

import torch

DTYPE = torch.uint8


def make(b: int, h: int, w: int, gen: torch.Generator,
         device) -> torch.Tensor:
    u = torch.rand((b, 4), generator=gen, device=device)
    cy = (h / 2 + 80.0 * u[:, 0] - 40.0)[:, None, None]
    cx = (w / 2 + 80.0 * u[:, 1] - 40.0)[:, None, None]
    amp = (0.4 + 0.3 * u[:, 2])[:, None, None]
    period = (12.0 + 8.0 * u[:, 3])[:, None, None]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    r = torch.sqrt((y - cy) ** 2 + (x - cx) ** 2) / (h / 2)
    base = amp * torch.exp(-((r / 0.9) ** 2))
    ribs = 0.12 * torch.clamp(torch.sin(y / period), min=0.0) ** 3
    noise = 0.03 * torch.randn((b, h, w), generator=gen, device=device)
    img = torch.clamp(base + ribs + noise + 0.08, 0.0, 1.0)
    return torch.round(img * 255.0).to(DTYPE)
