"""Stochastic augmentation for denoiser training, on the batch's device.

The port of ``mies_tpu.models.augment``, on [B, ..., H, W] batches (the
spatial axes last, as in NCHW):

  * geometric: horizontal and vertical flips, 90-degree rotations (square
    patches): one element of the dihedral group D4 per image;
  * photometric, on the input only: contrast about the image mean, then
    brightness, gamma (log-uniform), additive Gaussian noise, then the clip;
  * elastic deformation (Ronneberger et al. 2015): a smooth random
    displacement field, bilinear sampling with the edge clamped, the same
    warp on input and target.

``jax.random``'s streams have no PyTorch counterpart, so each transform is
split into its draws (``draw_*``, from a ``torch.Generator`` on the CPU,
moved to the batch's device) and its application (a plain function of the
draws, held against the reference's). One generator gives the same batch
on the CPU and on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mies_tpu_torch.ops.geometry import resize


@dataclass(frozen=True)
class AugmentConfig:
    """Probabilities and ranges; zeros disable a transform (and its draws)."""

    hflip: float = 0.5          # P(horizontal flip)
    vflip: float = 0.5          # P(vertical flip)
    rot90: bool = True          # uniform k in {0,1,2,3} (square patches)
    brightness: float = 0.0     # shift ~ U(-b, +b)
    contrast: float = 0.0       # scale ~ U(1-c, 1+c) about the image mean
    gamma: float = 0.0          # exponent ~ exp(U(-g, +g)) (log-uniform)
    noise_sigma: float = 0.0    # additive N(0, sigma^2)
    elastic: float = 0.0        # peak displacement in pixels (0 = off)
    elastic_sigma: float = 8.0  # smoothness of the displacement field
    clip: bool = True           # clip photometric output back to [0, 1]


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


# ---------------------------------------------------------------------------
# geometric
# ---------------------------------------------------------------------------


def dihedral(img: torch.Tensor, code: int) -> torch.Tensor:
    """Element ``code`` in 0..7 of D4 on the last two axes: the low bit a
    horizontal flip (of the columns), the upper bits the number of
    counter-clockwise 90-degree rotations after it (numpy's rot90)."""
    rot, flip = divmod(int(code), 2)
    if flip:
        img = torch.flip(img, (-1,))
    return torch.rot90(img, rot, dims=(-2, -1)) if rot else img


def apply_dihedral(batch: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Each image of [B, ..., H, W] by its own code; a non-square batch
    takes only the shape-keeping codes {0, 1, 4, 5}."""
    codes = [int(c) for c in codes.tolist()]
    if batch.shape[-2] != batch.shape[-1] and set(codes) - {0, 1, 4, 5}:
        raise ValueError(f"codes {sorted(set(codes))} rotate a non-square "
                         f"batch {tuple(batch.shape)} by 90 degrees")
    return torch.stack([dihedral(img, c) for img, c in zip(batch, codes)])


def draw_geometric(gen: torch.Generator, n: int, cfg: AugmentConfig,
                   square: bool) -> torch.Tensor:
    """Per-image D4 codes: a horizontal flip with P(hflip), a vertical flip
    (= a flip plus two rotations) with P(vflip), a uniform rotation when
    enabled AND the patch is square."""
    hf = (torch.rand(n, generator=gen) < cfg.hflip).to(torch.int64)
    vf = (torch.rand(n, generator=gen) < cfg.vflip).to(torch.int64)
    rot = (torch.randint(0, 4, (n,), generator=gen) if (cfg.rot90 and square)
           else torch.zeros(n, dtype=torch.int64))
    rot = (rot + 2 * vf) % 4
    return 2 * rot + (hf ^ vf)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------


def draw_photometric(gen: torch.Generator, shape, cfg: AugmentConfig) -> dict:
    """The per-image factors (contrast c, brightness b, gamma g, shaped to
    broadcast over an image) and the noise field, for the enabled ones."""
    n = shape[0]
    per_img = (n,) + (1,) * (len(shape) - 1)
    draws = {}
    if cfg.contrast > 0.0:
        draws["contrast"] = _uniform(gen, per_img, 1.0 - cfg.contrast,
                                     1.0 + cfg.contrast)
    if cfg.brightness > 0.0:
        draws["brightness"] = _uniform(gen, per_img, -cfg.brightness,
                                       cfg.brightness)
    if cfg.gamma > 0.0:
        draws["gamma"] = torch.exp(_uniform(gen, per_img, -cfg.gamma,
                                            cfg.gamma))
    if cfg.noise_sigma > 0.0:
        draws["noise"] = torch.randn(tuple(shape), generator=gen)
    return draws


def apply_photometric(x: torch.Tensor, draws: dict, cfg: AugmentConfig
                      ) -> torch.Tensor:
    """contrast -> brightness -> gamma -> noise -> clip, each factor per
    image (the reference's order)."""
    dev = x.device
    axes = tuple(range(1, x.dim()))
    if "contrast" in draws:
        mean = x.mean(dim=axes, keepdim=True)
        x = (x - mean) * draws["contrast"].to(dev) + mean
    if "brightness" in draws:
        x = x + draws["brightness"].to(dev)
    if "gamma" in draws:
        x = torch.pow(torch.clamp(x, 0.0, 1.0), draws["gamma"].to(dev))
    if "noise" in draws:
        x = x + cfg.noise_sigma * draws["noise"].to(dev)
    if cfg.clip:
        x = torch.clamp(x, 0.0, 1.0)
    return x


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------


def _coarse_shape(hw: tuple, cfg: AugmentConfig) -> tuple[int, int]:
    h, w = hw
    s = max(2, int(cfg.elastic_sigma) // 2)
    return max(2, h // s), max(2, w // s)


def draw_elastic(gen: torch.Generator, n: int, hw: tuple,
                 cfg: AugmentConfig) -> torch.Tensor:
    """Coarse Gaussian noise [n, 2, ch, cw], the raw displacement."""
    return torch.randn((n, 2, *_coarse_shape(hw, cfg)), generator=gen)


def _smooth1(v: torch.Tensor, dim: int) -> torch.Tensor:
    """The 3-tap binomial [0.25, 0.5, 0.25] along ``dim``, edge-padded."""
    first = v.narrow(dim, 0, 1)
    last = v.narrow(dim, v.shape[dim] - 1, 1)
    vp = torch.cat([first, v, last], dim=dim)
    n = v.shape[dim]
    out = 0.25 * vp.narrow(dim, 0, n)
    out = out + 0.5 * vp.narrow(dim, 1, n)
    return out + 0.25 * vp.narrow(dim, 2, n)


def elastic_fields(raw: torch.Tensor, hw: tuple, cfg: AugmentConfig
                   ) -> torch.Tensor:
    """Displacement fields [n, 2, H, W] of coarse noise: smoothed twice
    per axis on the coarse grid, resized bilinearly (jax.image.resize
    'linear'), each field's peak set to ``cfg.elastic`` pixels."""
    f = raw
    for _ in range(2):
        f = _smooth1(_smooth1(f, 2), 3)
    f = resize(f, hw[0], hw[1], method="bilinear")
    peak = f.abs().amax(dim=(1, 2, 3), keepdim=True)
    amp = torch.full((), float(cfg.elastic), device=f.device)
    return f * (amp / torch.clamp_min(peak, 1e-6))


def elastic_warp(batch: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """Sample each image of [B, ..., H, W] at its displaced grid (y + dy,
    x + dx), bilinear with the indices clamped to the edge: jax.scipy.
    ndimage.map_coordinates(order=1, mode='nearest') term by term (the
    weights' product times the gathered corner, summed (y0, x0), (y0, x1),
    (y1, x0), (y1, x1))."""
    b, h, w = batch.shape[0], batch.shape[-2], batch.shape[-1]
    dev = batch.device
    fields = fields.to(dev, torch.float32)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + fields[:, 0]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + fields[:, 1]

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        return ((idx.clamp(0, size - 1), 1.0 - upper_w),
                ((idx + 1).clamp(0, size - 1), upper_w))

    flat = batch.to(torch.float32).reshape(b, -1, h * w)
    out = None
    for iy, wy in nodes(yy, h):
        for ix, wx in nodes(xx, w):
            key = (iy * w + ix).reshape(b, 1, h * w).expand(-1, flat.shape[1], -1)
            term = (wy * wx).reshape(b, 1, h * w) * flat.gather(2, key)
            out = term if out is None else out + term
    return out.reshape(batch.shape)


# ---------------------------------------------------------------------------
# batch entry points
# ---------------------------------------------------------------------------


def augment_batch(gen: torch.Generator, batch: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Geometric, elastic and photometric augmentation of [B, ..., H, W]."""
    n, hw = batch.shape[0], tuple(batch.shape[-2:])
    codes = draw_geometric(gen, n, cfg, hw[0] == hw[1])
    out = apply_dihedral(batch, codes)
    if cfg.elastic > 0.0:
        raw = draw_elastic(gen, n, hw, cfg)
        out = elastic_warp(out, elastic_fields(raw.to(out.device), hw, cfg))
    return apply_photometric(out, draw_photometric(gen, out.shape, cfg), cfg)


def augment_pair(gen: torch.Generator, noisy: torch.Tensor,
                 clean: torch.Tensor, cfg: AugmentConfig = AugmentConfig()
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SAME geometric transform and warp on both members of a (noisy,
    clean) pair; photometric jitter and noise on the noisy input only."""
    n, hw = noisy.shape[0], tuple(noisy.shape[-2:])
    codes = draw_geometric(gen, n, cfg, hw[0] == hw[1])
    gn, gc = apply_dihedral(noisy, codes), apply_dihedral(clean, codes)
    if cfg.elastic > 0.0:
        fields = elastic_fields(draw_elastic(gen, n, hw, cfg).to(gn.device),
                                hw, cfg)
        gn, gc = elastic_warp(gn, fields), elastic_warp(gc, fields)
    return apply_photometric(gn, draw_photometric(gen, gn.shape, cfg), cfg), gc
