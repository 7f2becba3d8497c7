"""Full-reference image quality metrics (the sewar-equivalent suite).

The port of ``mies_tpu.eval.metrics``: the same thirteen formulas, in
PyTorch, on whatever device the images are on. Each metric takes two
images ``[..., H, W]`` of one shape (float or uint8; leading axes are a
batch) and returns one float32 value per image, shape ``[...]``: the
reference's ``vmap`` over slices is the leading axis here, so a volume's
per-slice metrics are one call.

Conventions (the reference's; goldens in tests/goldens/golden_metrics.py):
  * ``max_val`` is the dynamic range (255 for uint8 pipelines, 1.0 for
    float); only psnr, ssim, msssim and psnrb take it in ``evaluate``.
  * the windowed metrics (uqi ws 8, ssim ws 11, scc ws 8) use a uniform
    ws x ws window; vifp a Gaussian per scale (4 scales, sigma_nsq 2);
    msssim 5 scales with 2x2 average-pool downsampling.
  * ergas, rase and sam take each [H, W] image as one band (the
    reference's single-band forms).

The window sums are separable shifted adds in float32 (a row pass, then a
column pass; the Gaussian's taps as one multiply and one add each), not
a convolution: every add is correctly rounded on the CPU and on the card
alike, so the card gives the CPU's sums, whatever algorithm cuDNN would
pick. On integer-valued images (uint8 pairs) the box sums are exact.
"""

from __future__ import annotations

import numpy as np
import torch

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
# the metrics that take the dynamic range in ``evaluate`` (the reference's
# routing)
MAX_VAL_METRICS = ("psnr", "ssim", "msssim", "psnrb")


def _f32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(torch.float32)


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    """A 0-d float32 tensor on x's device: a divisor CUDA torch divides by
    (it multiplies by a Python scalar divisor's reciprocal)."""
    return torch.full((), float(v), dtype=torch.float32, device=x.device)


def _shift_sum(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """'valid' correlation of x along ``dim`` with ``taps`` (None: a box of
    len ones) as shifted adds in tap order."""
    n = len(taps)
    m = x.shape[dim] - n + 1
    acc = None
    for i, t in enumerate(taps):
        term = x.narrow(dim, i, m)
        if t is not None:
            term = term * t
        acc = term if acc is None else acc + term
    return acc


def _filter2_valid(img: torch.Tensor, ws: int) -> torch.Tensor:
    """Uniform ws x ws sum, 'valid' mode: [..., H, W] -> [..., H-ws+1, W-ws+1]."""
    box = (None,) * ws
    return _shift_sum(_shift_sum(img, box, -2), box, -1)


def _gaussian_taps(sd: float, radius: int) -> tuple:
    """The reference's normalized Gaussian, as separable float32 taps."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sd) ** 2)
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _gaussian_filter_valid(img: torch.Tensor, sd: float, radius: int) -> torch.Tensor:
    """Gaussian filter, 'valid' mode (for vifp)."""
    taps = _gaussian_taps(sd, radius)
    return _shift_sum(_shift_sum(img, taps, -2), taps, -1)


def _mean2(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(-2, -1))


# ---------------------------------------------------------------------------
# simple pixel metrics
# ---------------------------------------------------------------------------


def mse(gt, p) -> torch.Tensor:
    """Mean squared error."""
    gt, p = _f32(gt), _f32(p)
    return _mean2((gt - p) ** 2)


def rmse(gt, p) -> torch.Tensor:
    """Root mean squared error."""
    return torch.sqrt(mse(gt, p))


def psnr(gt, p, max_val: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (inf on identical images)."""
    m = mse(gt, p)
    db = 10.0 * torch.log10(_const(m, max_val * max_val)
                            / torch.clamp_min(m, 1e-30))
    return torch.where(m == 0, torch.full_like(m, float("inf")), db)


# ---------------------------------------------------------------------------
# windowed structural metrics
# ---------------------------------------------------------------------------


def uqi(gt, p, ws: int = 8) -> torch.Tensor:
    """Universal Quality Index (Wang & Bovik 2002), uniform window, with
    sewar's piecewise handling of zero denominators."""
    gt, p = _f32(gt), _f32(p)
    n = ws * ws
    s_g = _filter2_valid(gt, ws)
    s_p = _filter2_valid(p, ws)
    s_gg = _filter2_valid(gt * gt, ws)
    s_pp = _filter2_valid(p * p, ws)
    s_gp = _filter2_valid(gt * p, ws)
    gp = s_g * s_p
    gg_pp = s_g * s_g + s_p * s_p
    numerator = 4.0 * (n * s_gp - gp) * gp
    denominator1 = n * (s_gg + s_pp) - gg_pp
    denominator = denominator1 * gg_pp
    safe = torch.where(denominator == 0, torch.ones_like(denominator),
                       denominator)
    q = torch.where(
        (denominator1 == 0) & (gg_pp != 0),
        2.0 * gp / torch.where(gg_pp == 0, torch.ones_like(gg_pp), gg_pp),
        torch.where(denominator != 0, numerator / safe,
                    torch.ones_like(denominator)),
    )
    return _mean2(q)


def _ssim_maps(gt: torch.Tensor, p: torch.Tensor, ws: int, K1: float,
               K2: float, max_val: float):
    """(ssim map, contrast-structure map) of float32 [..., H, W] images."""
    c1 = (K1 * max_val) ** 2
    c2 = (K2 * max_val) ** 2
    n = _const(gt, ws * ws)
    mu_g = _filter2_valid(gt, ws) / n
    mu_p = _filter2_valid(p, ws) / n
    var_g = _filter2_valid(gt * gt, ws) / n - mu_g * mu_g
    var_p = _filter2_valid(p * p, ws) / n - mu_p * mu_p
    cov = _filter2_valid(gt * p, ws) / n - mu_g * mu_p
    lum = (2.0 * mu_g * mu_p + c1) / (mu_g ** 2 + mu_p ** 2 + c1)
    cs = (2.0 * cov + c2) / (var_g + var_p + c2)
    return lum * cs, cs


def ssim(gt, p, ws: int = 11, K1: float = 0.01, K2: float = 0.03,
         max_val: float = 255.0) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004), uniform window, valid mode
    (sewar's default configuration)."""
    s, _ = _ssim_maps(_f32(gt), _f32(p), ws, K1, K2, max_val)
    return _mean2(s)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    x = x[..., : h - h % 2, : w - w % 2]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2]) * 0.25


def msssim(gt, p, ws: int = 11, K1: float = 0.01, K2: float = 0.03,
           max_val: float = 255.0) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003), 5 scales, 2x2 average-pool
    downsampling; needs min(H, W) >= ws * 16 (176 at ws 11)."""
    gt, p = _f32(gt), _f32(p)
    if min(gt.shape[-2:]) < ws * 16:
        raise ValueError(
            f"msssim needs min(H,W) >= {ws * 16} for 5 scales; got "
            f"{tuple(gt.shape)}"
        )
    vals = []
    for scale in range(5):
        s, cs = _ssim_maps(gt, p, ws, K1, K2, max_val)
        vals.append(_mean2(s) if scale == 4 else _mean2(cs))
        if scale < 4:
            gt = _avg_pool2(gt)
            p = _avg_pool2(p)
    out = torch.ones_like(vals[0])
    for v, w in zip(vals, _MSSSIM_WEIGHTS):
        out = out * torch.clamp_min(v, 0.0) ** w
    return out


# ---------------------------------------------------------------------------
# spectral / band metrics (each image one band)
# ---------------------------------------------------------------------------


def ergas(gt, p, r: float = 4.0) -> torch.Tensor:
    """ERGAS (global): 100/r * sqrt(MSE / mean(GT)^2)."""
    gt, p = _f32(gt), _f32(p)
    m = _mean2((gt - p) ** 2)
    mu = _mean2(gt)
    return 100.0 / r * torch.sqrt(m / torch.clamp_min(mu * mu, 1e-30))


def rase(gt, p) -> torch.Tensor:
    """Relative average spectral error: 100/mu * RMSE."""
    gt, p = _f32(gt), _f32(p)
    m = _mean2((gt - p) ** 2)
    mu = _mean2(gt)
    return _const(mu, 100.0) / torch.clamp_min(mu, 1e-30) * torch.sqrt(m)


def sam(gt, p) -> torch.Tensor:
    """Spectral angle mapper (radians) of one band: the angle between the
    flattened images (the reference's single-band form)."""
    gt, p = _f32(gt), _f32(p)
    num = (gt * p).sum(dim=(-2, -1))
    den = (torch.sqrt((gt * gt).sum(dim=(-2, -1)))
           * torch.sqrt((p * p).sum(dim=(-2, -1))))
    return torch.arccos(torch.clamp(num / torch.clamp_min(den, 1e-30),
                                    -1.0, 1.0))


# the 3x3 ring high-pass, taps in row-major order
_RING = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))


def _ring(x: torch.Tensor) -> torch.Tensor:
    """'valid' correlation with the 3x3 ring, taps summed in row-major
    order (each weight times a value is exact)."""
    h, w = x.shape[-2:]
    acc = None
    for i in range(3):
        for j in range(3):
            t = x[..., i:i + h - 2, j:j + w - 2]
            t = -t if _RING[i][j] == -1.0 else t * _RING[i][j]
            acc = t if acc is None else acc + t
    return acc


def _pad_reflect1(x: torch.Tensor) -> torch.Tensor:
    """numpy 'reflect' pad of 1 on the last two dims."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x.reshape(-1, h, w), (1, 1, 1, 1),
                                 mode="reflect")
    return xp.reshape(*x.shape[:-2], h + 2, w + 2)


def scc(gt, p, ws: int = 8) -> torch.Tensor:
    """Spatial correlation coefficient, sewar 0.4.6's windowed form: the
    3x3 ring high-pass twice (reflect border), ws x ws local (co)variances
    by a 'same' box with zero borders ((4, 3) at ws 8), negative variances
    clamped to 0, per-pixel r = cov / (sd sd) (0 where that is 0), the mean
    over all pixels."""
    gt, p = _f32(gt), _f32(p)
    lo, hi = (ws - 1) // 2 + 1, (ws - 1) // 2
    area = _const(gt, ws * ws)

    def hp(x):
        return 2.0 * _ring(_pad_reflect1(x))

    def f2(x):
        xp = torch.nn.functional.pad(x, (lo, hi, lo, hi))
        return _filter2_valid(xp, ws) / area

    a, b = hp(gt), hp(p)
    mu_a, mu_b = f2(a), f2(b)
    va = torch.clamp_min(f2(a * a) - mu_a * mu_a, 0.0)
    vb = torch.clamp_min(f2(b * b) - mu_b * mu_b, 0.0)
    vab = f2(a * b) - mu_a * mu_b
    den = torch.sqrt(va) * torch.sqrt(vb)
    zero = den == 0
    cc = torch.where(zero, torch.zeros_like(den),
                     vab / torch.where(zero, torch.ones_like(den), den))
    return _mean2(cc)


def scc_global(gt, p) -> torch.Tensor:
    """Global-Pearson spatial correlation: Pearson r of the 3x3-ring
    high-passed images, valid mode."""
    gt, p = _f32(gt), _f32(p)
    a, b = _ring(gt), _ring(p)
    a = a - _mean2(a)[..., None, None]
    b = b - _mean2(b)[..., None, None]
    den = torch.sqrt((a * a).sum(dim=(-2, -1)) * (b * b).sum(dim=(-2, -1)))
    return (a * b).sum(dim=(-2, -1)) / torch.clamp_min(den, 1e-30)


# ---------------------------------------------------------------------------
# VIF (pixel domain) and PSNR-B
# ---------------------------------------------------------------------------


def vifp(gt, p, sigma_nsq: float = 2.0) -> torch.Tensor:
    """Visual Information Fidelity, pixel domain (Sheikh & Bovik 2006):
    4 scales, Gaussian of N = 2^(4-s+1)+1 taps (sd N/5), subsampled by 2
    from scale 2 on."""
    gt, p = _f32(gt), _f32(p)
    num = torch.zeros(gt.shape[:-2], dtype=torch.float32, device=gt.device)
    den = torch.zeros_like(num)
    eps = 1e-10
    for scale in range(1, 5):
        n = 2 ** (4 - scale + 1) + 1
        sd = n / 5.0
        if scale > 1:
            gt = _gaussian_filter_valid(gt, sd, n // 2)[..., ::2, ::2]
            p = _gaussian_filter_valid(p, sd, n // 2)[..., ::2, ::2]
        mu1 = _gaussian_filter_valid(gt, sd, n // 2)
        mu2 = _gaussian_filter_valid(p, sd, n // 2)
        mu1_sq, mu2_sq, mu1mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _gaussian_filter_valid(gt * gt, sd, n // 2) - mu1_sq
        sigma2_sq = _gaussian_filter_valid(p * p, sd, n // 2) - mu2_sq
        sigma12 = _gaussian_filter_valid(gt * p, sd, n // 2) - mu1mu2

        sigma1_sq = torch.clamp_min(sigma1_sq, 0.0)
        sigma2_sq = torch.clamp_min(sigma2_sq, 0.0)

        g = sigma12 / (sigma1_sq + eps)
        sv_sq = sigma2_sq - g * sigma12

        flat = sigma1_sq < eps
        g = torch.where(flat, torch.zeros_like(g), g)
        sv_sq = torch.where(flat, sigma2_sq, sv_sq)
        sigma1_sq = torch.where(flat, torch.zeros_like(sigma1_sq), sigma1_sq)

        sv_sq = torch.where(g < 0, sigma2_sq, sv_sq)
        g = torch.clamp_min(g, 0.0)
        sv_sq = torch.clamp_min(sv_sq, eps)

        num = num + torch.log10(
            1.0 + g * g * sigma1_sq / (sv_sq + sigma_nsq)).sum(dim=(-2, -1))
        den = den + torch.log10(
            1.0 + sigma1_sq / _const(sigma1_sq, sigma_nsq)).sum(dim=(-2, -1))
    return num / torch.clamp_min(den, 1e-30)


def _bef(img: torch.Tensor, block: int = 8) -> torch.Tensor:
    """Blocking effect factor (Yim & Bovik 2011) of [..., H, W]."""
    h, w = img.shape[-2:]
    dev = img.device
    diff_h = (img[..., :, :-1] - img[..., :, 1:]) ** 2
    bmask_h = (torch.arange(w - 1, device=dev) % block) == (block - 1)
    d_b_h = torch.where(bmask_h, diff_h, 0.0).sum(dim=(-2, -1))
    d_bc_h = torch.where(~bmask_h, diff_h, 0.0).sum(dim=(-2, -1))
    nb_h = int(bmask_h.sum())
    diff_v = (img[..., :-1, :] - img[..., 1:, :]) ** 2
    bmask_v = ((torch.arange(h - 1, device=dev) % block) == (block - 1))[:, None]
    d_b_v = torch.where(bmask_v, diff_v, 0.0).sum(dim=(-2, -1))
    d_bc_v = torch.where(~bmask_v, diff_v, 0.0).sum(dim=(-2, -1))
    nb_v = int(bmask_v.sum())
    n_b = h * nb_h + w * nb_v
    n_bc = h * (w - 1 - nb_h) + w * (h - 1 - nb_v)
    d_b = (d_b_h + d_b_v) / _const(img, max(n_b, 1))
    d_bc = (d_bc_h + d_bc_v) / _const(img, max(n_bc, 1))
    t = float(np.log2(np.float32(block)) / np.log2(np.float32(min(h, w))))
    t = float(np.float32(t))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), torch.zeros_like(d_b))


def psnrb(gt, p, max_val: float = 255.0, block: int = 8) -> torch.Tensor:
    """PSNR-B: PSNR with the blocking effect factor of ``p`` added to the
    MSE (MSE-B = MSE + BEF)."""
    gt, p = _f32(gt), _f32(p)
    mse_b = mse(gt, p) + _bef(p, block)
    db = 10.0 * torch.log10(_const(mse_b, max_val * max_val)
                            / torch.clamp_min(mse_b, 1e-30))
    return torch.where(mse_b == 0, torch.full_like(mse_b, float("inf")), db)


# ---------------------------------------------------------------------------
# registry and entry points
# ---------------------------------------------------------------------------

METRIC_REGISTRY = {
    "mse": mse,
    "rmse": rmse,
    "psnr": psnr,
    "uqi": uqi,
    "ssim": ssim,
    "msssim": msssim,
    "ergas": ergas,
    "scc": scc,
    "scc_global": scc_global,
    "rase": rase,
    "sam": sam,
    "vifp": vifp,
    "psnrb": psnrb,
}


def metric_values(gt: torch.Tensor, p: torch.Tensor, names, max_val: float
                  ) -> dict[str, torch.Tensor]:
    """{name: per-image values} of ``names`` on [..., H, W] tensors, with
    the reference's ``max_val`` routing."""
    unknown = [n for n in names if n not in METRIC_REGISTRY]
    if unknown:
        raise ValueError(f"unknown metric(s) {unknown}; available: "
                         f"{sorted(METRIC_REGISTRY)}")
    gt, p = _f32(gt), _f32(p)
    return {n: (METRIC_REGISTRY[n](gt, p, max_val=max_val)
                if n in MAX_VAL_METRICS else METRIC_REGISTRY[n](gt, p))
            for n in names}


def _on_device(gt, p, device) -> tuple[torch.Tensor, torch.Tensor]:
    from mies_tpu_torch.pipeline.compiler import _to_device, resolve_device

    dev = resolve_device(device)
    return _to_device(gt, dev), _to_device(p, dev)


def evaluate(
    gt,
    p,
    names: tuple[str, ...] = ("psnr", "ssim", "uqi"),
    max_val: float = 255.0,
    device="cuda",
) -> dict[str, float]:
    """The metrics of one [H, W] pair (numpy arrays or tensors) on
    ``device`` ("cuda" by default; no card -> RuntimeError), as Python
    floats keyed in sorted order (the reference's jitted dict)."""
    gt, p = _on_device(gt, p, device)
    res = metric_values(gt, p, tuple(names), float(max_val))
    return {k: float(res[k]) for k in sorted(res)}


def evaluate_volume(
    gt,
    p,
    names: tuple[str, ...] = ("psnr", "ssim"),
    max_val: float = 255.0,
    device="cuda",
) -> dict:
    """Per-slice metrics of [Z, H, W] volumes in one batched call on
    ``device``. Returns {"mean": {name: float}, "per_slice": {name:
    [float, ...]}}."""
    gt, p = _on_device(gt, p, device)
    res = metric_values(gt, p, tuple(names), float(max_val))
    per_slice = {k: [float(x) for x in res[k].cpu().numpy()]
                 for k in sorted(res)}
    mean = {k: float(np.mean(v)) for k, v in per_slice.items()}
    return {"mean": mean, "per_slice": per_slice}
