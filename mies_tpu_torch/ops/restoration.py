"""Restoration denoisers, plain PyTorch: non-local means, TV-Chambolle,
Perona-Malik diffusion and SRAD.

Same semantics and f32 operation order as ``mies_tpu.ops.restoration`` (2-D
ops), written for a batch: each function takes float32 ``[..., H, W]`` and
treats every leading index as its own slice, as the reference does under
``vmap``. These are the plain versions the K9-K12 kernels
(``mies_tpu_torch.kernels.diffusion``, ``.nlmeans``, ``.tv``) are held
against, and what the wrappers run on a CPU tensor.

Operation order is the reference's, op by op; eager torch does not contract
a multiply and an add into an FMA. Every division the reference makes is a
true division here: the divisor is a tensor (CUDA torch divides by a
Python scalar as a multiply by its reciprocal), and ``1.0 / t`` is
``reciprocal``, which is correctly rounded.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.filters import _pad2d, _pad_axis

DISTANCE_CUTOFF = 5.0  # skimage _nl_means_denoising.pyx: DISTANCE_CUTOFF


def _as_slices(img: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """float32 [N, H, W] view of ``img`` [..., H, W] and its leading shape."""
    if img.dim() < 2:
        raise ValueError(f"expected an image [..., H, W], got {tuple(img.shape)}")
    lead = tuple(img.shape[:-2])
    return img.to(torch.float32).reshape(-1, *img.shape[-2:]), lead


# ---------------------------------------------------------------------------
# Non-local means
# ---------------------------------------------------------------------------


def half_shift_table(d: int, nd: int = 2) -> np.ndarray:
    """Lexicographically positive half of [-d, d]^nd (first nonzero
    component > 0), encoded as offsets in [0, 2d] (dec = t + d); each
    entry stands for the unordered pair {t, -t}."""
    out = []
    for t in itertools.product(range(-d, d + 1), repeat=nd):
        for c in t:
            if c > 0:
                out.append([ti + d for ti in t])
                break
            if c < 0:
                break
    return np.asarray(out, np.int32).reshape(-1, nd)


def nl_means_params(
    shape: tuple[int, int], patch_size: int, patch_distance: int, h: float,
    sigma: float,
) -> tuple[int, int, float, float]:
    """(s, d, bias, inv_h2sn) of an NL-means call on [.., H, W] slices:
    an even patch size becomes s + 1 (skimage), the constants are computed
    in float64 and rounded to float32 once, and the reflect extension of
    width s // 2 + d must fit the image (numpy 'reflect' needs it < dim)."""
    s = patch_size if patch_size % 2 == 1 else patch_size + 1
    d = int(patch_distance)
    pad = s // 2 + d
    if any(pad > n - 1 for n in shape):
        raise ValueError(
            f"patch_size//2 + patch_distance = {pad} must be < every image "
            f"dim - 1 (got shape {tuple(shape)}); shrink patch_distance"
        )
    sn = float(s) ** 2
    inv_h2sn = float(np.float32(1.0 / (float(h) * float(h) * sn)))
    bias = float(np.float32(2.0 * float(sigma) * float(sigma) * sn))
    return s, d, bias, inv_h2sn


def denoise_nl_means(
    img: torch.Tensor,
    patch_size: int = 7,
    patch_distance: int = 11,
    h: float = 0.1,
    sigma: float = 0.0,
) -> torch.Tensor:
    """Non-local means, skimage.restoration.denoise_nl_means (fast_mode)
    semantics on each 2-D slice, as ``mies_tpu``'s symmetric-pair loop:

        S_t(p) = sum_{|k| <= s//2} (u(p+k) - u(p+t+k))^2     (patch SSD)
        D = max(S - 2 sigma^2 s^2, 0) / (h^2 s^2),  w = exp(-D) if D <= 5
        out(p) = (sum_t w_t(p) u(p+t) + 2 u(p)) / (sum_t w_t(p) + 2)

    over the half table of shifts t (each also gives the pair's reverse
    end, S_{-t}(p) = S_t(p - t)), on the numpy-'reflect' extension. Each
    box sums the rows of a column, then the columns in ascending order."""
    x, lead = _as_slices(img)
    hh, ww = x.shape[-2:]
    s, d, bias, inv_h2sn = nl_means_params((hh, ww), patch_size,
                                           patch_distance, h, sigma)
    offset = s // 2
    # reflect(offset + d), then d 'edge' rows only to keep slice shapes
    # static: no consumed value reads the edge ring
    up = _pad2d(x, offset + d, offset + d, "mirror")
    up = _pad2d(up, d, d, "nearest")
    eh, ew = hh + 2 * d + 2 * offset, ww + 2 * d + 2 * offset
    base = up[:, d:d + eh, d:d + ew]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy, dx in half_shift_table(d):
        diff = base - up[:, dy:dy + eh, dx:dx + ew]
        sq = diff * diff
        rows = sq[:, 0:eh - (s - 1), :]
        for j in range(1, s):
            rows = rows + sq[:, j:eh - (s - 1) + j, :]
        ssd = rows[:, :, 0:ew - (s - 1)]
        for j in range(1, s):
            ssd = ssd + rows[:, :, j:ew - (s - 1) + j]
        dist = torch.clamp_min(ssd - bias, 0.0) * inv_h2sn
        w = torch.where(dist <= DISTANCE_CUTOFF, torch.exp(-dist), 0.0)
        # forward end: w_t(p), u(p + t); reverse end: w_t(p - t), u(p - t)
        w_f = w[:, d:d + hh, d:d + ww]
        v_f = up[:, offset + d + dy:offset + d + dy + hh,
                 offset + d + dx:offset + d + dx + ww]
        w_r = w[:, 2 * d - dy:2 * d - dy + hh, 2 * d - dx:2 * d - dx + ww]
        v_r = up[:, offset + 3 * d - dy:offset + 3 * d - dy + hh,
                 offset + 3 * d - dx:offset + 3 * d - dx + ww]
        num = num + (w_f * v_f + w_r * v_r)
        den = den + (w_f + w_r)
    # the self pair: skimage's t = 0 iteration writes both endpoints
    out = (num + 2.0 * x) / (den + 2.0)
    return out.reshape(*lead, hh, ww)


# ---------------------------------------------------------------------------
# TV-Chambolle
# ---------------------------------------------------------------------------


def tv_constants(shape: tuple[int, int], weight: float, eps: float):
    """(weight, eps, tau / weight, size) as the float32 values the
    reference computes them in (tau = 1 / (2 ndim) = 0.25)."""
    w32 = np.float32(weight)
    return (float(w32), float(np.float32(eps)),
            float(np.float32(0.25) / w32),
            float(np.float32(float(shape[0] * shape[1]))))


def tv_step(x: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
            tau_w: float):
    """One unmasked Chambolle step on [N, H, W] (the reference's loop body):
    the divergence d of the dual field (0 before the first row and column),
    the candidate out = x + d, its forward gradient g (0 at the last row and
    column), |g| and the new dual field. Returns (out, d * d, |g|, p1, p2):
    the step's energy is sum(d * d) + weight sum(|g|), over the slice."""
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


def tv_chambolle(
    img: torch.Tensor, weight: float, eps: float, max_num_iter: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chambolle-2004 dual projection on each slice of [..., H, W]
    (skimage ``_denoise_tv_chambolle_nd``, the reference's while loop), with
    each slice stopping on its own as under ``vmap``: a stopped slice keeps
    the ``out`` of the iteration in which its test turned true. No host
    sync: the test is a per-slice tensor, and the loop runs
    ``max_num_iter`` masked steps. Returns (out, iterations per slice).

    The energy sums are taken in float64 and rounded to float32 (the
    reference sums in float32 in XLA's order; the kernel in its own fixed
    order): near-exact sums make the stop iteration reproducible."""
    if max_num_iter < 1:
        raise ValueError("max_num_iter must be >= 1")
    x, lead = _as_slices(img)
    n = x.shape[0]
    w32, eps32, tau_w, size = tv_constants(x.shape[-2:], weight, eps)
    size_t = x.new_full((), size)
    p1 = torch.zeros_like(x)
    p2 = torch.zeros_like(x)
    out = x.clone()
    it = torch.zeros(n, dtype=torch.int32, device=x.device)
    e_prev = x.new_zeros(n)
    e_init = x.new_zeros(n)
    stop = torch.zeros(n, dtype=torch.bool, device=x.device)
    for _ in range(int(max_num_iter)):
        cand, dd, norm, np1, np2 = tv_step(x, p1, p2, tau_w)
        e = dd.double().sum((1, 2)).float()
        e = (e + w32 * norm.double().sum((1, 2)).float()) / size_t
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
    return out.reshape(*lead, *x.shape[-2:]), it.reshape(lead)


def denoise_tv(
    img: torch.Tensor,
    weight: float = 0.1,
    eps: float = 2e-4,
    max_num_iter: int = 200,
) -> torch.Tensor:
    """Total-variation denoising, skimage.restoration.denoise_tv_chambolle
    semantics on each 2-D slice."""
    return tv_chambolle(img, weight, eps, max_num_iter)[0]


# ---------------------------------------------------------------------------
# Perona-Malik anisotropic diffusion
# ---------------------------------------------------------------------------


def check_pm_args(niter: int, option: int) -> None:
    if niter < 1:
        raise ValueError("niter must be >= 1")
    if option not in (1, 2):
        raise ValueError("option must be 1 (exponential) or 2 (inverse)")


def pm_constants(kappa: float, gamma: float) -> tuple[float, float]:
    """(1 / kappa^2, gamma) as the reference's float32 constants."""
    return (float(np.float32(1.0 / (float(kappa) * float(kappa)))),
            float(np.float32(gamma)))


def _pm_step(v: torch.Tensor, inv_k2: float, g32: float,
             option: int) -> torch.Tensor:
    """One explicit Perona-Malik update of [N, H, W]: forward differences,
    conduction on each, flux ((gamma * 1) * g) * d, backward-difference
    divergence, zero flux across the border (the reference's edge pad)."""

    def flux(d):
        if option == 1:
            g = torch.exp(-(d * d) * inv_k2)
        else:
            g = 1.0 / (1.0 + (d * d) * inv_k2)
        return (g32 * g) * d

    f0 = flux(F.pad(v[:, 1:, :] - v[:, :-1, :], (0, 0, 0, 1)))
    div0 = f0 - F.pad(f0[:, :-1, :], (0, 0, 1, 0))
    f1 = flux(F.pad(v[:, :, 1:] - v[:, :, :-1], (0, 1)))
    div1 = f1 - F.pad(f1[:, :, :-1], (1, 0))
    return v + (div0 + div1)


def anisotropic_diffusion(
    img: torch.Tensor,
    niter: int = 10,
    kappa: float = 50.0,
    gamma: float = 0.1,
    option: int = 1,
) -> torch.Tensor:
    """Perona-Malik edge-preserving smoothing of each 2-D slice (the
    medpy/Kovesi ``anisodiff`` explicit scheme, zero-flux borders, a fixed
    ``niter``). Option 1: g = exp(-(d/kappa)^2); 2: 1 / (1 + (d/kappa)^2)."""
    niter, option = int(niter), int(option)
    check_pm_args(niter, option)
    x, lead = _as_slices(img)
    inv_k2, g32 = pm_constants(kappa, gamma)
    for _ in range(niter):
        x = _pm_step(x, inv_k2, g32, option)
    return x.reshape(*lead, *x.shape[-2:])


# ---------------------------------------------------------------------------
# SRAD
# ---------------------------------------------------------------------------


def check_srad_args(niter: int, dt: float, q0: float, rho: float) -> None:
    if niter < 1:
        raise ValueError("niter must be >= 1")
    if not 0.0 < dt <= 0.25:
        raise ValueError(f"dt must be in (0, 0.25], got {dt}")
    if q0 <= 0 or rho < 0:
        raise ValueError("q0 must be > 0 and rho >= 0")


def srad_q0t_arg(rho: float, t: int) -> float:
    """-rho * t as the float32 product the reference takes the exp of."""
    return float(np.float32(-np.float32(rho)) * np.float32(t))


def _srad_conduction(d_n, d_s, d_w, d_e, v, q02, eps32):
    ii = v + eps32
    g2 = (d_n * d_n + d_s * d_s + d_w * d_w + d_e * d_e) / (ii * ii)
    el = (d_n + d_s + d_w + d_e) / ii
    a = 1.0 + 0.25 * el
    q2 = (0.5 * g2 - 0.0625 * (el * el)) / (a * a + 1e-12)
    c = 1.0 / (1.0 + (q2 - q02) / (q02 * (1.0 + q02) + 1e-12))
    return torch.clamp(c, 0.0, 1.0)


def _srad_step(v: torch.Tensor, dt4: float, q02: torch.Tensor,
               eps32: float) -> torch.Tensor:
    """One SRAD update of [N, H, W] (Yu & Acton 2002): the conduction c
    on the image and a ring of one, all from the edge-replicated image,
    then ``v + dt/4 (c_S dS + c dN + c_E dE + c dW)``."""
    zz = _pad_axis(_pad_axis(v, 2, -2, "nearest"), 2, -1, "nearest")
    inner = zz[:, 1:-1, 1:-1]
    d_n = zz[:, :-2, 1:-1] - inner
    d_s = zz[:, 2:, 1:-1] - inner
    d_w = zz[:, 1:-1, :-2] - inner
    d_e = zz[:, 1:-1, 2:] - inner
    c = _srad_conduction(d_n, d_s, d_w, d_e, inner, q02, eps32)
    cc = c[:, 1:-1, 1:-1]
    div = (c[:, 2:, 1:-1] * d_s[:, 1:-1, 1:-1] + cc * d_n[:, 1:-1, 1:-1]
           + c[:, 1:-1, 2:] * d_e[:, 1:-1, 1:-1] + cc * d_w[:, 1:-1, 1:-1])
    return v + dt4 * div


def srad(
    img: torch.Tensor,
    niter: int = 15,
    dt: float = 0.15,
    q0: float = 1.0,
    rho: float = 0.2,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Speckle-reducing anisotropic diffusion (Yu & Acton 2002) of each
    2-D slice: diffusion gated by the instantaneous coefficient of
    variation, with the speckle scale ``q0 * exp(-rho * t)`` at iteration
    t computed in float32 on the tensor's device, as the reference does."""
    niter = int(niter)
    check_srad_args(niter, dt, q0, rho)
    x, lead = _as_slices(img)
    for t in range(niter):
        x = srad_iteration(x, t, dt, q0, rho, eps)
    return x.reshape(*lead, *x.shape[-2:])


def srad_iteration(x: torch.Tensor, t: int, dt: float, q0: float,
                   rho: float, eps: float) -> torch.Tensor:
    """Iteration ``t`` of srad on [N, H, W] (the plain version of one K10
    launch; the row-sharded chain runs each on a halo-extended band)."""
    q0t = float(np.float32(q0)) * torch.exp(x.new_full((), srad_q0t_arg(rho, t)))
    return _srad_step(x, float(np.float32(dt / 4.0)), q0t * q0t,
                      float(np.float32(eps)))
