"""Restoration denoisers, plain PyTorch: non-local means, TV-Chambolle,
Perona-Malik diffusion, SRAD and the Wiener-Hunt deconvolution, in 2-D and
3-D, and the Richardson-Lucy deconvolution (2-D).

Same semantics and f32 operation order as ``mies_tpu.ops.restoration``. The
2-D ops are written for a batch: each takes float32 ``[..., H, W]`` and
treats every leading index as its own slice, as the reference does under
``vmap``. The ``*3d`` ops take one [Z, H, W] volume, couple all three axes
and take their statistics (TV's energy) over the whole volume; NL-means 3-D
runs its pairs one after another, never a stack of them. The 2-D ops are
the plain versions the K9-K12 kernels (``mies_tpu_torch.kernels.diffusion``,
``.nlmeans``, ``.tv``) are held against, and what the wrappers run on a
CPU tensor.

Operation order is the reference's, op by op; eager torch does not contract
a multiply and an add into an FMA. Every division the reference makes is a
true division here: the divisor is a tensor (CUDA torch divides by a
Python scalar as a multiply by its reciprocal), and ``1.0 / t`` is
``reciprocal``, which is correctly rounded.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.filters import (
    _conv1d_shifted,
    _pad2d,
    _sqrt_rn,
    _pad_axis,
    check_volume,
    gaussian_kernel1d,
)

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
    shape: tuple[int, ...], patch_size: int, patch_distance: int, h: float,
    sigma: float,
) -> tuple[int, int, float, float]:
    """(s, d, bias, inv_h2sn) of an NL-means call on images of ``shape``
    (2 or 3 axes; the patch holds s^len(shape) pixels): an even patch size
    becomes s + 1 (skimage), the constants are computed in float64 and
    rounded to float32 once, and the reflect extension of width s // 2 + d
    must fit the image (numpy 'reflect' needs it < dim)."""
    s = patch_size if patch_size % 2 == 1 else patch_size + 1
    d = int(patch_distance)
    pad = s // 2 + d
    if any(pad > n - 1 for n in shape):
        raise ValueError(
            f"patch_size//2 + patch_distance = {pad} must be < every image "
            f"dim - 1 (got shape {tuple(shape)}); shrink patch_distance"
        )
    sn = float(s) ** len(shape)
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


def denoise_nl_means3d(
    vol: torch.Tensor,
    patch_size: int = 5,
    patch_distance: int = 5,
    h: float = 0.1,
    sigma: float = 0.0,
) -> torch.Tensor:
    """Volumetric non-local means on [Z, H, W] (skimage's
    ``_fast_nl_means_denoising_3d``, the reference's n-d symmetric-pair
    loop): patches of s^3 voxels and the search cube [-d, d]^3 extend
    across slices. The half table's pairs (665 at d 5) run one after
    another, each a distance field on the domain extended by d, its patch
    sum z then y then x, and both endpoints accumulated; the volume is
    extended once by numpy 'reflect' of width s // 2 + d (the reference's
    extra 'edge' ring only keeps its slice shapes static)."""
    check_volume(vol, "denoise_nl_means3d")
    x = vol.to(torch.float32)
    shape = tuple(x.shape)
    s, d, bias, inv_h2sn = nl_means_params(shape, patch_size,
                                           patch_distance, h, sigma)
    o = s // 2
    up = x
    for axis in (-3, -2, -1):
        up = _pad_axis(up, o + d, axis, "mirror")
    # `up` index j holds u at j - (o + d): the reflect extension that the
    # patch distances over q in [-d, n + d) read
    ext = tuple(n + 2 * d + 2 * o for n in shape)

    def window(t, start, size):
        return t[start[0]:start[0] + size[0], start[1]:start[1] + size[1],
                 start[2]:start[2] + size[2]]

    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dec in half_shift_table(d, 3):
        t = [int(v) - d for v in dec]
        # u(c) - u(c + t) where both c and c + t lie in `up`: the only
        # distances either endpoint reads (the reference computes more on
        # its 'edge' ring and never reads them)
        lo = [max(0, -ti) for ti in t]
        size = [e - abs(ti) for e, ti in zip(ext, t)]
        diff = window(up, lo, size) - window(up, [a + ti for a, ti in
                                                  zip(lo, t)], size)
        sq = diff * diff
        for ax in range(3):
            n = sq.shape[ax] - (s - 1)
            acc = sq.narrow(ax, 0, n)
            for j in range(1, s):
                acc = acc + sq.narrow(ax, j, n)
            sq = acc
        dist = torch.clamp_min(sq - bias, 0.0) * inv_h2sn
        w = torch.where(dist <= DISTANCE_CUTOFF, torch.exp(-dist), 0.0)
        # w index k is the distance at q = k + lo - d: the forward end
        # w_t(p) with u(p + t), the reverse end w_t(p - t) with u(p - t)
        w_f = window(w, [d - a for a in lo], shape)
        w_r = window(w, [d - a - ti for a, ti in zip(lo, t)], shape)
        v_f = window(up, [o + d + ti for ti in t], shape)
        v_r = window(up, [o + d - ti for ti in t], shape)
        num = num + (w_f * v_f + w_r * v_r)
        den = den + (w_f + w_r)
    return (num + 2.0 * x) / (den + 2.0)


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


def tv_chambolle3d(
    vol: torch.Tensor, weight: float, eps: float, max_num_iter: int
) -> tuple[torch.Tensor, int]:
    """Chambolle-2004 dual projection of a [Z, H, W] volume (skimage
    ``_denoise_tv_chambolle_nd`` at ndim 3, the reference's while loop):
    tau = 1/6, the dual field one tensor per axis, and ONE stop test for
    the whole volume, its energy (sum d^2 + weight sum |g|) / size. The
    sums are taken in float64 and rounded to float32 and |g| is the
    correctly rounded root, so the card and the CPU stop at the same
    iteration with the same bits; the test reads the energy on the host,
    once an iteration. Returns (out, iterations run)."""
    check_volume(vol, "denoise_tv3d")
    if max_num_iter < 1:
        raise ValueError("max_num_iter must be >= 1")
    x = vol.to(torch.float32)
    w32 = np.float32(weight)
    eps32 = np.float32(eps)
    tau = np.float32(1.0 / 6.0)
    tau_w = float(tau / w32)
    size = x.new_full((), float(np.float32(float(x.numel()))))
    p = [torch.zeros_like(x) for _ in range(3)]
    out = x
    e_prev = e_init = np.float32(0.0)
    for i in range(int(max_num_iter)):
        # divergence: -(p0 + p1 + p2), then each axis's backward term
        d = -((p[0] + p[1]) + p[2])
        for ax in range(3):
            d = d + F.pad(p[ax].narrow(ax, 0, x.shape[ax] - 1),
                          (0, 0) * (2 - ax) + (1, 0))
        out = x + d
        e = (d * d).sum(dtype=torch.float64).to(torch.float32)
        g = [F.pad(out.narrow(ax, 1, x.shape[ax] - 1)
                   - out.narrow(ax, 0, x.shape[ax] - 1),
                   (0, 0) * (2 - ax) + (0, 1)) for ax in range(3)]
        norm = _sqrt_rn((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2])
        e = (e + float(w32) * norm.sum(dtype=torch.float64).to(torch.float32)
             ) / size
        factor = 1.0 + tau_w * norm
        p = [(p[ax] - float(tau) * g[ax]) / factor for ax in range(3)]
        e = np.float32(e.item())
        if i == 0:
            e_init = e
        elif abs(e_prev - e) < eps32 * e_init:
            return out, i + 1
        e_prev = e
    return out, int(max_num_iter)


def denoise_tv3d(
    vol: torch.Tensor,
    weight: float = 0.1,
    eps: float = 2e-4,
    max_num_iter: int = 200,
) -> torch.Tensor:
    """Volumetric TV denoising on [Z, H, W]: the TV prior couples all three
    axes (skimage's n-d loop), one stop test for the volume."""
    return tv_chambolle3d(vol, weight, eps, max_num_iter)[0]


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


def _pm_step3d(v: torch.Tensor, inv_k2: float, g32: np.float32,
               option: int, spacing: tuple) -> torch.Tensor:
    """One explicit Perona-Malik update of a [Z, H, W] volume: per axis the
    forward difference times float32(1 / spacing), its conduction, the flux
    ((gamma * s) * g) * d and its backward difference, zero flux across
    the border; the three axes' terms summed z, y, x, then added."""
    upd = None
    for ax in range(3):
        s = np.float32(1.0 / float(spacing[ax]))
        n = v.shape[ax]
        pad_end = (0, 0) * (2 - ax) + (0, 1)
        d = F.pad(v.narrow(ax, 1, n - 1) - v.narrow(ax, 0, n - 1),
                  pad_end) * float(s)
        if option == 1:
            g = torch.exp(-(d * d) * inv_k2)
        else:
            g = 1.0 / (1.0 + (d * d) * inv_k2)
        flux = (float(g32 * s) * g) * d
        div = flux - F.pad(flux.narrow(ax, 0, n - 1),
                           (0, 0) * (2 - ax) + (1, 0))
        upd = div if upd is None else upd + div
    return v + upd


def anisotropic_diffusion3d(
    vol: torch.Tensor,
    niter: int = 10,
    kappa: float = 50.0,
    gamma: float = 0.1,
    option: int = 1,
    voxelspacing: tuple | None = None,
) -> torch.Tensor:
    """Volumetric Perona-Malik diffusion on [Z, H, W]: the conduction
    couples all three axes; ``voxelspacing`` (dz, dy, dx) scales each
    axis's differences (the medpy convention: gradient and divergence both
    divide by the spacing). Stability: ``gamma * sum(1 / s^2) <= 1/2``."""
    check_volume(vol, "anisotropic_diffusion3d")
    step = pm3d_step(niter, kappa, gamma, option, voxelspacing)
    x = vol.to(torch.float32)
    for _ in range(int(niter)):
        x = step(x)
    return x


def pm3d_step(niter: int, kappa: float, gamma: float, option: int,
              voxelspacing: tuple | None):
    """The arguments of ``anisotropic_diffusion3d`` checked, bound into its
    one-step function [Z, H, W] -> [Z, H, W] (the z band's runs it on a
    slab extended by one edge-replicated slice each side)."""
    if voxelspacing is None:
        sp = (1.0,) * 3
    else:
        sp = tuple(float(v) for v in voxelspacing)
        if len(sp) != 3 or any(v <= 0 for v in sp):
            raise ValueError(
                "voxelspacing must be 3 positive numbers (dz, dy, dx)"
            )
    option = int(option)
    check_pm_args(int(niter), option)
    inv_k2 = pm_constants(kappa, gamma)[0]
    g32 = np.float32(gamma)
    return lambda x: _pm_step3d(x, inv_k2, g32, option, sp)


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


def _srad_step3d(v: torch.Tensor, dt6: float, q02: torch.Tensor,
                 eps32: float) -> torch.Tensor:
    """One volumetric SRAD update (the reference's ``_srad_step3d``): the
    2-D step's form with 6-neighbour sums, the conduction on the volume
    and a ring of one, all from the edge-replicated volume, then
    ``v + dt/6 (c_D dD + c dU + c_S dS + c dN + c_E dE + c dW)``."""
    zz = v
    for axis in (-3, -2, -1):
        zz = _pad_axis(zz, 2, axis, "nearest")
    c0 = zz[1:-1, 1:-1, 1:-1]
    d_u = zz[:-2, 1:-1, 1:-1] - c0
    d_d = zz[2:, 1:-1, 1:-1] - c0
    d_n = zz[1:-1, :-2, 1:-1] - c0
    d_s = zz[1:-1, 2:, 1:-1] - c0
    d_w = zz[1:-1, 1:-1, :-2] - c0
    d_e = zz[1:-1, 1:-1, 2:] - c0
    ii = c0 + eps32
    g2 = (d_u * d_u + d_d * d_d + d_n * d_n + d_s * d_s
          + d_w * d_w + d_e * d_e) / (ii * ii)
    el = (d_u + d_d + d_n + d_s + d_w + d_e) / ii
    a = 1.0 + 0.25 * el
    q2 = (0.5 * g2 - 0.0625 * (el * el)) / (a * a + 1e-12)
    c = 1.0 / (1.0 + (q2 - q02) / (q02 * (1.0 + q02) + 1e-12))
    c = torch.clamp(c, 0.0, 1.0)
    cc = c[1:-1, 1:-1, 1:-1]
    inr = (slice(1, -1),) * 3
    div = (c[2:, 1:-1, 1:-1] * d_d[inr] + cc * d_u[inr]
           + c[1:-1, 2:, 1:-1] * d_s[inr] + cc * d_n[inr]
           + c[1:-1, 1:-1, 2:] * d_e[inr] + cc * d_w[inr])
    return v + dt6 * div


def srad3d(
    vol: torch.Tensor,
    niter: int = 15,
    dt: float = 0.15,
    q0: float = 1.0,
    rho: float = 0.2,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Volumetric SRAD on [Z, H, W] (3-D ultrasound): the 2-D op's ICOV
    gating with 6-neighbour coupling, the same q0 * exp(-rho t) schedule
    in float32 on the device, step dt / 6."""
    check_volume(vol, "srad3d")
    niter = int(niter)
    check_srad_args(niter, dt, q0, rho)
    x = vol.to(torch.float32)
    for t in range(niter):
        x = srad3d_iteration(x, t, dt, q0, rho, eps)
    return x


def srad3d_iteration(x: torch.Tensor, t: int, dt: float, q0: float,
                     rho: float, eps: float) -> torch.Tensor:
    """Iteration ``t`` of srad3d on [Z, H, W] float32 (the z band's runs
    it on a slab extended by two edge-replicated slices each side)."""
    q0t = float(np.float32(q0)) * torch.exp(x.new_full((), srad_q0t_arg(rho, t)))
    return _srad_step3d(x, float(np.float32(dt / 6.0)), q0t * q0t,
                        float(np.float32(eps)))


# ---------------------------------------------------------------------------
# Richardson-Lucy deconvolution
# ---------------------------------------------------------------------------


def _gauss_same(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable 'same' zero-padded convolution (scipy.signal.convolve
    mode='same' with a symmetric kernel, so a correlation)."""
    return _conv1d_shifted(_conv1d_shifted(x, taps, -2, "constant"),
                           taps, -1, "constant")


def richardson_lucy(
    img: torch.Tensor,
    psf_sigma: float = 1.5,
    psf_size: int = 7,
    num_iter: int = 30,
    clip: bool = True,
    filter_epsilon: float | None = None,
) -> torch.Tensor:
    """Richardson-Lucy deconvolution with a separable Gaussian PSF,
    skimage.restoration.richardson_lucy semantics: init 0.5, 1e-12 added
    to the blurred estimate, the relative blur zeroed where that is below
    ``filter_epsilon`` (if given), the result clipped to [-1, 1]. Four
    zero-padded 1-D passes an iteration."""
    if psf_size % 2 != 1:
        raise ValueError("psf_size must be odd")
    if num_iter < 1:
        raise ValueError("num_iter must be >= 1")
    taps = gaussian_kernel1d(float(psf_sigma), psf_size // 2)
    x = img.to(torch.float32)
    conv_eps = float(np.float32(1e-12))
    im = torch.full_like(x, 0.5)
    for _ in range(int(num_iter)):
        conv = _gauss_same(im, taps) + conv_eps
        rel = x / conv
        if filter_epsilon:
            rel = torch.where(conv < float(np.float32(filter_epsilon)),
                              torch.zeros_like(rel), rel)
        im = im * _gauss_same(rel, taps)
    return torch.clamp(im, -1.0, 1.0) if clip else im


# ---------------------------------------------------------------------------
# Wiener-Hunt deconvolution
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _rl_psf(psf_sigma: float, psf_size: int) -> np.ndarray:
    """The 2-D PSF the registry op implies (for goldens and diagnostics)."""
    g = gaussian_kernel1d(float(psf_sigma), psf_size // 2).astype(np.float64)
    return np.outer(g, g)


def _ir2tf_np(ir: np.ndarray, shape: tuple) -> np.ndarray:
    """skimage.restoration.uft.ir2tf: zero-pad the impulse response to
    ``shape``, roll each axis so the kernel centre lands at the origin,
    real-FFT. Host-side float64."""
    pad = np.zeros(shape, np.float64)
    pad[tuple(slice(0, s) for s in ir.shape)] = ir
    for ax, s in enumerate(ir.shape):
        pad = np.roll(pad, -int(np.floor(s / 2)), axis=ax)
    return np.fft.rfftn(pad, axes=tuple(range(len(shape))))


def _laplacian_ir_np(ndim: int) -> np.ndarray:
    """skimage uft.laplacian impulse response: 2 ndim at the centre, -1 at
    each face neighbour (the Wiener filter's regularizer)."""
    impr = np.zeros((3,) * ndim, np.float64)
    for dim in range(ndim):
        idx = tuple(
            [slice(1, 2)] * dim + [slice(None)]
            + [slice(1, 2)] * (ndim - dim - 1)
        )
        impr[idx] = np.array([-1.0, 0.0, -1.0]).reshape(
            [-1 if i == dim else 1 for i in range(ndim)]
        )
    impr[(slice(1, 2),) * ndim] = 2.0 * ndim
    return impr


@functools.lru_cache(maxsize=16)
def _wiener_filter_np(shape: tuple, psf_sigma: float, psf_size: int,
                      balance: float) -> np.ndarray:
    """The Wiener transfer conj(H) / (|H|^2 + balance |L|^2) on the rfftn
    grid of ``shape``: H the separable Gaussian PSF's transfer, L the
    Laplacian regularizer's. Host-side float64, returned complex64."""
    g = gaussian_kernel1d(float(psf_sigma), psf_size // 2).astype(np.float64)
    psf = g
    for _ in range(len(shape) - 1):
        psf = np.multiply.outer(psf, g)
    tf = _ir2tf_np(psf, shape)
    reg = _ir2tf_np(_laplacian_ir_np(len(shape)), shape)
    filt = np.conj(tf) / (np.abs(tf) ** 2 + balance * np.abs(reg) ** 2)
    return filt.astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _wiener_filter(shape: tuple, psf_sigma: float, psf_size: int,
                   balance: float, device: torch.device) -> torch.Tensor:
    """``_wiener_filter_np`` on ``device``, kept per shape."""
    return torch.as_tensor(
        _wiener_filter_np(shape, psf_sigma, psf_size, balance), device=device)


def _wiener_nd(x: torch.Tensor, psf_sigma: float, psf_size: int,
               balance: float, clip: bool, nd: int) -> torch.Tensor:
    if psf_size % 2 != 1:
        raise ValueError("psf_size must be odd")
    if balance <= 0:
        raise ValueError("balance must be > 0")
    x = x.to(torch.float32)
    shape = tuple(x.shape[-nd:])
    dims = tuple(range(-nd, 0))
    filt = _wiener_filter(shape, float(psf_sigma), int(psf_size),
                          float(balance), x.device)
    out = torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * filt, s=shape,
                           dim=dims)
    return torch.clamp(out, -1.0, 1.0) if clip else out


def wiener(
    img: torch.Tensor,
    psf_sigma: float = 1.5,
    psf_size: int = 7,
    balance: float = 0.1,
    clip: bool = True,
) -> torch.Tensor:
    """Wiener-Hunt deconvolution of each [H, W] slice,
    skimage.restoration.wiener semantics with the separable Gaussian PSF:
    ``irfft(conj(H) / (|H|^2 + balance |L|^2) * rfft(y))``, L the Laplacian
    regularizer, clipped to [-1, 1]. The transfer is built on the host in
    float64 (one complex64 tensor per shape); ``torch.fft`` is cuFFT on
    the card."""
    return _wiener_nd(img, psf_sigma, psf_size, balance, clip, 2)


def wiener3d(
    vol: torch.Tensor,
    psf_sigma: float = 1.5,
    psf_size: int = 7,
    balance: float = 0.1,
    clip: bool = True,
) -> torch.Tensor:
    """Volumetric Wiener deconvolution on [Z, H, W]: the isotropic 3-D
    Gaussian PSF and the 3-D Laplacian regularizer."""
    check_volume(vol, "wiener3d")
    return _wiener_nd(vol, psf_sigma, psf_size, balance, clip, 3)
