"""Multiscale Hessian ridge filters, plain PyTorch: Frangi vesselness
(and ``vessel_enhance``, its in-place blend), Sato tubeness, Meijering
neuriteness and the hybrid Hessian filter, on slices and (the ``*3d``
forms) on [Z, H, W] volumes.

Same semantics and f32 operation order as ``mies_tpu.ops.ridges`` (the
papers' definitions with skimage-like APIs): per scale sigma the
sigma^2-normalized Hessian from Gaussian-derivative passes that equal
``scipy.ndimage.gaussian_filter(order=...)``'s taps, the analytic 2x2
symmetric eigenvalues, then each filter's formula; max over scales.

Each derivative is one pass per axis, axis -2 then axis -1, by the port's
``filters._conv1d_shifted``: shifted adds in scipy's tap order, each a
multiply then an add, with the border built by index. No ``F.conv1d``:
its reduction order is not scipy's, and a row band extended by its halo
must give the unsharded image's bits (``parallel/halo.py``).

The reference's ops take one image; these take [..., H, W], every leading
dimension a batch dimension, and each statistic of the image is one
image's: frangi's ``gamma=None`` half-max Frobenius norm and meijering's
per-scale max. Meijering's default alpha is 1/(2 + 1), the slice's rank.
The volume forms take one [Z, H, W] volume: six Gaussian-derivative
Hessian components per scale, the reference's closed-form symmetric 3x3
eigenvalues (Smith's trigonometric method), and each statistic (frangi3d's
half-max norm, meijering3d's max) over the whole volume.
Where the reference divides by a constant, the divisor is a 0-d tensor on
the input's device (CUDA torch multiplies by the reciprocal of a Python
scalar).
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.ops.filters import _conv1d_shifted, check_volume
from mies_tpu_torch.ops.histogram import _const


def gaussian_derivative_kernel1d(
    sigma: float, order: int, radius: int
) -> np.ndarray:
    """scipy.ndimage's exact Gaussian-derivative taps (``_gaussian_kernel1d``
    transcription): the normalized Gaussian times the Hermite-recurrence
    polynomial q(x) with q'(x) accumulated ``order`` times. Returned in
    scipy's correlate orientation (already reversed)."""
    order = int(order)
    sigma = float(sigma)
    exponent_range = np.arange(order + 1)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi_x = np.exp(-0.5 / sigma2 * x**2)
    phi_x = phi_x / phi_x.sum()
    if order == 0:
        return phi_x[::-1].astype(np.float32)
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(exponent_range[1:], 1)  # D @ q(x) = q'(x)
    P = np.diag(np.ones(order) / -sigma2, -1)  # P @ q(x) = q(x) * p'(x)
    Q_deriv = D + P
    for _ in range(order):
        q = Q_deriv.dot(q)
    q = (x[:, None] ** exponent_range).dot(q)
    return (q * phi_x)[::-1].astype(np.float32)


def gaussian_derivative(
    img: torch.Tensor,
    sigma: float,
    order: tuple,
    mode: str = "reflect",
    truncate: float = 4.0,
) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(img, sigma, order=order)`` over the
    last ``len(order)`` axes: one correlation pass per axis with the
    derivative taps, the first of those axes first."""
    radius = int(truncate * float(sigma) + 0.5)
    x = img.to(torch.float32)
    nd = len(order)
    for ax, o in enumerate(order):
        taps = gaussian_derivative_kernel1d(sigma, o, radius)
        x = _conv1d_shifted(x, taps, ax - nd, mode)
    return x


def _hessian2d(x: torch.Tensor, sigma: float, mode: str) -> tuple:
    """The sigma^2-normalized Gaussian-derivative Hessian of each slice:
    (h_rr, h_rc, h_cc)."""
    s2 = float(np.float32(float(sigma) ** 2))
    return tuple(s2 * gaussian_derivative(x, sigma, o, mode)
                 for o in ((2, 0), (1, 1), (0, 2)))


def _eig2(hrr, hrc, hcc) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic eigenvalues of the symmetric 2x2 field, (mu + root,
    mu - root)."""
    mu = 0.5 * (hrr + hcc)
    root = torch.sqrt(torch.square(0.5 * (hrr - hcc)) + torch.square(hrc))
    return mu + root, mu - root


def _image_max(v: torch.Tensor, nd: int = 2) -> torch.Tensor:
    return v.amax(dim=tuple(range(-nd, 0)), keepdim=True)


def frangi(
    img: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float | None = None,
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Frangi-1998 multiscale vesselness of each [H, W] slice: per scale,
    eigenvalues of the sigma^2-normalized Hessian sorted by magnitude
    (|l1| <= |l2|), Rb = |l1|/|l2|, S = |H|_F, then

        V = exp(-Rb^2 / (2 beta^2)) * (1 - exp(-S^2 / (2 gamma^2)))

    zeroed where l2 > 0 (``black_ridges`` flips the slice first: dark
    vessels); max over scales. ``gamma=None``: half each slice's maximum
    Frobenius norm at each scale. ``alpha`` is accepted for API parity
    (the plate term exists only in 3-D)."""
    x = img.to(torch.float32)
    if black_ridges:
        x = -x
    two_b2 = x.new_full((), 2.0 * float(beta) ** 2)  # a true divisor
    result = None
    for sigma in sigmas:
        la, lb = _eig2(*_hessian2d(x, sigma, mode))
        big = la.abs() >= lb.abs()
        l2 = torch.where(big, la, lb)  # |l2| >= |l1|
        l1 = torch.where(big, lb, la)
        s_sq = torch.square(l1) + torch.square(l2)
        rb_sq = torch.square(l1) / torch.clamp_min(torch.square(l2), 1e-30)
        if gamma is None:
            smax = torch.sqrt(_image_max(s_sq))
            g = torch.where(smax > 0, 0.5 * smax, 1.0)
        else:
            g = x.new_full((), gamma)
        v = torch.exp(-rb_sq / two_b2) * (
            1.0 - torch.exp(-s_sq / (2.0 * g * g))
        )
        v = torch.where(l2 > 0, 0.0, v)
        result = v if result is None else torch.maximum(result, v)
    return result


def vessel_enhance(
    img: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float | None = None,
    black_ridges: bool = True,
    amount: float = 1.0,
    mode: str = "reflect",
) -> torch.Tensor:
    """Vessel enhancement in place: ``img + amount * frangi(img)``,
    clipped to [0, 1]."""
    v = frangi(img, sigmas, alpha, beta, gamma, black_ridges, mode)
    return torch.clamp(img + float(amount) * v, 0.0, 1.0)


def sato(
    img: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Sato-1998 multiscale tubeness of each [H, W] slice: per scale,
    ``-l_min`` of the sigma^2-normalized Hessian where ``l_min < 0``, else
    0; max over scales. No statistic of the image."""
    x = img.to(torch.float32)
    if black_ridges:
        x = -x
    result = None
    for sigma in sigmas:
        _, lmin = _eig2(*_hessian2d(x, sigma, mode))
        v = torch.where(lmin < 0, -lmin, 0.0)
        result = v if result is None else torch.maximum(result, v)
    return result


def _meijering_core(x: torch.Tensor, sigmas: tuple, alpha: float,
                    mode: str, nd: int = 2) -> torch.Tensor:
    """The Meijering body on pre-flipped images of ``nd`` axes (2: a slice
    batch, 3: one volume): per scale, the modified eigenvalues l'_i = l_i +
    alpha * sum_{j != i} l_j, the largest-|.| one per pixel, max(-l', 0)
    normalized by each image's max; max over scales."""
    a = float(np.float32(alpha))
    result = None
    for sigma in sigmas:
        if nd == 2:
            eigs = _eig2(*_hessian2d(x, sigma, mode))
        else:
            eigs = _eigvalsh3_descending(*_hessian3d(x, sigma, mode))
        total = sum(eigs)  # 0 + l1 + l2 (+ l3), the reference's sum
        mods = [e + a * (total - e) for e in eigs]
        sel = mods[0]
        for m in mods[1:]:
            sel = torch.where(m.abs() > sel.abs(), m, sel)
        v = torch.clamp_min(-sel, 0.0)
        vmax = _image_max(v, nd)
        v = torch.where(vmax > 0, v / torch.clamp_min(vmax, 1e-30), v)
        result = v if result is None else torch.maximum(result, v)
    return result


def meijering(
    img: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    alpha: float | None = None,
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Meijering-2004 multiscale neuriteness of each [H, W] slice (default
    alpha 1/3, the slice's 1/(ndim + 1)); each scale's response is
    normalized to [0, 1] by the slice's own max."""
    x = img.to(torch.float32)
    if black_ridges:
        x = -x
    if alpha is None:
        alpha = 1.0 / (2 + 1)
    return _meijering_core(x, sigmas, float(alpha), mode)


def hessian(
    img: torch.Tensor,
    sigmas: tuple = (1.0, 3.0, 5.0, 7.0, 9.0),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float = 15.0,
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Hybrid Hessian ridge filter (Ng et al. 2014), skimage.filters.hessian
    semantics: the Frangi response with values <= 0 mapped to 1 and the
    fixed default gamma 15."""
    if gamma is None:
        raise ValueError(
            "hessian requires an explicit gamma (skimage's default is "
            "15); gamma=None is frangi's global-statistic convention"
        )
    f = frangi(img, sigmas, alpha, beta, gamma, black_ridges, mode)
    return torch.where(f <= 0.0, 1.0, f)


# ---------------------------------------------------------------------------
# Volumes
# ---------------------------------------------------------------------------


def _hessian3d(x: torch.Tensor, sigma: float, mode: str) -> tuple:
    """The sigma^2-normalized Hessian of a [Z, H, W] volume: (h_zz, h_zy,
    h_zx, h_yy, h_yx, h_xx)."""
    s2 = float(np.float32(float(sigma) ** 2))
    orders = ((2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
              (0, 0, 2))
    return tuple(s2 * gaussian_derivative(x, sigma, o, mode) for o in orders)


def _eigvalsh3_descending(azz, azy, azx, ayy, ayx, axx) -> tuple:
    """Closed-form eigenvalues of the symmetric 3x3 field (Smith's
    trigonometric method), by signed value descending (e1 >= e2 >= e3):
    q = trace / 3, p = sqrt(max(p2, 1e-30) / 6), r = det(B) / 2 clipped
    to [-1, 1], phi = acos(r) / 3; a numerically isotropic point (p2 <
    1e-24) gets the triple root q. The divisions are true divisions (0-d
    tensor divisors), as the reference's eager op divides."""
    c3, c6 = _const(azz, 3.0), _const(azz, 6.0)
    q = (azz + ayy + axx) / c3
    p1 = azy * azy + azx * azx + ayx * ayx
    dz, dy, dx = azz - q, ayy - q, axx - q
    p2 = dz * dz + dy * dy + dx * dx + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2, 1e-30) / c6)
    inv_p = 1.0 / p
    bzz, byy, bxx = dz * inv_p, dy * inv_p, dx * inv_p
    bzy, bzx, byx = azy * inv_p, azx * inv_p, ayx * inv_p
    detb = (
        bzz * (byy * bxx - byx * byx)
        - bzy * (bzy * bxx - byx * bzx)
        + bzx * (bzy * byx - byy * bzx)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / c3
    two_p = 2.0 * p
    e1 = q + two_p * torch.cos(phi)
    e3 = q + two_p * torch.cos(phi + float(np.float32(2.0 * np.pi / 3.0)))
    e2 = 3.0 * q - e1 - e3
    iso = p2 < 1e-24
    return (torch.where(iso, q, e1), torch.where(iso, q, e2),
            torch.where(iso, q, e3))


def _eigvalsh3_by_magnitude(*h) -> tuple:
    """The eigenvalues sorted by |lambda| ascending (the Frangi order):
    ``_eigvalsh3_descending`` and a 3-comparator magnitude sort."""
    e1, e2, e3 = _eigvalsh3_descending(*h)

    def swap(a, b):
        sw = a.abs() > b.abs()
        return torch.where(sw, b, a), torch.where(sw, a, b)

    l1, l2 = swap(e1, e2)
    l2, l3 = swap(l2, e3)
    l1, l2 = swap(l1, l2)
    return l1, l2, l3


def frangi3d(
    vol: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float | None = None,
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Frangi-1998 vesselness of a [Z, H, W] volume: per scale, eigenvalues
    |l1| <= |l2| <= |l3| of the sigma^2-normalized Hessian, then

        V = (1 - exp(-Ra^2 / 2a^2)) exp(-Rb^2 / 2b^2) (1 - exp(-S^2 / 2g^2))

    with Ra^2 = l2^2 / l3^2, Rb^2 = l1^2 / |l2 l3|, S^2 = sum l^2; zero
    where l2 > 0 or l3 > 0 (``black_ridges`` flips the volume first); max
    over scales. ``gamma=None``: half the volume's max Frobenius norm at
    each scale."""
    check_volume(vol, "frangi3d")
    x = vol.to(torch.float32)
    if black_ridges:
        x = -x
    two_a2 = x.new_full((), 2.0 * float(alpha) ** 2)  # true divisors
    two_b2 = x.new_full((), 2.0 * float(beta) ** 2)
    result = None
    for sigma in sigmas:
        l1, l2, l3 = _eigvalsh3_by_magnitude(*_hessian3d(x, sigma, mode))
        ra_sq = torch.square(l2) / torch.clamp_min(torch.square(l3), 1e-30)
        rb_sq = torch.square(l1) / torch.clamp_min((l2 * l3).abs(), 1e-30)
        s_sq = torch.square(l1) + torch.square(l2) + torch.square(l3)
        if gamma is None:
            smax = torch.sqrt(s_sq.amax())
            g = torch.where(smax > 0, 0.5 * smax, 1.0)
        else:
            g = x.new_full((), gamma)
        v = ((1.0 - torch.exp(-ra_sq / two_a2))
             * torch.exp(-rb_sq / two_b2)
             * (1.0 - torch.exp(-s_sq / (2.0 * g * g))))
        v = torch.where((l2 > 0) | (l3 > 0), 0.0, v)
        result = v if result is None else torch.maximum(result, v)
    return result


def vessel_enhance3d(
    vol: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float | None = None,
    black_ridges: bool = True,
    amount: float = 1.0,
    mode: str = "reflect",
) -> torch.Tensor:
    """Volumetric vessel enhancement in place: ``vol + amount *
    frangi3d(vol)``, clipped to [0, 1]."""
    v = frangi3d(vol, sigmas, alpha, beta, gamma, black_ridges, mode)
    return torch.clamp(vol + float(amount) * v, 0.0, 1.0)


def sato3d(
    vol: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Sato-1998 tubeness of a [Z, H, W] volume: per scale, with e1 >= e2
    >= e3 the Hessian's eigenvalues, sqrt(e2 e3) where e2 < 0 and e3 < 0,
    else 0; max over scales. No statistic of the volume."""
    check_volume(vol, "sato3d")
    x = vol.to(torch.float32)
    if black_ridges:
        x = -x
    result = None
    for sigma in sigmas:
        _, e2, e3 = _eigvalsh3_descending(*_hessian3d(x, sigma, mode))
        tube = (e2 < 0) & (e3 < 0)
        v = torch.where(tube, torch.sqrt(torch.clamp_min(e2 * e3, 0.0)), 0.0)
        result = v if result is None else torch.maximum(result, v)
    return result


def meijering3d(
    vol: torch.Tensor,
    sigmas: tuple = (1.0, 2.0, 4.0),
    alpha: float | None = None,
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Meijering-2004 neuriteness of a [Z, H, W] volume (default alpha
    1/4): each scale's response normalized by the volume's own max."""
    check_volume(vol, "meijering3d")
    x = vol.to(torch.float32)
    if black_ridges:
        x = -x
    if alpha is None:
        alpha = 1.0 / (3 + 1)
    return _meijering_core(x, sigmas, float(alpha), mode, 3)


def hessian3d(
    vol: torch.Tensor,
    sigmas: tuple = (1.0, 3.0, 5.0, 7.0, 9.0),
    alpha: float = 0.5,
    beta: float = 0.5,
    gamma: float = 15.0,
    black_ridges: bool = True,
    mode: str = "reflect",
) -> torch.Tensor:
    """Volumetric hybrid Hessian filter: the frangi3d response with values
    <= 0 mapped to 1 and the fixed default gamma 15."""
    if gamma is None:
        raise ValueError(
            "hessian3d requires an explicit gamma (skimage default 15)"
        )
    f = frangi3d(vol, sigmas, alpha, beta, gamma, black_ridges, mode)
    return torch.where(f <= 0.0, 1.0, f)
