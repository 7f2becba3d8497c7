"""Wavelet shrinkage denoising, plain PyTorch: ``denoise_wavelet``,
``estimate_sigma`` and ``cycle_spin``.

Same semantics and f32 operation order as ``mies_tpu.ops.wavelet``, which
follows skimage 0.26 / PyWavelets: symmetric signal extension, the
``coeffs[1::2]`` analysis phase, the ``[flen-2:]`` synthesis crop,
skimage's default level count ``max(min_axis_max_level - 3, 1)``, the
nonzero-masked MAD noise estimate, BayesShrink's ``var/sqrt(dvar-var)``
subband thresholds and VisuShrink's universal threshold. The DWT is
shifted adds over strided views (each tap a multiply then an add, in the
reference's tap order), the inverse its two polyphases interleaved.

The reference's ops take one image; here the spatial rank ``nd`` is
explicit and every leading dimension is a batch dimension. Everything the
reference computes from the image is one image's: the level count from
its (H, W), the noise estimate, each subband's threshold and VisuShrink's
pixel count. The thresholds stay device tensors of shape [..., 1, 1]:
nothing on the path copies to the host. BayesShrink's mean of squares
accumulates in float64 (the reference's float32 sum has no fixed order
either), so the card and the CPU find the same thresholds.

Only even-length orthogonal wavelets ship (haar/db1..db4, sym4).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mies_tpu_torch.ops.filters import _pad_axis, check_volume

# scaling (reconstruction lowpass) filters, PyWavelets coefficient tables;
# dec/rec hi/lo derive from these by the standard QMF relations
_SQ2 = math.sqrt(2.0)
_S3 = math.sqrt(3.0)
_WAVELETS: dict[str, tuple[float, ...]] = {
    "haar": (1.0 / _SQ2, 1.0 / _SQ2),
    "db2": (
        (1.0 + _S3) / (4.0 * _SQ2),
        (3.0 + _S3) / (4.0 * _SQ2),
        (3.0 - _S3) / (4.0 * _SQ2),
        (1.0 - _S3) / (4.0 * _SQ2),
    ),
    "db3": (
        0.3326705529509569,
        0.8068915093133388,
        0.4598775021193313,
        -0.13501102001039084,
        -0.08544127388224149,
        0.035226291882100656,
    ),
    "db4": (
        0.23037781330885523,
        0.7148465705525415,
        0.6308807679295904,
        -0.02798376941698385,
        -0.18703481171888114,
        0.030841381835986965,
        0.032883011666982945,
        -0.010597401784997278,
    ),
    "sym4": (
        0.032223100604042702,
        -0.012603967262037833,
        -0.099219543576847216,
        0.29785779560527736,
        0.80373875180591614,
        0.49761866763201545,
        -0.02963552764599851,
        -0.075765714789273325,
    ),
}
_WAVELETS["db1"] = _WAVELETS["haar"]

# norm.ppf(0.75): the Gaussian MAD -> sigma conversion constant
_MAD_DENOM = 0.6744897501960817


def wavelet_filters(name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi, rec_lo, rec_hi) for a named wavelet, PyWavelets'
    QMF conventions: rec_lo = scaling filter; dec_lo = rec_lo[::-1];
    rec_hi[k] = (-1)^k rec_lo[flen-1-k]; dec_hi = rec_hi[::-1]."""
    try:
        rec_lo = np.asarray(_WAVELETS[name], np.float64)
    except KeyError:
        raise ValueError(
            f"unknown wavelet {name!r}; supported: "
            f"{sorted(_WAVELETS)} (even-length orthogonal families)"
        ) from None
    flen = len(rec_lo)
    rec_hi = np.array(
        [(-1.0) ** k * rec_lo[flen - 1 - k] for k in range(flen)]
    )
    return rec_lo[::-1].copy(), rec_hi[::-1].copy(), rec_lo, rec_hi


def dwt_max_level(n: int, flen: int) -> int:
    """PyWavelets ``dwt_max_level``: floor(log2(n / (flen - 1)))."""
    if n < flen - 1 or n < flen:
        return 0
    return int(math.floor(math.log2(n / (flen - 1))))


def default_levels(shape: tuple[int, ...], flen: int) -> int:
    """skimage ``_wavelet_threshold`` default: min-axis max level - 3,
    floored at 1 (``shape`` is one image's)."""
    lv = min(dwt_max_level(int(n), flen) for n in shape)
    return max(lv - 3, 1)


def _view(x: torch.Tensor, axis: int, start: int, count: int,
          step: int = 1) -> torch.Tensor:
    """x[..., start : start + step * count : step, ...] along the negative
    ``axis``, a view."""
    idx = (Ellipsis, slice(start, start + step * (count - 1) + 1, step))
    return x[idx + (slice(None),) * (-1 - axis)]


def _vconv(xe: torch.Tensor, taps: np.ndarray, axis: int, out_len: int,
           start: int = 0, step: int = 1) -> torch.Tensor:
    """'valid' convolution along ``axis`` of the already-extended signal,
    at outputs m = start, start + step, ... (``out_len`` of them):
    out[m] = sum_j taps[j] * xe[m + flen-1 - j], the taps in order, each a
    multiply then an add."""
    flen = len(taps)
    acc = None
    for j in range(flen):
        c = float(np.float32(taps[j]))
        sl = _view(xe, axis, start + flen - 1 - j, out_len, step)
        acc = c * sl if acc is None else acc + c * sl
    return acc


def _dwt_axis(
    x: torch.Tensor, axis: int, dec_lo: np.ndarray, dec_hi: np.ndarray
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis level along one (negative) axis, PyWavelets
    mode='symmetric': pad flen-1 each side, valid-convolve, keep phase
    [1::2] (only those outputs are computed; each by the same sums)."""
    flen = len(dec_lo)
    n = x.shape[axis]
    xe = _pad_axis(x, flen - 1, axis, "reflect")  # np 'symmetric'
    out_len = (n + flen - 1) // 2
    a = _vconv(xe, dec_lo, axis, out_len, start=1, step=2)
    d = _vconv(xe, dec_hi, axis, out_len, start=1, step=2)
    return a, d


def _idwt_axis(
    a: torch.Tensor,
    d: torch.Tensor,
    axis: int,
    rec_lo: np.ndarray,
    rec_hi: np.ndarray,
    out_len: int,
) -> torch.Tensor:
    """One synthesis level along one (negative) axis: the upsample-convolve
    as its two polyphases (y[2m] uses taps f[0::2], y[2m+1] f[1::2]),
    interleaved, then PyWavelets' crop ``[flen-2 : flen-2 + out_len]``."""
    flen = len(rec_lo)
    if flen % 2 != 0:
        raise ValueError("even-length filters only")
    half = flen // 2
    plen = a.shape[axis] + half - 1
    pad = (0, 0) * (-1 - axis) + (half - 1, half - 1)

    def parity(c: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
        return _vconv(F.pad(c, pad), taps, axis, plen)  # full conv

    y_even = parity(a, rec_lo[0::2]) + parity(d, rec_hi[0::2])
    y_odd = parity(a, rec_lo[1::2]) + parity(d, rec_hi[1::2])
    ax = axis % a.dim()
    y = torch.stack([y_even, y_odd], dim=ax + 1).flatten(ax, ax + 1)
    return y.narrow(ax, flen - 2, out_len)


def _analysis_level(x: torch.Tensor, nd: int, dec_lo, dec_hi) -> dict:
    """One level over the last ``nd`` axes: the subbands keyed by one
    'a'/'d' character per axis."""
    bands = {"": x}
    for ax in range(nd):
        nxt = {}
        for key, arr in bands.items():
            lo, hi = _dwt_axis(arr, ax - nd, dec_lo, dec_hi)
            nxt[key + "a"] = lo
            nxt[key + "d"] = hi
        bands = nxt
    return bands


def wavedec_nd(
    x: torch.Tensor, wavelet: str, level: int, nd: int
) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
    """Multilevel DWT over the last ``nd`` axes (PyWavelets ``wavedecn``,
    mode='symmetric'): (approximation, details), details COARSEST FIRST,
    each level a dict keyed by one 'a'/'d' character per axis."""
    dec_lo, dec_hi, _, _ = wavelet_filters(wavelet)
    a = x
    details = []
    for _ in range(level):
        bands = _analysis_level(a, nd, dec_lo, dec_hi)
        a = bands.pop("a" * nd)
        details.append(bands)
    details.reverse()
    return a, details


def waverec_nd(
    a: torch.Tensor,
    details: list[dict[str, torch.Tensor]],
    wavelet: str,
    out_shape: tuple[int, ...],
) -> torch.Tensor:
    """Multilevel inverse of ``wavedec_nd`` cropped to ``out_shape`` (the
    last ``len(out_shape)`` axes)."""
    _, _, rec_lo, rec_hi = wavelet_filters(wavelet)
    nd = len(out_shape)
    for li, bands in enumerate(details):
        ref = bands["d" * nd].shape[-nd:]
        # waverecn end-trim: the approximation may run 1 longer per axis
        if a.shape[-nd:] != ref:
            for ax in range(nd):
                a = a.narrow(ax - nd, 0, ref[ax])
        target = (
            out_shape
            if li == len(details) - 1
            else details[li + 1]["d" * nd].shape[-nd:]
        )
        merged = dict(bands)
        merged["a" * nd] = a
        for ax in range(nd - 1, -1, -1):
            nxt, done = {}, set()
            for key in merged:
                stem = key[:ax]
                if stem in done:
                    continue
                done.add(stem)
                lo = merged[stem + "a" + key[ax + 1:]]
                hi = merged[stem + "d" + key[ax + 1:]]
                # reconstruct to the next level's extent along this axis
                want = min(2 * lo.shape[ax - nd] - len(rec_lo) + 2, target[ax])
                nxt[stem] = _idwt_axis(lo, hi, ax - nd, rec_lo, rec_hi, want)
            merged = nxt
        a = merged[""]
    return a


def _masked_median_abs(d: torch.Tensor, nd: int) -> torch.Tensor:
    """median(|d|) over each image's NONZERO entries (skimage
    ``_sigma_est_dwt``), [..., 1 x nd]: one sort with zeros pushed to +inf,
    then the count-indexed middle (np.median's even-count average); 0
    where all entries are 0."""
    v = d.abs().flatten(-nd)
    nz = v > 0
    cnt = nz.sum(-1, keepdim=True)
    s = torch.sort(torch.where(nz, v, torch.inf), dim=-1).values
    last = v.shape[-1] - 1
    hi = s.gather(-1, torch.clamp(cnt // 2, 0, last))
    lo = s.gather(-1, torch.clamp((cnt - 1) // 2, 0, last))
    med = torch.where(cnt > 0, 0.5 * (lo + hi), 0.0)
    return med.reshape(*d.shape[:-nd], *(1,) * nd)


def _mad_sigma(d: torch.Tensor, nd: int) -> torch.Tensor:
    """The MAD noise estimate of each image's detail subband d: the masked
    median / norm.ppf(0.75), divided by a 0-d tensor (CUDA torch multiplies
    by the reciprocal of a Python scalar)."""
    return _masked_median_abs(d, nd) / d.new_full((), _MAD_DENOM)


def estimate_sigma(img: torch.Tensor, wavelet: str = "db2") -> torch.Tensor:
    """Robust Gaussian noise-sigma estimate of each [H, W] slice
    (skimage.restoration.estimate_sigma): MAD of the finest-level diagonal
    detail coefficients / norm.ppf(0.75). Returns a device tensor of the
    leading shape ([B] for [B, H, W], 0-d for one slice)."""
    dec_lo, dec_hi, _, _ = wavelet_filters(wavelet)
    bands = _analysis_level(img.to(torch.float32), 2, dec_lo, dec_hi)
    return _mad_sigma(bands["dd"], 2).reshape(img.shape[:-2])


def _soft(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(x.abs() - t, 0.0)


def _hard(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > t, x, 0.0)


def _denoise_wavelet_core(
    img: torch.Tensor,
    sigma: float | None,
    wavelet: str,
    mode: str,
    wavelet_levels: int | None,
    method: str,
    nd: int,
) -> torch.Tensor:
    if method not in ("BayesShrink", "VisuShrink"):
        raise ValueError(
            f"method must be 'BayesShrink' or 'VisuShrink', got {method!r}"
        )
    if mode not in ("soft", "hard"):
        raise ValueError(f"mode must be 'soft' or 'hard', got {mode!r}")
    dec_lo, _, _, _ = wavelet_filters(wavelet)
    flen = len(dec_lo)
    x = img.to(torch.float32)
    shape = tuple(x.shape[-nd:])
    level = (
        int(wavelet_levels)
        if wavelet_levels is not None
        else default_levels(shape, flen)
    )
    if level < 1:
        raise ValueError("wavelet_levels must be >= 1")
    max_lv = min(dwt_max_level(int(n), flen) for n in shape)
    if level > max_lv:
        raise ValueError(
            f"wavelet_levels={level} exceeds the maximum decomposition "
            f"level {max_lv} for shape {shape} and {wavelet}"
        )
    a, details = wavedec_nd(x, wavelet, level, nd)
    if sigma is None:
        sig = _mad_sigma(details[-1]["d" * nd], nd)
    else:
        sig = x.new_full((), sigma)
    shrink = _soft if mode == "soft" else _hard
    if method == "VisuShrink":
        thresh = sig * float(np.float32(math.sqrt(2.0 * math.log(math.prod(shape)))))
        details = [
            {k: shrink(v, thresh) for k, v in lv.items()} for lv in details
        ]
    else:  # BayesShrink: per-subband threshold var / sqrt(dvar - var)
        var = sig * sig
        eps = float(np.finfo(np.float32).eps)
        dims = tuple(range(-nd, 0))

        def bayes(v: torch.Tensor) -> torch.Tensor:
            # the mean of squares accumulated in float64, then rounded to
            # float32: the card's reduction order and the CPU's then give
            # the same threshold (a float32 sum differs in its last bits,
            # and CLAHE after the denoise turns a level into two)
            dvar = torch.mean(v * v, dim=dims, keepdim=True,
                              dtype=torch.float64).to(torch.float32)
            return shrink(v, var / torch.sqrt(torch.clamp_min(dvar - var, eps)))

        details = [{k: bayes(v) for k, v in lv.items()} for lv in details]
    # the last crop is a view: contiguous, as the kernel stages that may
    # follow take their input
    return waverec_nd(a, details, wavelet, shape).contiguous()


def denoise_wavelet(
    img: torch.Tensor,
    sigma: float | None = None,
    wavelet: str = "db1",
    mode: str = "soft",
    wavelet_levels: int | None = None,
    method: str = "BayesShrink",
) -> torch.Tensor:
    """Wavelet shrinkage denoising of each [H, W] slice of ``img``,
    skimage.restoration.denoise_wavelet semantics (float image path: no
    sigma rescaling). ``sigma=None`` estimates each slice's noise on the
    device from its finest diagonal subband (the MAD estimator)."""
    return _denoise_wavelet_core(img, sigma, wavelet, mode, wavelet_levels,
                                 method, 2)


def cycle_spin(
    img: torch.Tensor,
    max_shifts: int = 3,
    shift_steps: int = 1,
    sigma: float | None = None,
    wavelet: str = "db1",
    mode: str = "soft",
    wavelet_levels: int | None = None,
    method: str = "BayesShrink",
) -> torch.Tensor:
    """Shift-invariant (cycle-spun) wavelet denoising of each [H, W] slice
    (skimage.restoration.cycle_spin with ``func=denoise_wavelet``):

        out = mean_s unroll_s( denoise_wavelet( roll_s(img) ) ),
        s in {0, shift_steps, ...} x {0, shift_steps, ...} <= max_shifts

    The reference's batched form (``cycle_spin_batched``): the shift grid
    is flattened into the leading batch, [S * B, H, W] shift-major, one
    denoise over it, each slice's statistics its own."""
    if max_shifts < 0:
        raise ValueError("max_shifts must be >= 0")
    if shift_steps < 1:
        raise ValueError("shift_steps must be >= 1")
    shifts = [
        (dy, dx)
        for dy in range(0, max_shifts + 1, shift_steps)
        for dx in range(0, max_shifts + 1, shift_steps)
    ]
    flat = img.reshape(-1, *img.shape[-2:])
    rolled = torch.cat([torch.roll(flat, s, dims=(-2, -1)) for s in shifts])
    den = _denoise_wavelet_core(
        rolled, sigma, wavelet, mode, wavelet_levels, method, 2
    ).reshape(len(shifts), *flat.shape)
    unrolled = torch.stack([
        torch.roll(den[i], (-dy, -dx), dims=(-2, -1))
        for i, (dy, dx) in enumerate(shifts)
    ])
    return unrolled.mean(dim=0).reshape(img.shape)


def denoise_wavelet3d(
    vol: torch.Tensor,
    sigma: float | None = None,
    wavelet: str = "db1",
    mode: str = "soft",
    wavelet_levels: int | None = None,
    method: str = "BayesShrink",
) -> torch.Tensor:
    """Volumetric wavelet shrinkage of a [Z, H, W] volume: the separable
    3-D DWT couples all three axes (8 subbands a level), the noise
    estimate is the volume's finest 'ddd' subband's and BayesShrink's
    thresholds are per 3-D subband."""
    check_volume(vol, "denoise_wavelet3d")
    return _denoise_wavelet_core(vol, sigma, wavelet, mode, wavelet_levels,
                                 method, 3)
