"""Frequency-domain filters, plain PyTorch: Butterworth low/high-pass and
homomorphic enhancement.

Same semantics and f32 operation order as ``mies_tpu.ops.frequency``:
``butterworth`` transcribes skimage.filters.butterworth 0.26 (per-axis
``arange(-(d-1)//2, (d-1)//2+1) / (d*cutoff)`` squared and ifftshifted,
the real-FFT half spectrum on the last axis, ``1/(1 + q^(2*order))`` with
the optional sqrt, an 'edge' pad of ``npad``); ``homomorphic`` is the
log-domain illumination/reflectance split (Gonzalez & Woods section 4.9):
gains from ``low_gain`` at DC to ``high_gain`` at high frequency by the
same Butterworth high-pass transfer, applied to log(img + eps), then
exponentiated back and clipped.

The transfer is built on the host in float64, cast to float32 and cached,
and its device copy is cached per (shape, parameters, device), so a call
is pad -> rfftn -> one multiply by a real tensor -> irfftn -> crop, with
no host copy. ``torch.fft`` runs cuFFT on the card (no TF32: cuFFT has no
such mode). The reference's ops take one image; here the spatial rank
``nd`` is explicit and every leading dimension is a batch dimension: the
pad and the transform touch the last ``nd`` axes only, and the transfer is
built from the padded image's shape, one image's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mies_tpu_torch.ops.filters import _pad_axis, check_volume


@functools.lru_cache(maxsize=64)
def butterworth_transfer(
    shape: tuple,
    cutoff_frequency_ratio: float,
    order: float,
    high_pass: bool,
    squared_butterworth: bool = True,
) -> np.ndarray:
    """The n-D Butterworth transfer on the rfftn grid of ``shape``
    (host-side, float64 -> float32; skimage _get_nd_butterworth_filter
    transcription). Returned shape is ``shape`` with the last axis halved
    to ``d//2 + 1`` (the real-FFT half spectrum)."""
    ranges = []
    for d in shape:
        axis = (
            np.arange(-(d - 1) // 2, (d - 1) // 2 + 1, dtype=np.float64)
            / (d * cutoff_frequency_ratio)
        )
        ranges.append(np.fft.ifftshift(axis**2))
    # real FFT: the last axis keeps only frequencies 0..d/2
    ranges[-1] = ranges[-1][: shape[-1] // 2 + 1]
    q2 = functools.reduce(
        np.add, np.meshgrid(*ranges, indexing="ij", sparse=True)
    )
    q2 = np.power(q2, order)
    wfilt = 1.0 / (1.0 + q2)
    if high_pass:
        wfilt = wfilt * q2
    if not squared_butterworth:
        np.sqrt(wfilt, out=wfilt)
    return wfilt.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_transfer(
    shape: tuple,
    cutoff_frequency_ratio: float,
    order: float,
    high_pass: bool,
    squared_butterworth: bool,
    gains: tuple | None,
    device: torch.device,
) -> torch.Tensor:
    """The transfer on ``device``; with ``gains`` = (low, high) the
    homomorphic one, ``low + (high - low) * high_pass_transfer`` in
    float32 on the host, as the reference builds it."""
    w = butterworth_transfer(shape, cutoff_frequency_ratio, order, high_pass,
                             squared_butterworth)
    if gains is not None:
        low, high = gains
        w = np.float32(low) + np.float32(high - low) * w
    return torch.as_tensor(w, device=device)


def _validate_cutoff(cutoff_frequency_ratio: float) -> None:
    if not 0.0 < float(cutoff_frequency_ratio) <= 0.5:
        raise ValueError(
            "cutoff_frequency_ratio must be in (0, 0.5] (a fraction of "
            f"the sampling rate), got {cutoff_frequency_ratio}"
        )


def _pad_edge(x: torch.Tensor, npad: int, nd: int) -> torch.Tensor:
    for axis in range(-nd, 0):
        x = _pad_axis(x, npad, axis, "edge")
    return x


def _crop(x: torch.Tensor, npad: int, nd: int) -> torch.Tensor:
    for axis in range(-nd, 0):
        x = x.narrow(axis, npad, x.shape[axis] - 2 * npad)
    return x


def _apply_transfer(x: torch.Tensor, wfilt: torch.Tensor, nd: int) -> torch.Tensor:
    """rfftn -> multiply by the real transfer -> irfftn over the last
    ``nd`` axes, same shape."""
    dims = tuple(range(-nd, 0))
    spec = torch.fft.rfftn(x, dim=dims)
    return torch.fft.irfftn(spec * wfilt, s=x.shape[-nd:], dim=dims)


def _butterworth_nd(
    x: torch.Tensor,
    cutoff_frequency_ratio: float,
    high_pass: bool,
    order: float,
    squared_butterworth: bool,
    npad: int,
    nd: int,
) -> torch.Tensor:
    _validate_cutoff(cutoff_frequency_ratio)
    if npad < 0:
        raise ValueError("npad must be >= 0")
    x = _pad_edge(x.to(torch.float32), npad, nd)
    wfilt = _device_transfer(
        tuple(x.shape[-nd:]), float(cutoff_frequency_ratio), float(order),
        bool(high_pass), bool(squared_butterworth), None, x.device)
    # contiguous, as the kernel stages that may follow take their input
    return _crop(_apply_transfer(x, wfilt, nd), npad, nd).contiguous()


def butterworth(
    img: torch.Tensor,
    cutoff_frequency_ratio: float = 0.005,
    high_pass: bool = True,
    order: float = 2.0,
    squared_butterworth: bool = True,
    npad: int = 0,
) -> torch.Tensor:
    """skimage.filters.butterworth on each [H, W] slice of ``img``
    ([..., H, W]). ``high_pass=True`` returns the detail band (it can be
    negative: the chain's uint8 quantize clamps); ``high_pass=False`` the
    smoothed image; ``npad`` edge-pads before the FFT."""
    return _butterworth_nd(img, cutoff_frequency_ratio, high_pass, order,
                           squared_butterworth, int(npad), 2)


def _homomorphic_nd(
    x: torch.Tensor,
    cutoff_frequency_ratio: float,
    order: float,
    low_gain: float,
    high_gain: float,
    eps: float,
    npad: int,
    nd: int,
) -> torch.Tensor:
    _validate_cutoff(cutoff_frequency_ratio)
    if npad < 0:
        raise ValueError("npad must be >= 0")
    if eps <= 0:
        raise ValueError("eps must be > 0 (log-domain offset)")
    e32 = float(np.float32(eps))
    logx = _pad_edge(torch.log(x.to(torch.float32) + e32), npad, nd)
    wfilt = _device_transfer(
        tuple(logx.shape[-nd:]), float(cutoff_frequency_ratio), float(order),
        True, True, (float(low_gain), float(high_gain)), logx.device)
    out = _crop(_apply_transfer(logx, wfilt, nd), npad, nd)
    return torch.clamp(torch.exp(out) - e32, 0.0, 1.0)


def homomorphic(
    img: torch.Tensor,
    cutoff_frequency_ratio: float = 0.02,
    order: float = 2.0,
    low_gain: float = 0.5,
    high_gain: float = 1.5,
    eps: float = 1.0 / 255.0,
    npad: int = 16,
) -> torch.Tensor:
    """Homomorphic enhancement of each [H, W] slice of ``img``: log ->
    gain-interpolated Butterworth emphasis -> exp, clipped to [0, 1].
    ``low_gain < 1`` compresses the slow illumination field, ``high_gain >
    1`` boosts tissue detail; the ``npad`` edge pad suppresses the FFT's
    wrap-around seam."""
    return _homomorphic_nd(img, cutoff_frequency_ratio, order, low_gain,
                           high_gain, eps, int(npad), 2)


def butterworth3d(
    vol: torch.Tensor,
    cutoff_frequency_ratio: float = 0.005,
    high_pass: bool = True,
    order: float = 2.0,
    squared_butterworth: bool = True,
    npad: int = 0,
) -> torch.Tensor:
    """``butterworth`` on a [Z, H, W] volume: one 3-D frequency grid, so
    the filter is z-consistent (no slice flicker)."""
    check_volume(vol, "butterworth3d")
    return _butterworth_nd(vol, cutoff_frequency_ratio, high_pass, order,
                           squared_butterworth, int(npad), 3)


def homomorphic3d(
    vol: torch.Tensor,
    cutoff_frequency_ratio: float = 0.02,
    order: float = 2.0,
    low_gain: float = 0.5,
    high_gain: float = 1.5,
    eps: float = 1.0 / 255.0,
    npad: int = 8,
) -> torch.Tensor:
    """Homomorphic enhancement of a [Z, H, W] volume: one 3-D log-domain
    Butterworth emphasis, so slow intensity drifts across slices flatten
    with the in-plane ones."""
    check_volume(vol, "homomorphic3d")
    return _homomorphic_nd(vol, cutoff_frequency_ratio, order, low_gain,
                           high_gain, eps, int(npad), 3)
