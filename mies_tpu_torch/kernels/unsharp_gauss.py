"""The unsharp-mask kernels on the card: K4 (``csrc/unsharp.cu``) and K7
(``csrc/unsharp_gauss.cu``).

K4: the pipeline's tail peephole (``compiler._try_fuse_unsharp_quant``) runs a
trailing ``unsharp_mask(mode='nearest', clip=True)`` and the uint8
quantize as this one kernel: no blurred intermediate and no separate
quantize pass in device memory, and the output is stored as uint8.
Bit-exact against the plain unsharp + quantize (same ascending-tap order,
no FMA contraction; 'nearest' borders as clamped load indices). It is K7's
first half: column strips walking down rows (``csrc/strip.cuh``), its window
and taps in registers at radii 1.5 and 1.0 (r 6 and 4), in shared memory at
every other radius.

K7: the pairwise peephole (``compiler._try_fuse_unsharp_gauss``) runs an
``unsharp_mask('nearest', clip=True)`` followed by a ``gaussian_blur
('nearest')`` as one kernel, BASELINE w3: one read and one write of the
image, bit-exact against the unfused pair (scipy's per-pass borders are
reproduced by index: see the source's note).
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import filters as F

MAX_RADIUS = 16  # the kernel's shared-memory halo (csrc/unsharp.cu kMaxR)
# K7 (csrc/unsharp_gauss.cu): the widest radius its taps hold, the radius
# pair whose windows and taps sit in registers (kStaticR: r1 = r2 = 6), the
# strips a block walks down (kStripW output columns at that pair,
# kStripWRuntime at runtime radii), and the shared memory a block may use on
# sm_90
UG_MAX_RADIUS = 64
UG_STATIC_R = 6
UG_STRIP_W = 128
UG_STRIP_W_RUNTIME = 32
UG_SMEM_MAX = 232448
# The widest r1 that K7 takes beside each r2 (index r2; none beyond r2 53):
# the radius pairs whose 32 x 32 output tiles, staged in shared memory with
# x's halo of r1 + r2 and U's of r2, fit a block's. The strip kernel needs
# less for every one of them (tests/test_torch_unsharp_gauss.py); the limit
# is kept so that no radius pair it took then loses the kernel.
UG_MAX_R1 = (64,) * 19 + (63, 62, 60, 58, 57, 55, 53, 51, 49, 48, 46, 44, 42,
                          40, 39, 37, 35, 33, 31, 29, 28, 26, 24, 22, 20, 18,
                          16, 14, 12, 10, 8, 6, 5, 3, 1)


def _tap_radius(radius: float, truncate: float) -> int:
    return int(truncate * float(radius) + 0.5)


def unsharp_quant_supported(radius: float, truncate: float = 4.0) -> bool:
    """Whether K4's halo holds this Gaussian (decided from the config)."""
    return radius > 0 and 1 <= _tap_radius(radius, truncate) <= MAX_RADIUS


def unsharp_quant_plain(
    batch: torch.Tensor,
    radius: float = 1.0,
    amount: float = 1.0,
    truncate: float = 4.0,
    quantize: bool = True,
) -> torch.Tensor:
    """Plain version of K4: unsharp_mask('nearest', clip) [+ quantize]."""
    from mies_tpu_torch.pipeline.compiler import _quantize_u8

    blurred = F.gaussian_blur(batch, sigma=radius, truncate=truncate,
                              mode="nearest")
    out = torch.clamp(batch + amount * (batch - blurred), 0.0, 1.0)
    return _quantize_u8(out) if quantize else out


def unsharp_quant_cuda(
    batch: torch.Tensor,
    radius: float = 1.0,
    amount: float = 1.0,
    truncate: float = 4.0,
    quantize: bool = True,
) -> torch.Tensor:
    """K4: clip(x + amount * (x - G*x), 0, 1) of [B, H, W] float32, then
    (quantize=True) clip(rint(u * 255), 0, 255) as uint8."""
    if _build.exporting():
        return torch.ops.mies.unsharp_quant(batch, float(radius),
                                            float(amount), float(truncate),
                                            bool(quantize))
    _build.check_tensor(batch, "unsharp_quant: batch")
    if not unsharp_quant_supported(radius, truncate):
        raise ValueError(
            f"unsharp radius {radius} (truncate {truncate}) needs "
            f"{_tap_radius(radius, truncate)} halo pixels; the kernel holds "
            f"1..{MAX_RADIUS}"
        )
    if batch.device.type == "cpu":
        return unsharp_quant_plain(batch, radius, amount, truncate, quantize)
    B, h, w = batch.shape
    r = _tap_radius(radius, truncate)
    taps = F.gaussian_kernel1d(float(radius), r)
    out = torch.empty(batch.shape, device=batch.device,
                      dtype=torch.uint8 if quantize else torch.float32)
    _build.launch("unsharp_quant", "mies_unsharp", batch.device,
                  batch.data_ptr(), out.data_ptr(), B, h, w,
                  taps.ctypes.data, len(taps), float(amount), int(quantize))
    return out


# --- K7: unsharp -> gaussian --------------------------------------------------


def unsharp_gauss_smem(r1: int, r2: int) -> int:
    """Shared memory bytes of a K7 block (csrc/unsharp_gauss.cu
    smem_bytes): G1's vertical pass and x at two rows over the strip and its
    halo of r1 + r2, double-buffered, and V at two rows over a halo of r2;
    away from UG_STATIC_R also the taps and the two windows' rings."""
    runtime = not r1 == r2 == UG_STATIC_R
    sw = UG_STRIP_W_RUNTIME if runtime else UG_STRIP_W
    ng, nu = sw + 2 * (r1 + r2), sw + 2 * r2
    floats = 8 * ng + 2 * nu
    if runtime:
        n1, n2 = 2 * r1 + 1, 2 * r2 + 1
        floats += n1 + n2 + n1 * ng + n2 * nu
    return 4 * floats


def _accepted(r1: int, r2: int) -> bool:
    """Whether K7 takes the radius pair (r1, r2): UG_MAX_R1."""
    return 0 <= r2 < len(UG_MAX_R1) and 0 <= r1 <= UG_MAX_R1[r2]


def unsharp_gauss_supported(radius: float, sigma: float,
                            truncate: float = 4.0) -> bool:
    """Whether K7 takes these two Gaussians (decided from the config)."""
    if radius <= 0 or sigma <= 0:
        return False
    return _accepted(_tap_radius(radius, truncate),
                     _tap_radius(sigma, truncate))


def unsharp_gauss_plain(
    batch: torch.Tensor,
    radius: float = 1.5,
    amount: float = 1.0,
    sigma: float = 1.5,
    truncate: float = 4.0,
) -> torch.Tensor:
    """Plain version of K7: gaussian_blur(unsharp_mask(x)), both 'nearest',
    the unsharp clipped."""
    u = unsharp_quant_plain(batch, radius, amount, truncate, quantize=False)
    return F.gaussian_blur(u, sigma=sigma, truncate=truncate, mode="nearest")


def unsharp_gauss_cuda(
    batch: torch.Tensor,
    radius: float = 1.5,
    amount: float = 1.0,
    sigma: float = 1.5,
    truncate: float = 4.0,
) -> torch.Tensor:
    """K7: G2 * clip(x + amount * (x - G1 * x), 0, 1) of [B, H, W]
    float32, G1 of sigma ``radius`` and G2 of sigma ``sigma``, each pass
    with scipy's 'nearest' border."""
    if _build.exporting():
        return torch.ops.mies.unsharp_gauss(batch, float(radius),
                                            float(amount), float(sigma),
                                            float(truncate))
    _build.check_tensor(batch, "unsharp_gauss: batch")
    if not unsharp_gauss_supported(radius, sigma, truncate):
        raise ValueError(
            f"unsharp radius {radius} -> gaussian sigma {sigma} (truncate "
            f"{truncate}): K7 takes radii 0..{UG_MAX_RADIUS} whose staged "
            f"tiles fit {UG_SMEM_MAX} bytes of shared memory"
        )
    if batch.device.type == "cpu":
        return unsharp_gauss_plain(batch, radius, amount, sigma, truncate)
    B, h, w = batch.shape
    k1 = F.gaussian_kernel1d(float(radius), _tap_radius(radius, truncate))
    k2 = F.gaussian_kernel1d(float(sigma), _tap_radius(sigma, truncate))
    out = torch.empty_like(batch)
    _build.launch("unsharp_gauss", "mies_unsharp_gauss", batch.device,
                  batch.data_ptr(), out.data_ptr(), B, h, w,
                  k1.ctypes.data, len(k1), k2.ctypes.data, len(k2),
                  float(amount))
    return out


def _unsharp_quant_fake(batch, radius, amount, truncate, quantize):
    return batch.new_empty(batch.shape,
                           dtype=torch.uint8 if quantize else torch.float32)


def unsharp_ops(radius: float, truncate: float = 4.0) -> int:
    """K4's operations per pixel: two passes of 2r + 1 taps (a multiply
    and an add each), the unsharp blend and the quantize (8): 60 at
    radius 1.5."""
    return 4 * (2 * _tap_radius(radius, truncate) + 1) + 8


def _unsharp_gauss_ops(batch, radius, amount, sigma, truncate) -> int:
    """K7's: four passes of 2r + 1 taps (2r + 1 multiplies, 2r adds) and
    the blend (5) per pixel."""
    n1, n2 = (2 * _tap_radius(s, truncate) + 1 for s in (radius, sigma))
    return (2 * (2 * n1 - 1) + 2 * (2 * n2 - 1) + 5) * batch.numel()


_build.register_op(
    "unsharp_quant", unsharp_quant_cuda,
    "(Tensor batch, float radius, float amount, float truncate, "
    "bool quantize) -> Tensor", _unsharp_quant_fake,
    lambda batch, radius, amount, truncate, _: unsharp_ops(radius, truncate)
    * batch.numel())
_build.register_op(
    "unsharp_gauss", unsharp_gauss_cuda,
    "(Tensor batch, float radius, float amount, float sigma, "
    "float truncate) -> Tensor", lambda batch, *_: torch.empty_like(batch),
    _unsharp_gauss_ops)
