"""The fused tail on the card: K13 (``csrc/fused.cu``), bilateral ->
unsharp mask ('nearest', clipped) -> optional uint8 quantize in one kernel.

The pipeline takes it for a trailing ``bilateral_blur -> unsharp_mask``
pair only under ``MIES_TPU_FUSE_TAIL=1`` on the card
(``compiler._try_fuse_tail``), as the reference does on the TPU; by default
the tail runs as K3 -> K4. K13 is bit-equal to K3 -> K4 on the card (the
same arithmetic, the unsharp's border replicating the bilateral OUTPUT's
edge); against its plain version it agrees as K3 does with the plain
bilateral (f32 within 2e-6, uint8 within one level on rounding ties).
The kernel runs K3's pair-weight strip walk (``csrc/bilateral.cuh``)
feeding K4's column windows (``csrc/strip.cuh``) in one block: a strip of
``STRIP_W`` output columns at the register radii, ``WIDE_W - 2 rg`` at any
other, walking 128 rows. Its only limits are the kernel's: k <= 9,
and a Gaussian radius whose strip keeps an output column and whose rings
fit a block's shared memory (every radius 1..63 at every k).
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels.bilateral import (
    MAX_KERNEL_SIZE,
    _MODE_CODE,
    bilateral_ops,
)
from mies_tpu_torch.kernels.unsharp_gauss import _tap_radius, unsharp_ops
from mies_tpu_torch.ops import filters as F

MAX_RADIUS = 63  # the widest Gaussian radius (csrc/fused.cu kMaxRg)
REGISTER_RADII = (6, 4)  # radii whose windows sit in registers
STRIP_W = 256  # output columns of a strip at those radii (kStripW)
WIDE_W = 128  # bilateral columns of a strip at the other radii (kWideW)
SMEM_MAX = 232448  # the shared memory a block may use on sm_90
TRUNCATE = 4.0  # unsharp_mask's Gaussian is truncated at 4 sigma


def strip_columns(rg: int) -> int:
    """Output columns of a K13 strip at Gaussian radius rg: the bilateral
    strip less its rg halo on each side."""
    return STRIP_W if rg in REGISTER_RADII else WIDE_W - 2 * rg


def smem_bytes(kernel_size: int, rg: int) -> int:
    """Shared memory bytes of a K13 block (csrc/fused.cu smem_floats): K3's
    rings of input rows and pair weights over the bilateral strip, its
    staged bilateral row and vertical sums, and at a radius outside
    REGISTER_RADII the taps and a ring of 2 rg + 1 bilateral rows."""
    r = kernel_size // 2
    bw = strip_columns(rg) + 2 * rg
    rings = (r + 1) * (bw + 4 * r + r * (kernel_size + 1) * (bw + 2 * r))
    window = 0 if rg in REGISTER_RADII else (2 * rg + 1) * (1 + bw)
    return 4 * (rings + 2 * bw + window)


def bilateral_unsharp_supported(kernel_size: int, radius: float,
                                bilateral_mode: str = "reflect") -> bool:
    """Whether K13 takes this tail: an odd k <= 9 with a border K3 has, a
    Gaussian radius within its taps whose strip keeps an output column, and
    the rings within a block's shared memory (decided from the config; any
    image shape runs)."""
    k = int(kernel_size)
    if k % 2 != 1 or not 1 <= k <= MAX_KERNEL_SIZE:
        return False
    if bilateral_mode not in _MODE_CODE or radius <= 0:
        return False
    rg = _tap_radius(radius, TRUNCATE)
    return (1 <= rg <= MAX_RADIUS and strip_columns(rg) >= 1
            and smem_bytes(k, rg) <= SMEM_MAX)


def bilateral_unsharp_plain(
    batch: torch.Tensor,
    kernel_size: int = 5,
    sigma_color: float = 0.1,
    sigma_space: float = 1.5,
    bilateral_mode: str = "reflect",
    radius: float = 1.5,
    amount: float = 1.0,
    quantize: bool = True,
) -> torch.Tensor:
    """Plain version of K13: the plain bilateral_blur, then
    unsharp_mask(mode='nearest'), then the uint8 quantize."""
    from mies_tpu_torch.pipeline.compiler import _quantize_u8

    b = F.bilateral_blur(batch, kernel_size, sigma_color, sigma_space,
                         bilateral_mode)
    out = F.unsharp_mask(b, radius, amount, mode="nearest", clip=True)
    return _quantize_u8(out) if quantize else out


def bilateral_unsharp_cuda(
    batch: torch.Tensor,
    kernel_size: int = 5,
    sigma_color: float = 0.1,
    sigma_space: float = 1.5,
    bilateral_mode: str = "reflect",
    radius: float = 1.5,
    amount: float = 1.0,
    quantize: bool = True,
) -> torch.Tensor:
    """K13: unsharp_mask(bilateral_blur(x), 'nearest', clipped) of
    [B, H, W] float32, then (quantize=True) clip(rint(u * 255), 0, 255)
    as uint8."""
    if _build.exporting():
        return torch.ops.mies.bilateral_unsharp(
            batch, int(kernel_size), float(sigma_color), float(sigma_space),
            bilateral_mode, float(radius), float(amount), bool(quantize))
    _build.check_tensor(batch, "bilateral_unsharp: batch")
    if not bilateral_unsharp_supported(kernel_size, radius, bilateral_mode):
        raise ValueError(
            f"bilateral k={kernel_size} mode {bilateral_mode!r} -> unsharp "
            f"radius {radius}: K13 takes odd k <= {MAX_KERNEL_SIZE}, a "
            f"border in {sorted(_MODE_CODE)} and Gaussian radii "
            f"1..{MAX_RADIUS} whose rings fit {SMEM_MAX} bytes of shared "
            f"memory"
        )
    if batch.device.type == "cpu":
        return bilateral_unsharp_plain(batch, kernel_size, sigma_color,
                                       sigma_space, bilateral_mode, radius,
                                       amount, quantize)
    B, h, w = batch.shape
    k = int(kernel_size)
    spatial = F.spatial_weights(k, sigma_space)
    taps = F.gaussian_kernel1d(float(radius), _tap_radius(radius, TRUNCATE))
    out = torch.empty(batch.shape, device=batch.device,
                      dtype=torch.uint8 if quantize else torch.float32)
    _build.launch("bilateral_unsharp", "mies_bilateral_unsharp", batch.device,
                  batch.data_ptr(), out.data_ptr(), B, h, w, k,
                  spatial.ctypes.data, 1.0 / (2.0 * float(sigma_color) ** 2),
                  _MODE_CODE[bilateral_mode], taps.ctypes.data, len(taps),
                  float(amount), int(quantize))
    return out


def _bilateral_unsharp_fake(batch, *args):
    return batch.new_empty(batch.shape,
                           dtype=torch.uint8 if args[-1] else torch.float32)


_build.register_op(
    "bilateral_unsharp", bilateral_unsharp_cuda,
    "(Tensor batch, int kernel_size, float sigma_color, float sigma_space, "
    "str bilateral_mode, float radius, float amount, bool quantize) -> "
    "Tensor", _bilateral_unsharp_fake,
    lambda batch, k, sc, ss, mode, radius, *_: (
        bilateral_ops(k) + unsharp_ops(radius, TRUNCATE)) * batch.numel())
