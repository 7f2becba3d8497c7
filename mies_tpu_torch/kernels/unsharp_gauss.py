"""Unsharp mask + uint8 quantize on the card: K4 (``csrc/unsharp.cu``).

The pipeline's tail peephole (``compiler._try_fuse_unsharp_quant``) runs a
trailing ``unsharp_mask(mode='nearest', clip=True)`` and the uint8
quantize as this one kernel: no blurred intermediate and no separate
quantize pass in device memory, and the output is stored as uint8.
Bit-exact against the plain unsharp + quantize (same ascending-tap order,
no FMA contraction; 'nearest' borders as clamped load indices).
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import filters as F

MAX_RADIUS = 16  # the kernel's shared-memory halo (csrc/unsharp.cu kMaxR)


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
