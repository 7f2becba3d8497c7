"""Bilateral filter on the card: K3 (``csrc/bilateral.cu``).

``bilateral_cuda`` launches the kernel for a CUDA tensor and runs the
plain ``ops.filters.bilateral_blur`` for a CPU tensor. The kernel computes
each unordered pair's weight once (the weight is symmetric) and sums every
pixel's window row-major like the plain version, but multiplies by the f32
1/(2 sigma_color^2) as the TPU kernel did, so the two agree within f32
ULPs (atol 2e-6, the reference's own kernel contract), not bit for bit.
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import filters as F

MAX_KERNEL_SIZE = 9
# scipy mode -> the kernel's border code (numpy symmetric / reflect / edge)
_MODE_CODE = {"reflect": 0, "mirror": 1, "nearest": 2, "edge": 2}


def bilateral_cuda(
    batch: torch.Tensor,
    kernel_size: int = 5,
    sigma_color: float = 0.1,
    sigma_space: float = 1.5,
    mode: str = "reflect",
) -> torch.Tensor:
    """K3: k x k bilateral of [B, H, W] float32 (k odd, <= 9; border
    'reflect', 'mirror' or 'nearest'/'edge')."""
    if _build.exporting():
        return torch.ops.mies.bilateral(batch, int(kernel_size),
                                        float(sigma_color),
                                        float(sigma_space), mode)
    _build.check_tensor(batch, "bilateral: batch")
    k = int(kernel_size)
    if k % 2 != 1 or not 1 <= k <= MAX_KERNEL_SIZE:
        raise ValueError(f"kernel_size must be odd and <= {MAX_KERNEL_SIZE}, "
                         f"got {kernel_size}")
    if mode not in _MODE_CODE:
        raise ValueError(f"bilateral mode {mode!r} has no kernel border; "
                         f"expected one of {sorted(_MODE_CODE)}")
    if batch.device.type == "cpu":
        return F.bilateral_blur(batch, k, sigma_color, sigma_space, mode)
    B, h, w = batch.shape
    out = torch.empty_like(batch)
    spatial = F.spatial_weights(k, sigma_space)
    _build.launch("bilateral", "mies_bilateral", batch.device,
                  batch.data_ptr(), out.data_ptr(), B, h, w, k,
                  spatial.ctypes.data, 1.0 / (2.0 * float(sigma_color) ** 2),
                  _MODE_CODE[mode])
    return out


def bilateral_ops(k: int) -> int:
    """Operations per pixel of a k x k bilateral filter in its symmetric
    form: one weight per unordered pair (diff, square, scale, exp, times the
    spatial weight), three per tap (weight times value, two sums) and the
    final divide: 136 at k 5."""
    return (k * k - 1) // 2 * 5 + k * k * 3 + 1


_build.register_op(
    "bilateral", bilateral_cuda,
    "(Tensor batch, int kernel_size, float sigma_color, float sigma_space, "
    "str mode) -> Tensor", lambda batch, *_: torch.empty_like(batch),
    lambda batch, k, *_: bilateral_ops(k) * batch.numel())

# the pipeline's batched bilateral: the wrapper already dispatches by device
bilateral_batched = bilateral_cuda


def denoise_bilateral_batched(
    batch: torch.Tensor,
    sigma_color: float = 0.1,
    sigma_spatial: float = 1.0,
    mode: str = "edge",
) -> torch.Tensor:
    """The pipeline's batched denoise_bilateral: K3 where the derived
    window is at most MAX_KERNEL_SIZE and the border one of K3's, the plain
    ``ops.filters.bilateral_blur`` otherwise (wider windows; 'constant',
    'wrap'). The route follows from the parameters alone, before any
    launch."""
    k = F.denoise_bilateral_window(sigma_spatial)
    if denoise_bilateral_on_k3(sigma_spatial, mode):
        return bilateral_cuda(batch, k, sigma_color, sigma_spatial, mode)
    return F.bilateral_blur(batch, k, sigma_color, sigma_spatial, mode)


def denoise_bilateral_on_k3(sigma_spatial: float, mode: str) -> bool:
    """Whether denoise_bilateral at these parameters runs on K3."""
    return (F.denoise_bilateral_window(sigma_spatial) <= MAX_KERNEL_SIZE
            and mode in _MODE_CODE)
