"""Non-local means on the card: K11 (``csrc/nlmeans.cu``).

``nl_means_cuda`` launches the kernel once per call for a CUDA tensor (the
whole half shift table in one launch; per pair, one box field in shared
memory that both ends of the pair read) and runs the plain
``ops.restoration.denoise_nl_means`` for a CPU tensor. Any image shape
runs whose numpy-'reflect' extension fits (s // 2 + d < every dim, the
op's own error); the kernel's one real limit is shared memory for the
tile's halo and the pair's fields, and a call past it raises with the
reason.
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import restoration as R

TILE = (32, 32)  # the kernel's output tile, rows x columns (csrc/nlmeans.cu)
MAX_SHARED_BYTES = 232448  # dynamic shared memory one Hopper block may use


def shared_bytes(s: int, d: int) -> int:
    """Shared memory of one block (csrc/nlmeans.cu nlm_smem_floats): the
    tile with its halo s // 2 + d and 8 rows of padding, and at their
    largest (|t| = d) a pair's column sums, 8 rows more, and weights, 8
    columns more, at odd pitches."""
    th, tw = TILE
    r = s // 2 + d
    return 4 * ((th + 2 * r + 8) * (tw + 2 * r)
                + (th + d + 8) * ((tw + d + s - 1) | 1)
                + (th + d) * ((tw + d + 8) | 1))


def check_shared(s: int, d: int) -> None:
    """Raise if the kernel's block cannot hold its tile, halo and fields."""
    need = shared_bytes(s, d)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"NL-means s={s}, d={d}: the halo s//2 + d = {s // 2 + d} and "
            f"a pair's fields need {need} bytes of shared memory per "
            f"block, more than the {MAX_SHARED_BYTES} a block may use"
        )


def nl_means_cuda(
    batch: torch.Tensor,
    patch_size: int = 7,
    patch_distance: int = 11,
    h: float = 0.1,
    sigma: float = 0.0,
) -> torch.Tensor:
    """K11: NL-means of [B, H, W] float32 (defaults = the op's)."""
    if _build.exporting():
        return torch.ops.mies.nl_means(batch, int(patch_size),
                                       int(patch_distance), float(h),
                                       float(sigma))
    _build.check_tensor(batch, "denoise_nl_means: batch")
    if int(patch_distance) < 0 or int(patch_size) < 1:
        raise ValueError(f"patch_size must be >= 1 and patch_distance >= 0, "
                         f"got {patch_size}, {patch_distance}")
    s, d, bias, inv_h2sn = R.nl_means_params(
        tuple(batch.shape[-2:]), patch_size, patch_distance, h, sigma)
    if batch.device.type == "cpu":
        return R.denoise_nl_means(batch, patch_size, patch_distance, h, sigma)
    check_shared(s, d)
    B, hh, ww = batch.shape
    out = torch.empty_like(batch)
    _build.launch("nl_means", "mies_nl_means", batch.device,
                  batch.data_ptr(), out.data_ptr(), B, hh, ww, s, d, bias,
                  inv_h2sn)
    return out


def nl_means_ops(hw, patch_size: int, patch_distance: int, h: float,
                 sigma: float) -> int:
    """Operations per pixel: per pair of the half shift table, the
    difference and square, the s-wide box along rows and columns, the
    weight (bias, max, scale, cutoff, exp, select) and the two ends'
    accumulations (2 multiplies, 4 adds)."""
    s, d, _, _ = R.nl_means_params(tuple(hw), patch_size, patch_distance, h,
                                   sigma)
    return len(R.half_shift_table(d)) * (14 + 2 * (s - 1))


_build.register_op(
    "nl_means", nl_means_cuda,
    "(Tensor batch, int patch_size, int patch_distance, float h, "
    "float sigma) -> Tensor", lambda batch, *_: torch.empty_like(batch),
    lambda batch, *args: nl_means_ops(batch.shape[-2:], *args)
    * batch.numel())

# the pipeline's batched NL-means: the wrapper already dispatches by device
nl_means_batched = nl_means_cuda
