"""TV-Chambolle denoising on the card: K12 (``csrc/tv.cu``).

``denoise_tv_cuda`` runs ``max_num_iter`` steps for a CUDA tensor, each
one launch of ``mies_tv_step`` (the update kernel and the per-slice
energy kernel), and the plain ``ops.restoration.tv_chambolle`` for a CPU
tensor. Each slice stops on its own on the card, as in the plain version
and the reference under ``vmap``; a stopped slice's later steps return at
once, so the launch count is set by the config, not the data, and no step
waits on the host. ``return_iters=True`` also returns the iterations each
slice ran.
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import restoration as R

TILE = (8, 32)  # the update kernel's block, rows x columns


def denoise_tv_cuda(
    batch: torch.Tensor,
    weight: float = 0.1,
    eps: float = 2e-4,
    max_num_iter: int = 200,
    return_iters: bool = False,
):
    """K12: TV-Chambolle of [B, H, W] float32 (defaults = the op's)."""
    if max_num_iter < 1:
        raise ValueError("max_num_iter must be >= 1")
    _build.check_tensor(batch, "denoise_tv: batch")
    if batch.device.type == "cpu":
        out, iters = R.tv_chambolle(batch, weight, eps, max_num_iter)
        return (out, iters) if return_iters else out
    B, h, w = batch.shape
    w32, eps32, tau_w, size = R.tv_constants((h, w), weight, eps)
    nblocks = -(-h // TILE[0]) * -(-w // TILE[1])
    p = [torch.zeros((2, B, h, w), dtype=torch.float32, device=batch.device)
         for _ in range(2)]
    out = torch.empty_like(batch)
    partial = torch.empty((B, nblocks, 2), dtype=torch.float64,
                          device=batch.device)
    iters = torch.zeros(B, dtype=torch.int32, device=batch.device)
    stop = torch.zeros(B, dtype=torch.int32, device=batch.device)
    e_prev = torch.zeros(B, dtype=torch.float32, device=batch.device)
    e_init = torch.zeros(B, dtype=torch.float32, device=batch.device)
    for k in range(int(max_num_iter)):
        _build.launch("tv", "mies_tv_step", batch.device, batch.data_ptr(),
                      p[k % 2].data_ptr(), p[(k + 1) % 2].data_ptr(),
                      out.data_ptr(), partial.data_ptr(), iters.data_ptr(),
                      e_prev.data_ptr(), e_init.data_ptr(), stop.data_ptr(),
                      B, h, w, w32, eps32, tau_w, size)
    return (out, iters) if return_iters else out


# the pipeline's batched TV: the wrapper already dispatches by device
denoise_tv_batched = denoise_tv_cuda
