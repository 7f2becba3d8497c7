"""TV-Chambolle denoising on the card: K12 (``csrc/tv.cu``).

``denoise_tv_cuda`` runs ``max_num_iter`` steps for a CUDA tensor in
chunks of ``STEPS``, three launches per chunk (``mies_tv_chunk``: the
chunk's steps per 64 x 64 tile with its halo in shared memory; ``mies_tv_
energy``: each slice's loop test over the chunk's steps; ``mies_tv_chunk``
in rollback mode: the out of the step that stopped a slice), and the plain
``ops.restoration.tv_chambolle`` for a CPU tensor. Each slice stops on its
own on the card, as in the plain version and the reference under
``vmap``; a stopped slice's later launches return at once, so the launch
count, 3 ceil(max_num_iter / STEPS), is set by the config, not the data,
and no launch waits on the host. ``return_iters=True`` also returns the
iterations each slice ran.
"""

from __future__ import annotations

import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import restoration as R

TILE = 64  # a chunk block's interior tile, TILE x TILE
# steps per chunk launch, csrc/tv.cu kSteps: 4 ran faster than 8 on an
# H100 (PERF.md; a halo of 4 is 1.27x the tile's work, 8 is 1.56x)
STEPS = 4
# the halo a chunk block loads around its tile: an update reaches one
# pixel further each step, and the last step's divergence and gradient one
# more, which the halo's outer ring supplies (tests/test_torch_restoration
# .py pins it). The launch passes it and csrc/tv.cu refuses any other than
# the kHalo it loads.
HALO = STEPS


def launches_per_call(max_num_iter: int) -> int:
    """Kernel launches of one ``denoise_tv_cuda`` call on the card."""
    return 3 * -(-int(max_num_iter) // STEPS)


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
    if _build.exporting():
        if return_iters:
            raise ValueError("denoise_tv: return_iters does not export")
        return torch.ops.mies.denoise_tv(batch, float(weight), float(eps),
                                         int(max_num_iter))
    _build.check_tensor(batch, "denoise_tv: batch")
    if batch.device.type == "cpu":
        out, iters = R.tv_chambolle(batch, weight, eps, max_num_iter)
        return (out, iters) if return_iters else out
    B, h, w = batch.shape
    w32, eps32, tau_w, size = R.tv_constants((h, w), weight, eps)
    nblocks = -(-h // TILE) * -(-w // TILE)
    dev = batch.device
    p = [torch.zeros((2, B, h, w), dtype=torch.float32, device=dev)
         for _ in range(2)]
    out = torch.empty_like(batch)
    partial = torch.empty((B, STEPS, nblocks, 2), dtype=torch.float64,
                          device=dev)
    iters, stop, roll = (torch.zeros(B, dtype=torch.int32, device=dev)
                         for _ in range(3))
    e_prev = torch.zeros(B, dtype=torch.float32, device=dev)
    e_init = torch.zeros(B, dtype=torch.float32, device=dev)
    for c, k0 in enumerate(range(0, int(max_num_iter), STEPS)):
        n = min(STEPS, int(max_num_iter) - k0)
        p_in, p_out = p[c % 2], p[(c + 1) % 2]
        chunk = (batch.data_ptr(), p_in.data_ptr(), p_out.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), stop.data_ptr(),
                 roll.data_ptr(), B, h, w, n, HALO, tau_w)
        _build.launch("tv", "mies_tv_chunk", dev, *chunk, 0)
        _build.launch("tv", "mies_tv_energy", dev, partial.data_ptr(),
                      iters.data_ptr(), e_prev.data_ptr(), e_init.data_ptr(),
                      stop.data_ptr(), roll.data_ptr(), B, h, w, n, w32,
                      eps32, size)
        _build.launch("tv", "mies_tv_chunk", dev, *chunk, 1)  # rollback
    return (out, iters) if return_iters else out


_build.register_op(
    "denoise_tv", denoise_tv_cuda,
    "(Tensor batch, float weight, float eps, int max_num_iter) -> Tensor",
    lambda batch, *_: torch.empty_like(batch),
    # 22 per pixel and step, counted at max_num_iter (a slice that stops
    # earlier runs fewer)
    lambda batch, weight, eps, max_num_iter: 22 * max_num_iter
    * batch.numel())

# the pipeline's batched TV: the wrapper already dispatches by device
denoise_tv_batched = denoise_tv_cuda
