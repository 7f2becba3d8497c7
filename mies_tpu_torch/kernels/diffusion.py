"""Perona-Malik diffusion and SRAD on the card: K9 and K10
(``csrc/diffusion.cu``).

Each wrapper runs ``niter`` launches for a CUDA tensor, one per iteration,
ping-ponging two buffers (the input is never written), and the plain
``ops.restoration`` op for a CPU tensor. Any image shape runs: the borders
are resolved by index in the kernels. The argument errors are the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import restoration as R


def _steps(batch: torch.Tensor, niter: int, name: str, entry: str,
           args_of) -> torch.Tensor:
    """``niter`` launches of ``entry``(src, dst, B, H, W, *args_of(t)),
    src -> dst, alternating two buffers."""
    B, h, w = batch.shape
    bufs = (torch.empty_like(batch), torch.empty_like(batch))
    src = batch
    for t in range(niter):
        dst = bufs[t % 2]
        _build.launch(name, entry, batch.device, src.data_ptr(),
                      dst.data_ptr(), B, h, w, *args_of(t))
        src = dst
    return src


def anisotropic_diffusion_cuda(
    batch: torch.Tensor,
    niter: int = 10,
    kappa: float = 50.0,
    gamma: float = 0.1,
    option: int = 1,
) -> torch.Tensor:
    """K9: ``niter`` Perona-Malik steps of [B, H, W] float32."""
    niter, option = int(niter), int(option)
    R.check_pm_args(niter, option)
    _build.check_tensor(batch, "anisotropic_diffusion: batch")
    if batch.device.type == "cpu":
        return R.anisotropic_diffusion(batch, niter, kappa, gamma, option)
    inv_k2, g32 = R.pm_constants(kappa, gamma)
    return _steps(batch, niter, "perona_malik", "mies_perona_malik",
                  lambda t: (inv_k2, g32, option))


def srad_cuda(
    batch: torch.Tensor,
    niter: int = 15,
    dt: float = 0.15,
    q0: float = 1.0,
    rho: float = 0.2,
    eps: float = 1e-6,
) -> torch.Tensor:
    """K10: ``niter`` SRAD steps of [B, H, W] float32; step t computes
    q0 exp(-rho t) in f32 on the card, as the plain version does."""
    niter = int(niter)
    R.check_srad_args(niter, dt, q0, rho)
    _build.check_tensor(batch, "srad: batch")
    if batch.device.type == "cpu":
        return R.srad(batch, niter, dt, q0, rho, eps)
    consts = _srad_consts(dt, q0, rho, eps)
    return _steps(batch, niter, "srad", "mies_srad",
                  lambda t: (t, *consts))


def _srad_consts(dt, q0, rho, eps) -> tuple[float, ...]:
    return (float(np.float32(q0)), float(np.float32(rho)),
            float(np.float32(eps)), float(np.float32(dt / 4.0)))


def srad_step(batch: torch.Tensor, t: int, dt: float = 0.15, q0: float = 1.0,
              rho: float = 0.2, eps: float = 1e-6) -> torch.Tensor:
    """Iteration ``t`` of SRAD alone: one K10 launch for a CUDA tensor,
    ``ops.restoration.srad_iteration`` for a CPU tensor (the row-sharded
    chain refreshes its halo between iterations)."""
    R.check_srad_args(1, dt, q0, rho)
    _build.check_tensor(batch, "srad: batch")
    if batch.device.type == "cpu":
        return R.srad_iteration(batch, t, dt, q0, rho, eps)
    consts = _srad_consts(dt, q0, rho, eps)
    return _steps(batch, 1, "srad", "mies_srad", lambda _: (int(t), *consts))


# the pipeline's batched ops: the wrappers already dispatch by device
anisotropic_diffusion_batched = anisotropic_diffusion_cuda
srad_batched = srad_cuda
