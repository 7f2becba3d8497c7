"""Perona-Malik diffusion and SRAD on the card: K9 and K10
(``csrc/diffusion.cu``).

For a CUDA tensor ``anisotropic_diffusion_cuda`` runs ``niter`` Perona-
Malik steps in ``pm_launches_per_call(niter)`` K9 launches of at most
``PM_STEPS`` steps each, and ``srad_cuda`` runs ``niter`` SRAD steps in
``launches_per_call(niter)`` K10 launches of at most ``STEPS`` steps each
(the last one shorter), both ping-ponging two buffers (the input is never
written); for a CPU tensor each runs the plain ``ops.restoration`` op. Any
image shape runs: the borders are resolved by index in the kernels. The
argument errors are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.ops import restoration as R

# SRAD steps per K10 launch, csrc/diffusion.cu kSrSteps: 2 ran faster than
# 4 and 8 on an H100 (PERF.md; chip_smoke.py times them)
STEPS = 2
# the halo a K10 block loads around its 64 x 64 tile, above / left and below
# / right: a step reads one pixel up and left and two down and right (the
# conduction at the south and east neighbours reads their own), so STEPS
# steps reach STEPS and 2 STEPS pixels (tests/test_torch_restoration.py pins
# it). The launch passes it and csrc/diffusion.cu refuses any other than the
# halo it loads.
HALO = (STEPS, 2 * STEPS)
# Perona-Malik steps per K9 launch, csrc/diffusion.cu kPmSteps: 3 ran
# faster than 2 and 6 at w8's 6 steps on an H100 (PERF.md)
PM_STEPS = 3
# the halo a K9 warp loads on every side of its tile: a step reads one
# pixel each way (tests/test_torch_restoration.py pins it). The launch
# passes it and csrc/diffusion.cu refuses any other than the halo it loads.
PM_HALO = PM_STEPS


def launches_per_call(niter: int) -> int:
    """K10 launches of one ``srad_cuda`` call on the card."""
    return -(-int(niter) // STEPS)


def pm_launches_per_call(niter: int) -> int:
    """K9 launches of one ``anisotropic_diffusion_cuda`` call on the card."""
    return -(-int(niter) // PM_STEPS)


def _chunks(batch: torch.Tensor, niter: int, steps: int, launch
            ) -> torch.Tensor:
    """``niter`` steps in launches of at most ``steps`` steps each:
    ``launch(src, dst, k, n)`` runs steps k .. k + n - 1 from src into dst,
    alternating two buffers (the input is never written)."""
    bufs = (torch.empty_like(batch),
            torch.empty_like(batch) if niter > steps else None)
    src = batch
    for c, k in enumerate(range(0, niter, steps)):
        dst = bufs[c % 2]
        launch(src, dst, k, min(steps, niter - k))
        src = dst
    return src


def anisotropic_diffusion_cuda(
    batch: torch.Tensor,
    niter: int = 10,
    kappa: float = 50.0,
    gamma: float = 0.1,
    option: int = 1,
) -> torch.Tensor:
    """K9: ``niter`` Perona-Malik steps of [B, H, W] float32, PM_STEPS a
    launch."""
    niter, option = int(niter), int(option)
    R.check_pm_args(niter, option)
    if _build.exporting():
        return torch.ops.mies.anisotropic_diffusion(
            batch, niter, float(kappa), float(gamma), option)
    _build.check_tensor(batch, "anisotropic_diffusion: batch")
    if batch.device.type == "cpu":
        return R.anisotropic_diffusion(batch, niter, kappa, gamma, option)
    inv_k2, g32 = R.pm_constants(kappa, gamma)

    def launch(src, dst, _, n):
        _build.launch("perona_malik", "mies_perona_malik", batch.device,
                      src.data_ptr(), dst.data_ptr(), *batch.shape, n,
                      PM_HALO, inv_k2, g32, option)
    return _chunks(batch, niter, PM_STEPS, launch)


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
    if _build.exporting():
        return torch.ops.mies.srad(batch, niter, float(dt), float(q0),
                                   float(rho), float(eps))
    _build.check_tensor(batch, "srad: batch")
    if batch.device.type == "cpu":
        return R.srad(batch, niter, dt, q0, rho, eps)
    return _srad_chunks(batch, 0, niter, _srad_consts(dt, q0, rho, eps))


def _srad_consts(dt, q0, rho, eps) -> tuple[float, ...]:
    return (float(np.float32(q0)), float(np.float32(rho)),
            float(np.float32(eps)), float(np.float32(dt / 4.0)))


def _srad_chunks(batch: torch.Tensor, t0: int, niter: int,
                 consts: tuple[float, ...]) -> torch.Tensor:
    """Steps t0 .. t0 + niter - 1 in K10 launches of at most STEPS steps."""
    def launch(src, dst, k, n):
        _build.launch("srad", "mies_srad", batch.device, src.data_ptr(),
                      dst.data_ptr(), *batch.shape, t0 + k, n, *HALO, *consts)
    return _chunks(batch, niter, STEPS, launch)


def srad_step(batch: torch.Tensor, t: int, dt: float = 0.15, q0: float = 1.0,
              rho: float = 0.2, eps: float = 1e-6) -> torch.Tensor:
    """Iteration ``t`` of SRAD alone: one K10 launch of one step for a CUDA
    tensor, ``ops.restoration.srad_iteration`` for a CPU tensor (the
    row-sharded chain refreshes its halo between iterations)."""
    R.check_srad_args(1, dt, q0, rho)
    _build.check_tensor(batch, "srad: batch")
    if batch.device.type == "cpu":
        return R.srad_iteration(batch, t, dt, q0, rho, eps)
    return _srad_chunks(batch, int(t), 1, _srad_consts(dt, q0, rho, eps))


_build.register_op(
    "anisotropic_diffusion", anisotropic_diffusion_cuda,
    "(Tensor batch, int niter, float kappa, float gamma, int option) -> "
    "Tensor", lambda batch, *_: torch.empty_like(batch),
    # per pixel and step: two differences, two fluxes (6 each), the
    # divergence (2) and the update (2)
    lambda batch, niter, *_: 18 * niter * batch.numel())
_build.register_op(
    "srad", srad_cuda,
    "(Tensor batch, int niter, float dt, float q0, float rho, float eps) -> "
    "Tensor", lambda batch, *_: torch.empty_like(batch),
    # per pixel and step: 4 differences, one conduction (29), the
    # divergence (7) and the update (2)
    lambda batch, niter, *_: 42 * niter * batch.numel())

# the pipeline's batched ops: the wrappers already dispatch by device
anisotropic_diffusion_batched = anisotropic_diffusion_cuda
srad_batched = srad_cuda
