"""The volume program's restorations and its 3-D low-dose CT chain against
the JAX package on the CPU.

The same seeded numpy volumes ([8, 24, 32] and the ragged [7, 23, 31])
go through each ``mies_tpu_torch.ops.restoration`` ``*3d`` op and its
reference. The reference runs these in XLA (``lax.fori_loop`` /
``while_loop``: compiled even outside ``jax.jit``), whose CPU code
contracts multiply-adds into FMAs and sums in its own order; the gaps are
the ones ROADMAP.md queue 3 records for the 2-D forms: NL-means and TV
2e-6, Perona-Malik and SRAD 1e-6; Wiener 2e-6 of the reference and 3e-5 of
its float64 golden (the reference's own bound). ``denoise_tv3d`` stops on
the whole volume's energy at the reference's iteration.

The chain ``chip_smoke.py`` phase 7 (a) runs at [256, 512, 512] on the
card (window_hu -> median_blur3d -> denoise_tv3d -> clahe3d opencv ->
unsharp_mask3d -> uint8) is held here at [8, 64, 64] by stages against
the reference's ``compile_volume_pipeline``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.ops import restoration as JR
from mies_tpu.pipeline.compiler import compile_volume_pipeline as j_volume
from mies_tpu.pipeline.config import PipelineConfig as JConfig
from mies_tpu_torch.ops import restoration as TR
from mies_tpu_torch.pipeline import compiler as TC
from mies_tpu_torch.pipeline.config import PipelineConfig
from tests.goldens import golden_ops as G

torch.set_num_threads(2)

SHAPES = [(8, 24, 32), (7, 23, 31)]


def _noisy(shape, seed=0, scale=0.08) -> np.ndarray:
    """A ramp along x with a bright cube, plus Gaussian noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    v = np.broadcast_to(np.linspace(0.2, 0.8, shape[-1], dtype=np.float32),
                        shape).copy()
    v[shape[0] // 4:, shape[1] // 3:2 * shape[1] // 3, 4:12] += 0.2
    v += rng.normal(0.0, scale, shape).astype(np.float32)
    return np.clip(v, 0.01, 1.0).astype(np.float32)


def _port(fn, vol, **kw):
    return fn(torch.from_numpy(vol), **kw).numpy()


def _jit(fn, vol, **kw):
    return np.asarray(jax.jit(lambda v: fn(v, **kw))(jnp.asarray(vol)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_nl_means3d_within_2e6(shape):
    vol = _noisy(shape)
    kw = dict(patch_size=3, patch_distance=2, h=0.08, sigma=0.02)
    np.testing.assert_allclose(_port(TR.denoise_nl_means3d, vol, **kw),
                               _jit(JR.denoise_nl_means3d, vol, **kw),
                               atol=2e-6, rtol=0)


def test_nl_means3d_defaults_within_2e6():
    """patch 5, distance 5: all 665 pairs of the half table."""
    vol = _noisy((8, 24, 32), seed=1)
    np.testing.assert_allclose(_port(TR.denoise_nl_means3d, vol),
                               _jit(JR.denoise_nl_means3d, vol),
                               atol=2e-6, rtol=0)


def test_nl_means3d_refuses_an_extension_past_the_volume():
    with pytest.raises(ValueError, match="must be < every image dim - 1"):
        TR.denoise_nl_means3d(torch.zeros(7, 23, 31))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tv3d_within_2e6_and_stops_at_the_references_iteration(shape):
    """The port's stop iteration n is the reference's: the reference run
    for n iterations gives the output of a long run, for n - 1 not."""
    vol = _noisy(shape, seed=2)
    kw = dict(weight=0.08, eps=2e-4)
    out, n = TR.tv_chambolle3d(torch.from_numpy(vol), max_num_iter=200, **kw)
    assert 2 < n < 200
    ref = _jit(JR.denoise_tv3d, vol, max_num_iter=200, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(
        _jit(JR.denoise_tv3d, vol, max_num_iter=n, **kw), ref)
    assert not np.array_equal(
        _jit(JR.denoise_tv3d, vol, max_num_iter=n - 1, **kw), ref)
    # the registry op is the output of the same iteration
    np.testing.assert_array_equal(
        _port(TR.denoise_tv3d, vol, max_num_iter=200, **kw), out.numpy())


def test_tv3d_matches_the_golden_without_a_stop():
    vol = _noisy((8, 20, 20), seed=3)
    got = _port(TR.denoise_tv3d, vol, weight=0.1, eps=0.0, max_num_iter=25)
    gold = G.denoise_tv_chambolle(vol, weight=0.1, eps=0.0, max_num_iter=25)
    np.testing.assert_allclose(got, gold, atol=5e-6, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kw", [{}, {"psf_sigma": 1.0, "psf_size": 5,
                                     "balance": 0.05, "clip": False}],
                         ids=["defaults", "sigma1"])
def test_wiener3d_within_2e6_and_the_golden(shape, kw):
    vol = _noisy(shape, seed=4)
    got = _port(TR.wiener3d, vol, **kw)
    np.testing.assert_allclose(got, np.asarray(JR.wiener3d(
        jnp.asarray(vol), **kw)), atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, G.wiener_deconv(vol, **kw), atol=3e-5,
                               rtol=0)


def test_wiener_2d_runs_each_slice_of_a_batch():
    """The 2-D op (now in the registry) deconvolves each [H, W] slice of a
    batch alone: equal to the reference's per-slice op within 2e-6."""
    b = _noisy((3, 40, 36), seed=5)
    got = _port(TR.wiener, b, psf_sigma=1.2, psf_size=5)
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(JR.wiener(
            jnp.asarray(b[i]), psf_sigma=1.2, psf_size=5)), atol=2e-6, rtol=0)
    np.testing.assert_allclose(got[1], G.wiener_deconv(b[1], 1.2, 5),
                               atol=3e-5, rtol=0)


PM = [
    {"niter": 4, "kappa": 0.15, "gamma": 0.1},
    {"niter": 3, "kappa": 0.2, "gamma": 0.05, "option": 2,
     "voxelspacing": (2.5, 0.7, 0.7)},
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kw", PM, ids=["option1", "option2_spacing"])
def test_anisotropic_diffusion3d_within_1e6(shape, kw):
    vol = _noisy(shape, seed=6)
    got = _port(TR.anisotropic_diffusion3d, vol, **kw)
    np.testing.assert_allclose(got, _jit(JR.anisotropic_diffusion3d, vol,
                                         **kw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, G.anisotropic_diffusion(vol, **kw),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_srad3d_within_1e6(shape):
    vol = _noisy(shape, seed=7)
    got = _port(TR.srad3d, vol, niter=5)
    np.testing.assert_allclose(got, _jit(JR.srad3d, vol, niter=5), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got, G.srad3d(vol, niter=5), atol=1e-5, rtol=0)


def test_anisotropic_diffusion3d_refuses_bad_spacing():
    with pytest.raises(ValueError, match="voxelspacing"):
        TR.anisotropic_diffusion3d(torch.zeros(4, 8, 8),
                                   voxelspacing=(1.0, 0.0, 1.0))


# --- chip_smoke.py phase 7 (a): the 3-D low-dose CT chain, by stages -------

CT3D = [
    ("median_blur3d", {"kernel_size": 3}),
    ("denoise_tv3d", {"weight": 0.03, "max_num_iter": 60}),
    ("clahe3d", {"clip_limit": 2.0, "grid_size": (4, 8, 8),
                 "convention": "opencv"}),
    ("unsharp_mask3d", {"radius": 1.0, "amount": 0.5}),
]


def _ct_phantom(shape, seed=0) -> np.ndarray:
    """int16 HU: soft tissue (40) in air with a denser ellipsoid (120) and
    a vessel (200) along z, quantum noise sigma 25 HU."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]].astype(np.float32)
    cy, cx = shape[1] / 2, shape[2] / 2
    r = np.sqrt(((y - cy) / (0.4 * shape[1])) ** 2
                + ((x - cx) / (0.45 * shape[2])) ** 2)
    hu = np.where(r < 1.0, 40.0, -1000.0)
    hu = np.where(((y - cy) / 8) ** 2 + ((x - cx + 6) / 6) ** 2 < 1, 120, hu)
    hu = np.where((y - cy - 10) ** 2 + (x - cx) ** 2 < 9, 200.0, hu)
    hu = hu + 25.0 * rng.standard_normal(shape)
    return np.clip(np.rint(hu), -1024, 3071).astype(np.int16)


def _stage(stage, x, quantize=False):
    """One stage through each package's compile_volume_pipeline."""
    j = np.asarray(j_volume(
        JConfig.make([stage]), quantize=quantize)(jnp.asarray(x)))
    t = TC.compile_volume_pipeline(PipelineConfig.make([stage]),
                                   quantize=quantize, device="cpu")(
        torch.from_numpy(x)).numpy()
    return t, j


def test_ct3d_chain_by_stages_against_the_reference():
    hu = _ct_phantom((8, 64, 64))
    cfg = PipelineConfig.make([("window_hu", {"center": 40.0,
                                              "width": 400.0}), *CT3D])
    chain = TC.compile_volume_pipeline(cfg, device="cpu")(hu).numpy()
    # window_hu: float64's levels at every voxel (the jitted reference
    # multiplies by the reciprocal of the width: ROADMAP.md queue 3)
    x = TC.compile_volume_pipeline(PipelineConfig.make([cfg.stages[0]]),
                                   quantize=False, device="cpu")(hu).numpy()
    want = np.clip((hu.astype(np.float64) + 160.0) / 400.0, 0, 1)
    np.testing.assert_array_equal(np.rint(x * 255.0), np.rint(want * 255.0))
    # median: bit-equal; TV: 2e-6
    t, j = _stage(CT3D[0], x)
    np.testing.assert_array_equal(t, j)
    t, j = _stage(CT3D[1], t)
    np.testing.assert_allclose(t, j, atol=2e-6, rtol=0)
    # clahe3d opencv on identical input: levels within 1 on < 1e-3
    c, jc = _stage(CT3D[2], t)
    d = np.abs(np.rint(c * 255) - np.rint(jc * 255))
    assert d.max() <= 1 and np.count_nonzero(d) < 1e-3 * d.size
    # unsharp + uint8 on identical input: bit-equal
    u, ju = _stage(CT3D[3], c, quantize=True)
    np.testing.assert_array_equal(u, ju)
    # and the whole chain is the stages in a row
    np.testing.assert_array_equal(chain, u)
    assert chain.dtype == np.uint8 and chain.shape == hu.shape
