"""The port's Hessian ridge filters (``mies_tpu_torch/ops/ridges.py``)
against the JAX package on the CPU, scipy and the float64 goldens.

* ``gaussian_derivative_kernel1d`` equals the reference's taps bit for bit
  (orders 0-2); ``gaussian_derivative`` equals scipy's
  ``gaussian_filter(order=...)`` within 5e-7 (the reference's bound) and
  the reference's op run op by op bit for bit.
* ``frangi``, ``vessel_enhance``, ``sato``, ``meijering`` and ``hessian``
  on a [3, H, W] batch against ``jax.jit(jax.vmap(op))`` and each slice
  alone against its row. The slices differ in contrast, so frangi's
  ``gamma=None`` norm and meijering's per-scale max must be one image's;
  meijering's default alpha must be 1/3 (a slice's rank), not 1/4 (the
  batch tensor's). Bounds: 2e-6 on frangi and vessel_enhance, 5e-6 on
  meijering and sato (XLA:CPU fuses the jitted Hessian's multiply-adds;
  sato is unnormalized, up to about 0.2 here); against the goldens the
  reference's own bounds (2e-6; meijering 5e-6).
* ``hessian`` maps frangi <= 0 to 1: a knife edge where frangi's ULPs flip
  a pixel between ~0 and 1, so as in ``tests/test_ridges.py`` the knife
  pixels are held to one of the two legal values and the rest to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import tests.goldens.golden_ops as G
from mies_tpu.ops import ridges as JR
from mies_tpu_torch.ops import ridges as TR
from mies_tpu_torch.pipeline.config import PipelineConfig, validate

torch.set_num_threads(2)

SHAPES = [(3, 48, 64), (1, 67, 93)]


def _vessels(shape, seed) -> np.ndarray:
    """Dark lines of several widths on a bright background plus noise; the
    contrast, background and noise differ by slice."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for i in range(b):
        img = np.full((h, w), 0.75 - 0.1 * i)
        for k, width in enumerate((1.0, 2.0, 3.5)):
            c = (k + 1) * w / 4 + 5 * np.sin(y / (7.0 + i))
            img -= (0.3 / (1 + 2 * i)) * np.exp(-((x - c) / width) ** 2)
        r = h / 2 + 8 * np.cos(x / 9.0)
        img -= 0.2 * np.exp(-((y - r) / 1.5) ** 2)
        img += (0.01 + 0.02 * i) * rng.standard_normal((h, w))
        out.append(np.clip(img, 0.0, 1.0))
    return np.stack(out).astype(np.float32)


def _check(top, jop, x, atol):
    """The port's batch against jit(vmap) of the JAX op, each slice alone
    equal to its row."""
    got = top(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jop))(jnp.asarray(x)))
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for i in range(x.shape[0]):
        np.testing.assert_array_equal(top(torch.from_numpy(x[i])).numpy(),
                                      got[i])
    return got


@pytest.mark.parametrize("sigma", [0.7, 1.0, 1.7, 2.0, 4.0, 9.0])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_derivative_taps_equal_reference(sigma, order):
    radius = int(4.0 * sigma + 0.5)
    got = TR.gaussian_derivative_kernel1d(sigma, order, radius)
    want = JR.gaussian_derivative_kernel1d(sigma, order, radius)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [(2, 0), (1, 1), (0, 2), (0, 0)])
@pytest.mark.parametrize("mode", ["reflect", "nearest", "mirror",
                                  "constant", "wrap"])
def test_gaussian_derivative_matches_scipy_and_jax(order, mode):
    x = _vessels((2, 40, 48), seed=3)
    got = TR.gaussian_derivative(torch.from_numpy(x), 1.7, order,
                                 mode).numpy()
    for i in range(2):
        ref = ndimage.gaussian_filter(x[i].astype(np.float64), 1.7,
                                      order=order, mode=mode)
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=5e-7)
    np.testing.assert_array_equal(got[1], np.asarray(JR.gaussian_derivative(
        jnp.asarray(x[1]), 1.7, order, mode)))


FRANGI_CASES = [
    {},  # gamma=None: each slice's half-max Frobenius norm per scale
    {"sigmas": (1.5,), "beta": 0.4, "gamma": 0.08, "black_ridges": False},
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", FRANGI_CASES)
def test_frangi_matches_jax_and_golden(shape, kw):
    x = _vessels(shape, seed=shape[1] + len(kw))
    got = _check(functools.partial(TR.frangi, **kw),
                 functools.partial(JR.frangi, **kw), x, 2e-6)
    for i in range(shape[0]):
        np.testing.assert_allclose(got[i], G.frangi_vesselness(x[i], **kw),
                                   rtol=0, atol=2e-6)


def test_frangi_norm_is_one_slices():
    """gamma=None on a batch whose slices differ only in contrast: each
    slice's response equals its response alone, and differs from what the
    batch's largest norm would give."""
    one = _vessels((1, 48, 64), seed=1)[0]
    x = np.stack([one, 0.5 * one, 0.25 * one]).astype(np.float32)
    got = TR.frangi(torch.from_numpy(x)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], TR.frangi(
            torch.from_numpy(x[i])).numpy())
    assert np.abs(got[0] - got[2]).max() < 1e-5  # scale-free per slice


@pytest.mark.parametrize("shape", SHAPES)
def test_vessel_enhance_matches_jax(shape):
    # configs/angio_vessel_enhance.yaml's stage
    kw = {"sigmas": (1.0, 2.0, 4.0), "beta": 0.5, "gamma": 0.1, "amount": 0.8}
    x = _vessels(shape, seed=shape[2])
    got = _check(functools.partial(TR.vessel_enhance, **kw),
                 functools.partial(JR.vessel_enhance, **kw), x, 2e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0
    for i in range(shape[0]):
        want = np.clip(x[i] + 0.8 * G.frangi_vesselness(
            x[i], sigmas=(1.0, 2.0, 4.0), beta=0.5, gamma=0.1), 0.0, 1.0)
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {}, {"sigmas": (1.5, 2.5), "black_ridges": False, "mode": "nearest"}])
def test_sato_matches_jax_and_golden(shape, kw):
    x = _vessels(shape, seed=7 + shape[1] + len(kw))
    got = _check(functools.partial(TR.sato, **kw),
                 functools.partial(JR.sato, **kw), x, 5e-6)
    for i in range(shape[0]):
        np.testing.assert_allclose(got[i], G.sato_tubeness(x[i], **kw),
                                   rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {}, {"sigmas": (1.5,), "alpha": 0.25, "black_ridges": False}])
def test_meijering_matches_jax_and_golden(shape, kw):
    x = _vessels(shape, seed=11 + shape[1] + len(kw))
    got = _check(functools.partial(TR.meijering, **kw),
                 functools.partial(JR.meijering, **kw), x, 5e-6)
    assert got.max() <= 1.0 + 1e-6
    for i in range(shape[0]):
        np.testing.assert_allclose(
            got[i], G.meijering_neuriteness(x[i], **kw), rtol=0, atol=5e-6)


def test_meijering_default_alpha_is_a_slices():
    x = torch.from_numpy(_vessels((3, 48, 64), seed=2))
    np.testing.assert_array_equal(TR.meijering(x).numpy(),
                                  TR.meijering(x, alpha=1.0 / 3.0).numpy())
    assert not np.array_equal(TR.meijering(x).numpy(),
                              TR.meijering(x, alpha=0.25).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_hessian_matches_jax_and_golden_off_the_knife(shape):
    kw = {"sigmas": (1.0, 3.0)}
    x = _vessels(shape, seed=13 + shape[1])
    got = TR.hessian(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        functools.partial(JR.hessian, **kw)))(jnp.asarray(x)))
    for i in range(shape[0]):
        np.testing.assert_array_equal(
            TR.hessian(torch.from_numpy(x[i]), **kw).numpy(), got[i])
        fr = G.frangi_vesselness(x[i], gamma=15.0, **kw)
        knife = np.abs(fr) <= 1e-6
        for ref in (want[i], G.hessian_ridge(x[i], **kw)):
            np.testing.assert_allclose(got[i][~knife], ref[~knife], rtol=0,
                                       atol=1e-5)
        legal = (np.abs(got[i][knife] - 1.0) <= 1e-6) | (
            np.abs(got[i][knife]) <= 2e-6)
        assert legal.all()


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="explicit gamma"):
        TR.hessian(torch.zeros((1, 16, 16)), gamma=None)
    with pytest.raises(ValueError, match="sigmas"):
        validate(PipelineConfig.make([("frangi", {"sigmas": []})]))
    with pytest.raises(ValueError, match="alpha"):
        validate(PipelineConfig.make([("meijering", {"alpha": -1.0})]))
    with pytest.raises(ValueError, match="gamma"):
        validate(PipelineConfig.make([("hessian", {"gamma": None})]))
