"""The port's edge, Laplacian, DoG, Gabor, motion-blur, retinex, Kuwahara,
box-blur and denoise_bilateral ops (``mies_tpu_torch.ops.filters``)
against the JAX package on the CPU, on the same seeded numpy batches of
[2, 64, 96] and [2, 67, 93].

Two references per op: ``jax.vmap`` of the JAX op run eagerly (the op as
written, primitive by primitive) and ``jax.jit(jax.vmap(op))``, the
reference compiler's program, in which XLA:CPU contracts multiply-adds
into FMAs. Tolerances:

* bit-equal to the eager op: box_blur, laplace, laplacian_sharpen,
  difference_of_gaussians, the five edge magnitudes (shifted adds and a
  correctly rounded square root), kuwahara (shifted sums and a strict-<
  select); within 3e-7 of the jitted one (its FMAs);
* within 1e-6 of the jitted op: gabor, gabor_bank, motion_blur (one
  conv2d: float32 sums in cuDNN's / oneDNN's order, not XLA's), retinex
  (the float32 logs of two libraries);
* within 2e-6 of the jitted op: denoise_bilateral (the bilateral's
  window sum order; K3's own contract).

And against ``tests/goldens/golden_ops.py`` (scipy) at the reference's own
bounds (tests/test_filters.py, tests/test_frequency.py,
tests/test_intensity.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.goldens.golden_ops as G
from mies_tpu.pipeline.compiler import OP_REGISTRY as J_OPS
from mies_tpu_torch.kernels import bilateral as KB
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.pipeline.compiler import OP_REGISTRY as T_OPS
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(2)

SHAPES = [(2, 64, 96), (2, 67, 93)]

EXACT = [
    ("box_blur", {}), ("box_blur", {"kernel_size": 5, "mode": "nearest"}),
    ("laplace", {}), ("laplace", {"mode": "wrap"}),
    ("laplacian_sharpen", {}), ("laplacian_sharpen", {"alpha": 0.5,
                                                      "mode": "mirror"}),
    ("difference_of_gaussians", {}),
    ("difference_of_gaussians", {"low_sigma": 0.5, "high_sigma": 1.2,
                                 "mode": "reflect"}),
    ("sobel_edges", {}), ("sobel_edges", {"mode": "nearest"}),
    ("scharr_edges", {}), ("prewitt_edges", {}), ("farid_edges", {}),
    ("roberts_edges", {}), ("roberts_edges", {"mode": "constant"}),
    ("kuwahara", {}), ("kuwahara", {"kernel_size": 3, "mode": "nearest"}),
]
CONV = [
    ("gabor", {}),
    ("gabor", {"frequency": 0.2, "theta": 0.7, "offset": 0.3,
               "output": "real"}),
    ("gabor", {"frequency": 0.15, "theta": 1.1, "output": "imag",
               "mode": "nearest"}),
    ("gabor_bank", {}),
    ("gabor_bank", {"frequency": 0.2, "n_orientations": 3,
                    "output": "mean"}),
    ("motion_blur", {}),
    ("motion_blur", {"kernel_size": 7, "angle": 30.0, "direction": 0.5,
                     "mode": "reflect"}),
    ("retinex", {}),
    ("retinex", {"sigmas": [1.5, 6.0], "weights": [0.7, 0.3],
                 "rescale": "minmax", "gain": 2.0}),
]
BILATERAL = [
    ("denoise_bilateral", {}),
    ("denoise_bilateral", {"sigma_spatial": 0.5, "mode": "mirror"}),
    ("denoise_bilateral", {"sigma_color": 0.2, "sigma_spatial": 1.4,
                           "mode": "reflect"}),
]


def _batch(shape, seed=18) -> np.ndarray:
    """Seeded slices with an edge, a ramp and noise, of different ranges."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    imgs = []
    for i in range(b):
        base = 0.2 + 0.1 * i + 0.3 * (x > w // 3 + 5 * i) + 0.2 * y / h
        imgs.append(base + (0.05 + 0.05 * i) * rng.standard_normal((h, w)))
    return np.clip(np.stack(imgs), 0.0, 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def refs():
    """The JAX op's outputs, each (op, params, shape, jit) computed once."""
    cache = {}

    def get(op, kw, shape, jit):
        key = (op, repr(sorted(kw.items())), shape, jit)
        if key not in cache:
            f = jax.vmap(functools.partial(J_OPS[op], **kw))
            f = jax.jit(f) if jit else f
            cache[key] = np.asarray(f(jnp.asarray(_batch(shape))))
        return cache[key]

    return get


def _port(op, kw, shape) -> np.ndarray:
    out = T_OPS[op](torch.from_numpy(_batch(shape)), **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    return out.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,kw", EXACT)
def test_shifted_add_ops_bit_equal_to_the_eager_op(refs, op, kw, shape):
    got = _port(op, kw, shape)
    np.testing.assert_array_equal(got, refs(op, kw, shape, False))
    np.testing.assert_allclose(got, refs(op, kw, shape, True), rtol=0,
                               atol=3e-7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,kw", CONV)
def test_conv2d_and_retinex_within_1e6_of_the_jitted_op(refs, op, kw, shape):
    np.testing.assert_allclose(_port(op, kw, shape), refs(op, kw, shape, True),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,kw", BILATERAL)
def test_denoise_bilateral_within_2e6_of_the_jitted_op(refs, op, kw, shape):
    np.testing.assert_allclose(_port(op, kw, shape), refs(op, kw, shape, True),
                               rtol=0, atol=2e-6)


def test_each_slice_is_its_own_image():
    """retinex 'minmax' stretches each slice by its own range, as the
    reference under vmap: a slice alone equals its row of the batch."""
    x = torch.from_numpy(_batch((2, 64, 96)))
    kw = {"sigmas": [2.0], "rescale": "minmax"}
    both = TF.retinex(x, **kw)
    for i in range(2):
        torch.testing.assert_close(TF.retinex(x[i], **kw), both[i], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("sigma,mode,k,on_k3", [
    (1.0, "edge", 7, True), (0.5, "edge", 5, True), (1.3, "reflect", 9, True),
    (1.4, "edge", 11, False), (1.0, "constant", 7, False),
    (1.0, "wrap", 7, False)])
def test_denoise_bilateral_route_follows_window_and_mode(sigma, mode, k, on_k3):
    """K3 takes windows up to 9 in its borders; the route is fixed by the
    parameters, and on the CPU both routes are the plain filter."""
    assert TF.denoise_bilateral_window(sigma) == k
    assert KB.denoise_bilateral_on_k3(sigma, mode) is on_k3
    x = torch.from_numpy(_batch((2, 64, 96)))
    got = KB.denoise_bilateral_batched(x, 0.1, sigma, mode)
    torch.testing.assert_close(got, TF.bilateral_blur(x, k, 0.1, sigma, mode),
                               rtol=0, atol=0)


def test_denoise_bilateral_through_compile_pipeline():
    x = _batch((2, 67, 93))
    cfg = PipelineConfig.make([("denoise_bilateral", {"sigma_spatial": 1.0})])
    got = compile_pipeline(cfg, batched=True, quantize=False,
                           device="cpu")(x).numpy()
    np.testing.assert_array_equal(
        got, TF.denoise_bilateral(torch.from_numpy(x)).numpy())


# --- against the float64 goldens (scipy) ----------------------------------

@pytest.mark.parametrize("op,atol", [
    ("sobel_edges", 3e-5), ("scharr_edges", 3e-5), ("prewitt_edges", 3e-5),
    ("farid_edges", 3e-5), ("roberts_edges", 1e-6), ("laplace", 1e-6),
    ("laplacian_sharpen", 1e-6), ("box_blur", 1e-6), ("kuwahara", 1e-6)])
def test_against_the_goldens(op, atol):
    img = _batch((1, 67, 93))[0]
    got = T_OPS[op](torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, getattr(G, op)(img), rtol=0, atol=atol)


def test_dog_gabor_motion_retinex_against_the_goldens():
    img = _batch((1, 64, 96))[0]
    t = torch.from_numpy(img)
    np.testing.assert_allclose(TF.difference_of_gaussians(t, 1.5).numpy(),
                               G.difference_of_gaussians(img, 1.5), atol=1e-6)
    re, im = TF.gabor_response(t, 0.2, theta=0.6, offset=0.4)
    ref_re, ref_im = G.gabor_response(img, 0.2, theta=0.6, offset=0.4)
    np.testing.assert_allclose(re.numpy(), ref_re, atol=1e-5)
    np.testing.assert_allclose(im.numpy(), ref_im, atol=1e-5)
    np.testing.assert_allclose(TF.motion_blur(t, 9, 30.0, 0.5).numpy(),
                               G.motion_blur(img, 9, 30.0, 0.5), atol=1e-6)
    np.testing.assert_allclose(TF.retinex(t).numpy(), G.retinex(img),
                               atol=5e-4)


def test_gabor_and_motion_kernels_equal_the_reference():
    from mies_tpu.ops import filters as JF

    for args in [(0.1,), (0.2, 0.7, 1.5, None, 3.0, 2, 0.3)]:
        np.testing.assert_array_equal(TF.gabor_kernel(*args),
                                      JF.gabor_kernel(*args))
    for args in [(9, 0.0, 0.0), (7, 30.0, 0.5), (11, 123.0, -1.0)]:
        np.testing.assert_array_equal(TF.motion_blur_kernel(*args),
                                      JF.motion_blur_kernel(*args))
