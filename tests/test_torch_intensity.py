"""The port's intensity and global-equalization ops against the JAX package,
on CPU.

The same seeded numpy batch goes through each op of
``mies_tpu_torch.ops.intensity`` / ``.histogram`` and its JAX namesake,
eagerly on one image and as the reference compiler binds it (``jax.vmap`` of
the op, or its batched form for ``equalize_hist`` and ``equalize``). The
batch's images have different ranges and histograms, so a batch-wide min,
max or histogram would show. Tolerances:

* bit-equal against the eager JAX op and its eager binding: invert,
  brightness, contrast, solarize, posterize, normalize, rescale_intensity
  (both in_range forms), equalize, equalize_hist;
* <= 1e-6 abs: adjust_gamma, adjust_log, adjust_sigmoid (libm against
  XLA's pow/log2/exp) and sharpness (XLA:CPU contracts its 3x3 sum into
  FMAs under jit);
* <= 1.2e-7 abs (one float32 ulp at 1.0) against the JITTED binding, where
  XLA:CPU multiplies by the reciprocal of a constant divisor (/ 255) and
  contracts multiply-adds.

``equalize_hist`` is also held against tests/goldens/golden_ops.py's
float64 numpy transcription of skimage (atol 2e-5, the reference's own
test) and ``equalize`` against its PIL transcription (bit-equal levels).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.ops import histogram as JH
from mies_tpu.ops import intensity as JI
from mies_tpu.pipeline.compiler import OP_REGISTRY as J_OPS
from mies_tpu.pipeline.compiler import _batched_registry
from mies_tpu.pipeline.config import PipelineConfig as JConfig
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.ops import intensity as TI
from mies_tpu_torch.pipeline.compiler import OP_REGISTRY as T_OPS
from tests.goldens import golden_ops as G

torch.set_num_threads(2)

SHAPES = [(2, 64, 96), (2, 96, 160), (1, 67, 93)]
ULP1 = 1.2e-7

# (registry name, params): every intensity op the port registers
BIT_EQUAL = [
    ("invert", {}),
    ("adjust_brightness", {"factor": 0.15}),
    ("adjust_brightness", {"factor": -0.2}),
    ("adjust_contrast", {"factor": 1.4}),
    ("solarize", {"threshold": 0.45}),
    ("posterize", {"bits": 3}),
    ("posterize", {"bits": 8}),
    ("normalize", {}),
    ("rescale_intensity", {}),
    ("rescale_intensity", {"out_range": (0.1, 0.8)}),
    ("rescale_intensity", {"in_range": (0.2, 0.7)}),
    ("rescale_intensity", {"in_range": (0.1, 0.9), "out_range": (0.25, 1.0)}),
    ("equalize", {}),
    ("equalize_hist", {}),
    ("equalize_hist", {"nbins": 100}),
]
LIBM = [
    ("adjust_gamma", {"gamma": 0.8}),
    ("adjust_gamma", {"gamma": 2.2, "gain": 0.9}),
    ("adjust_log", {}),
    ("adjust_log", {"gain": 0.7, "inv": True}),
    ("adjust_sigmoid", {}),
    ("adjust_sigmoid", {"cutoff": 0.4, "gain": 6.0, "inv": True}),
    ("sharpness", {"factor": 0.0}),
    ("sharpness", {"factor": 1.7}),
]


def _batch(shape, seed=0) -> np.ndarray:
    """Images of different ranges and histograms: image i spans
    [lo_i, lo_i + span_i) with its own skew."""
    rng = np.random.default_rng(seed)
    b = shape[0]
    lo = np.array([0.0, 0.35, 0.6])[:b, None, None]
    span = np.array([1.0, 0.4, 0.25])[:b, None, None]
    power = np.array([1.0, 2.5, 0.5])[:b, None, None]
    return (lo + span * rng.random(shape) ** power).astype(np.float32)


def _id(case):
    op, kw = case
    return op + "".join(f"-{k}={v}" for k, v in kw.items())


def _jax_binding(op, kw):
    """The reference compiler's binding of a stage: its batched form, or
    jax.vmap of the per-image op."""
    batched = _batched_registry()
    if op in batched:
        return functools.partial(batched[op], **kw)
    return jax.vmap(functools.partial(J_OPS[op], **kw))


def _check(op, kw, shape, tol):
    x = _batch(shape)
    got = T_OPS[op](torch.from_numpy(x), **kw).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    # eager: the batch's last image alone (the binding sees them all)
    eager = np.asarray(J_OPS[op](jnp.asarray(x[-1]), **kw))
    bound = _jax_binding(op, kw)
    vmapped = np.asarray(bound(jnp.asarray(x)))
    jitted = np.asarray(jax.jit(bound)(jnp.asarray(x)))
    if tol == 0.0:
        np.testing.assert_array_equal(got[-1], eager)
        np.testing.assert_array_equal(got, vmapped)
    else:
        np.testing.assert_allclose(got[-1], eager, rtol=0, atol=tol)
        np.testing.assert_allclose(got, vmapped, rtol=0, atol=tol)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=max(tol, ULP1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", BIT_EQUAL, ids=_id)
def test_bit_equal_ops_match_jax(case, shape):
    _check(*case, shape, 0.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", LIBM, ids=_id)
def test_libm_and_sharpness_match_jax_within_1e6(case, shape):
    _check(*case, shape, 1e-6)


@pytest.mark.parametrize("op", ["normalize", "rescale_intensity",
                                "equalize_hist", "equalize"])
def test_per_image_statistics(op):
    """Each image of a batch comes out as it does alone."""
    x = torch.from_numpy(_batch((3, 64, 96), seed=4))
    got = T_OPS[op](x)
    for i in range(3):
        assert torch.equal(got[i], T_OPS[op](x[i]))


def test_equalize_hist_matches_golden(xray):
    got = TH.equalize_hist(torch.from_numpy(xray)).numpy()
    np.testing.assert_allclose(got, G.equalize_hist(xray), atol=2e-5)


@pytest.mark.parametrize("nbins", [2, 64, 300])
def test_equalize_hist_nbins_matches_golden(rng, nbins):
    x = rng.random((67, 93)).astype(np.float32) ** 2
    got = TH.equalize_hist(torch.from_numpy(x), nbins=nbins).numpy()
    np.testing.assert_allclose(got, G.equalize_hist(x, nbins), atol=2e-5)


def test_equalize_hist_rejects_one_bin():
    with pytest.raises(ValueError, match="nbins"):
        TH.equalize_hist(torch.zeros((4, 4)), nbins=1)


def test_equalize_hist_constant_image():
    """A constant image has a zero span: every pixel maps to 1, as in
    skimage and the reference (tests/test_histogram.py)."""
    img = torch.full((2, 64, 64), 0.5)
    got = TH.equalize_hist(img).numpy()
    ref = np.asarray(JH.equalize_hist(jnp.full((64, 64), 0.5, jnp.float32)))
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_allclose(got, 1.0, atol=1e-5)


@pytest.mark.parametrize("image", ["xray", "skewed", "two_levels", "constant"])
def test_equalize_matches_pil_golden(xray, rng, image):
    x = {"xray": xray,
         "skewed": rng.random((67, 93)).astype(np.float32) ** 4,
         "two_levels": np.where(rng.random((64, 96)) < 0.3, 0.2,
                                0.8).astype(np.float32),
         "constant": np.full((32, 32), 0.4, np.float32)}[image]
    got = TH.equalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.rint(got * 255).astype(int),
                                  np.rint(G.equalize_pil(x) * 255).astype(int))


def test_rescale_intensity_constant_image_stays_finite():
    got = TI.rescale_intensity(torch.full((2, 8, 8), 0.3)).numpy()
    ref = np.asarray(JI.rescale_intensity(jnp.full((8, 8), 0.3, jnp.float32)))
    np.testing.assert_array_equal(got[1], ref)


def test_posterize_rejects_bits_out_of_range():
    for bits in (0, 9):
        with pytest.raises(ValueError, match="bits"):
            TI.posterize(torch.zeros((2, 2)), bits)


def test_registry_and_rules_cover_the_new_ops():
    """The port's registry has each op under the reference's name with the
    reference's signature, and its value rules refuse what the
    reference's refuse, with the same message."""
    from mies_tpu.pipeline.config import validate as j_validate
    from mies_tpu_torch.pipeline.config import PipelineConfig, validate

    bad = [("adjust_gamma", {"gamma": 0}), ("adjust_log", {"gain": -1}),
           ("adjust_sigmoid", {"cutoff": "x"}),
           ("adjust_brightness", {"factor": None}),
           ("adjust_contrast", {"factor": -0.5}),
           ("solarize", {"threshold": 1.5}), ("posterize", {"bits": 9}),
           ("sharpness", {"factor": "y"}), ("normalize", {"eps": 0}),
           ("rescale_intensity", {"in_range": (0.1,)}),
           ("rescale_intensity", {"out_range": None}),
           ("equalize_hist", {"nbins": 1}), ("invert", {"gain": 2.0}),
           ("equalize", {"nbins": 256})]
    import inspect

    for op, _ in BIT_EQUAL + LIBM:
        assert list(inspect.signature(T_OPS[op]).parameters) == list(
            inspect.signature(J_OPS[op]).parameters), op
    for op, kw in bad:
        with pytest.raises(ValueError) as want:
            j_validate(JConfig.make([(op, kw)]))
        with pytest.raises(ValueError) as got:
            validate(PipelineConfig.make([(op, kw)]))
        assert str(got.value) == str(want.value).replace(
            "mies_tpu.ops", "mies_tpu_torch.ops"), op
