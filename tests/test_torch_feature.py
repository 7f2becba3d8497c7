"""The port's Canny (``mies_tpu_torch.ops.feature``) against the JAX
package on the CPU, on seeded [2, 64, 96] and [2, 67, 93] batches.

* canny's {0, 1} output equal to ``jax.jit(jax.vmap(canny))`` (the
  reference compiler's program) and to the eager op, at the default
  thresholds, other sigmas and borders, and at quantile thresholds;
* the per-slice quantiles equal to ``jnp.quantile`` (linear) bit for bit;
* hysteresis along a weak path snaking over the slice, reached from its
  one strong pixel only after over a thousand dilation steps (many times
  ``HYSTERESIS_CHECK_EVERY``), equal to the reference's ``_hysteresis``;
  checking every step and every 16 steps gives the same mask, and the
  step count is a multiple of the check interval;
* against ``tests/goldens/golden_ops.py::canny_edges`` (scipy's
  label-based hysteresis), as the reference's tests/test_feature.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.goldens.golden_ops as G
from mies_tpu.ops import feature as JFT
from mies_tpu_torch.ops import feature as TFT
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(2)

SHAPES = [(2, 64, 96), (2, 67, 93)]


def _scene(shape, seed=3) -> np.ndarray:
    """Blobs and steps of several contrasts with noise."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    imgs = []
    for i in range(b):
        img = 0.3 + 0.25 * (((y - h / 2) ** 2 + (x - w / 3) ** 2) < (12 + 3 * i) ** 2)
        img = img + 0.15 * (x > 2 * w // 3) + 0.1 * (y > h // 4 + i)
        imgs.append(img + 0.03 * rng.standard_normal((h, w)))
    return np.clip(np.stack(imgs), 0, 1).astype(np.float32)


def _serpentine(shape) -> tuple[np.ndarray, np.ndarray]:
    """(strong, weak) masks. Slice 0: a weak path snaking over every 4th
    row, joined at alternate ends, with one strong pixel at its start, so
    hysteresis must walk the whole path (over a thousand steps). Slice 1:
    a short weak segment beside a strong pixel and an unconnected one."""
    b, h, w = shape
    weak = np.zeros(shape, bool)
    strong = np.zeros(shape, bool)
    rows = list(range(1, h - 1, 4))
    for i, r in enumerate(rows):
        weak[0, r, 1:w - 1] = True
        if i + 1 < len(rows):
            c = w - 2 if i % 2 == 0 else 1
            weak[0, r:rows[i + 1] + 1, c] = True
    strong[0, 1, 1] = True
    weak[1, 10, 5:30] = True
    weak[1, 20, 5:30] = True
    strong[1, 10, 5] = True
    return strong & weak, weak


KWS = [
    {},
    {"sigma": 2.0, "mode": "reflect"},
    {"sigma": 0.7, "low_threshold": 0.05, "high_threshold": 0.3,
     "mode": "nearest"},
    {"use_quantiles": True, "low_threshold": 0.8, "high_threshold": 0.95},
    {"sigma": 1.5, "use_quantiles": True, "low_threshold": 0.5,
     "high_threshold": 0.9},
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", KWS)
def test_canny_equals_the_reference(shape, kw):
    x = _scene(shape)
    got = TFT.canny(torch.from_numpy(x), **kw).numpy()
    f = jax.vmap(functools.partial(JFT.canny, **kw))
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(jax.jit(f)(jnp.asarray(x))))
    assert got.sum() > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_canny_equals_the_eager_op(shape):
    x = _scene(shape, seed=5)
    got = TFT.canny(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(JFT.canny)(jnp.asarray(x))))


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.8, 0.95, 1.0])
def test_quantiles_equal_jnp_quantile(q):
    rng = np.random.default_rng(11)
    x = (rng.random((3, 67, 93)) ** 3).astype(np.float32)
    got = TFT.quantile_slices(torch.from_numpy(x), q).numpy()[:, 0, 0]
    want = np.array([np.asarray(jnp.quantile(jnp.asarray(s), q)) for s in x])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_hysteresis_walks_a_long_weak_path(shape):
    from mies_tpu.ops.feature import _hysteresis

    strong, weak = _serpentine(shape)
    got, steps = TFT.hysteresis(torch.from_numpy(strong),
                                torch.from_numpy(weak))
    want = np.asarray(jax.jit(jax.vmap(_hysteresis))(jnp.asarray(strong),
                                                     jnp.asarray(weak)))
    np.testing.assert_array_equal(got.numpy(), want)
    every = TFT.HYSTERESIS_CHECK_EVERY
    assert steps > 50 * every and steps % every == 0
    assert got[0].sum().item() == weak[0].sum() and got[1].sum().item() == 25
    # one check a step: the same fixpoint, its last step the one that
    # found no change; the batched checks overshoot by less than 2 checks
    one, steps1 = TFT.hysteresis(torch.from_numpy(strong),
                                 torch.from_numpy(weak), every=1)
    assert torch.equal(one, got) and steps1 <= steps < steps1 + 2 * every


def test_canny_through_compile_pipeline_and_the_golden():
    x = _scene((2, 64, 96), seed=9)
    cfg = PipelineConfig.make([("canny", {"sigma": 1.0})])
    out = compile_pipeline(cfg, batched=True, device="cpu")(x).numpy()
    assert out.dtype == np.uint8 and set(np.unique(out)) <= {0, 255}
    for i in range(2):
        np.testing.assert_array_equal(out[i] // 255,
                                      G.canny_edges(x[i]).astype(np.uint8))


@pytest.mark.parametrize("kw,match", [
    ({"use_quantiles": True, "low_threshold": 0.5, "high_threshold": 1.5},
     "quantile thresholds"),
    ({"low_threshold": 0.3, "high_threshold": 0.2}, "must be <=")])
def test_bad_thresholds_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        TFT.canny(torch.zeros(1, 8, 8), **kw)
