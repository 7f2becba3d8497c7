"""The port's neighbourhood ops of this slice, against the JAX package and
cv2, on CPU: morphology (``mies_tpu_torch.ops.morphology``), median_blur
and guided_blur (``mies_tpu_torch.ops.filters``).

The same seeded numpy batch (images of different ranges) goes through the
port's op and ``jax.vmap`` of the JAX op, the reference compiler's
binding (run eagerly: min, max and the median are exact in any order, so
the JIT changes nothing there). Tolerances:

* bit-equal: the seven morphology ops (rect, ellipse, cross x k 1, 3, 7,
  9, 15, 31 x 'ignore' and 'nearest'), structuring_element,
  median_blur (k 1, 3, 5, 7 x every border mode);
* <= 1e-6 abs: guided_blur (k 3, 5 x eps 1e-3, 1e-2, self-guided and with
  a guide), jitted by the reference's binding (XLA:CPU contracts its
  multiply-adds), and bit-equal against the eager JAX op.

Ground truth: erode, dilate, cv2.morphologyEx's five composites and
cv2.getStructuringElement bit-equal; median_blur against cv2.medianBlur
(k 3 and 5 on float32, BORDER_REPLICATE == 'nearest').
"""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.ops import filters as JF
from mies_tpu.ops import morphology as JM
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import morphology as TM

torch.set_num_threads(2)

SHAPES = [(2, 64, 96), (2, 96, 160), (1, 67, 93)]
MORPH_OPS = ["erode", "dilate", "morph_open", "morph_close", "morph_gradient",
             "top_hat", "black_hat"]
CV2_SHAPE = {"rect": cv2.MORPH_RECT, "ellipse": cv2.MORPH_ELLIPSE,
             "cross": cv2.MORPH_CROSS}
CV2_OP = {"morph_open": cv2.MORPH_OPEN, "morph_close": cv2.MORPH_CLOSE,
          "morph_gradient": cv2.MORPH_GRADIENT, "top_hat": cv2.MORPH_TOPHAT,
          "black_hat": cv2.MORPH_BLACKHAT}
PAD_MODES = ["nearest", "reflect", "mirror", "constant", "wrap"]


def _batch(shape, seed=0) -> np.ndarray:
    """Images of different ranges: image i spans [lo_i, lo_i + span_i)."""
    rng = np.random.default_rng(seed)
    b = shape[0]
    lo = np.array([0.0, 0.4, 0.1])[:b, None, None]
    span = np.array([1.0, 0.3, 0.6])[:b, None, None]
    return (lo + span * rng.random(shape)).astype(np.float32)


def _vmapped(fn, x, **kw) -> np.ndarray:
    return np.asarray(jax.vmap(functools.partial(fn, **kw))(jnp.asarray(x)))


def _in_turn(cases):
    """Each case with the next of the input shapes, in turn (a case runs
    its JAX side eagerly, up to seconds, so not every case on every
    shape)."""
    return [(*c, SHAPES[i % len(SHAPES)]) for i, c in enumerate(cases)]


@pytest.mark.parametrize("se,k,mode,shape", _in_turn(
    [(se, k, mode) for se in ("rect", "ellipse", "cross")
     for k in (1, 3, 7, 9, 15, 31) for mode in ("ignore", "nearest")]))
def test_morphology_matches_jax(se, k, mode, shape):
    """All seven ops, bit for bit."""
    x = _batch(shape)
    t = torch.from_numpy(x)
    for op in MORPH_OPS:
        got = getattr(TM, op)(t, k, se, mode).numpy()
        want = _vmapped(getattr(JM, op), x, kernel_size=k, shape=se, mode=mode)
        np.testing.assert_array_equal(got, want, err_msg=op)


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 15, 21, 31])
def test_structuring_element_matches_cv2_and_jax(k):
    for name, flag in CV2_SHAPE.items():
        got = np.asarray(TM.structuring_element(k, name), dtype=bool)
        np.testing.assert_array_equal(
            got, cv2.getStructuringElement(flag, (k, k)).astype(bool))
        assert TM.structuring_element(k, name) == JM.structuring_element(k, name)


def test_structuring_element_rejects_bad_args():
    for k, shape in ((2, "rect"), (0, "rect"), (3, "disk")):
        with pytest.raises(ValueError):
            TM.structuring_element(k, shape)


@pytest.mark.parametrize("k", [3, 7, 15])
@pytest.mark.parametrize("se", ["rect", "ellipse", "cross"])
def test_morphology_matches_cv2(xray, se, k):
    """erode / dilate and the five composites equal cv2 under its default
    border ('ignore') and BORDER_REPLICATE ('nearest')."""
    img = xray[:200, :300]
    el = cv2.getStructuringElement(CV2_SHAPE[se], (k, k))
    t = torch.from_numpy(img)
    for mode, border in (("ignore", {}),
                         ("nearest", {"borderType": cv2.BORDER_REPLICATE})):
        np.testing.assert_array_equal(TM.erode(t, k, se, mode).numpy(),
                                      cv2.erode(img, el, **border))
        np.testing.assert_array_equal(TM.dilate(t, k, se, mode).numpy(),
                                      cv2.dilate(img, el, **border))
        for op, flag in CV2_OP.items():
            np.testing.assert_array_equal(
                getattr(TM, op)(t, k, se, mode).numpy(),
                cv2.morphologyEx(img, flag, el, **border), err_msg=op)


@pytest.mark.parametrize("k,mode,shape", _in_turn(
    [(k, mode) for k in (1, 3, 5, 7) for mode in PAD_MODES]))
def test_median_blur_matches_jax(k, mode, shape):
    x = _batch(shape)
    got = TF.median_blur(torch.from_numpy(x), k, mode).numpy()
    np.testing.assert_array_equal(
        got, _vmapped(JF.median_blur, x, kernel_size=k, mode=mode))


@pytest.mark.parametrize("k", [3, 5])
def test_median_blur_matches_cv2(xray, k):
    img = xray[:200, :300]
    got = TF.median_blur(torch.from_numpy(img), k).numpy()
    np.testing.assert_array_equal(got, cv2.medianBlur(img, k))


def test_median_network_selects_the_middle_wire():
    """The cut network returns the median of every permutation-free input
    of 9 and 25 wires (each wire a distinct value), as sorting does."""
    rng = np.random.default_rng(3)
    for k in (3, 5):
        n = k * k
        vals = rng.permutation(np.arange(n * 50, dtype=np.float32).reshape(
            n, 50), axis=0)
        wires = [torch.from_numpy(v) for v in vals]
        for i, j, keep_min, keep_max in TF._median_network(n):
            a, b = wires[i], wires[j]
            if keep_min:
                wires[i] = torch.minimum(a, b)
            if keep_max:
                wires[j] = torch.maximum(a, b)
        np.testing.assert_array_equal(wires[n // 2].numpy(),
                                      np.sort(vals, axis=0)[n // 2])


def test_median_blur_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        TF.median_blur(torch.zeros((8, 8)), 4)


@pytest.mark.parametrize("k,eps,guided,shape", _in_turn(
    [(k, eps, guided) for k in (3, 5) for eps in (1e-3, 1e-2)
     for guided in (False, True)]))
def test_guided_blur_matches_jax(k, eps, guided, shape):
    x = _batch(shape)
    g = _batch(shape, seed=1) if guided else None
    got = TF.guided_blur(torch.from_numpy(x), k, eps,
                         guide=None if g is None else torch.from_numpy(g))
    if g is None:
        def bound(a):
            return JF.guided_blur(a, k, eps)
        args = (jnp.asarray(x),)
        eager = JF.guided_blur(jnp.asarray(x[-1]), k, eps)
    else:
        def bound(a, b):
            return JF.guided_blur(a, k, eps, guide=b)
        args = (jnp.asarray(x), jnp.asarray(g))
        eager = JF.guided_blur(jnp.asarray(x[-1]), k, eps,
                               guide=jnp.asarray(g[-1]))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(eager))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.jit(jax.vmap(bound))(*args)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["reflect", "nearest", "wrap"])
def test_guided_blur_modes_match_jax(mode):
    x = _batch((2, 64, 96))
    got = TF.guided_blur(torch.from_numpy(x), 5, 1e-3, mode).numpy()
    np.testing.assert_array_equal(
        got, _vmapped(JF.guided_blur, x, kernel_size=5, eps=1e-3, mode=mode))


def test_guided_blur_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        TF.guided_blur(torch.zeros((8, 8)), 4)
