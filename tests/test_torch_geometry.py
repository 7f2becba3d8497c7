"""The port's geometry ops (``mies_tpu_torch.ops.geometry``) against the
JAX package on the CPU, on seeded [2, 64, 96] and [2, 67, 93] batches.

* resize in its five methods, up and down, antialias on and off, against
  ``jax.image.resize`` (jitted, as the library runs it): within 4e-6. The
  weights are built on the host with the fused multiply-adds of XLA:CPU's
  vectorized loop; its scalar tail (the last n % 8 columns here) rounds
  the sample positions separately, an ulp of a position of up to 150
  apart, and the two float32 products sum in another order than XLA's
  dot. 'nearest' bit-equal.
* flip, rot90, center_crop (smaller, larger and mixed) bit-equal.
* rotate, affine_warp, perspective_warp (constant and nearest):
  bit-equal to the eager JAX op and within 3e-7 of its jitted form
  (XLA:CPU contracts the blends into FMAs); rotate by multiples of 90
  degrees, square and not, bit-equal.
* The warps at width 1 and height 1, where the reference's row-pair
  gather fails: the sampler against ``scipy.ndimage.map_coordinates``
  (order 1) at the same float32 coordinates, within 1e-6.
* The shape changers through the volume drivers: ``enhance_volume``
  (non-square rot90, an enlarging center_crop, resize) equal to the
  reference's, and ``enhance_volume_stream`` refusing each of them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from mies_tpu.ops import geometry as JG
from mies_tpu_torch.ops import geometry as TG

torch.set_num_threads(2)

SHAPES = [(2, 64, 96), (2, 67, 93)]
METHODS = ["nearest", "bilinear", "bicubic", "lanczos3", "lanczos5"]


def _batch(shape, seed=7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    smooth = 0.5 + 0.3 * np.sin(x / 7.0) * np.cos(y / 5.0)
    return np.clip(smooth + 0.1 * rng.standard_normal((b, h, w)), 0,
                   1).astype(np.float32)


def _eager(fn, x, **kw) -> np.ndarray:
    return np.asarray(jax.vmap(functools.partial(fn, **kw))(jnp.asarray(x)))


def _jit(fn, x, **kw) -> np.ndarray:
    return np.asarray(jax.jit(jax.vmap(functools.partial(fn, **kw)))(
        jnp.asarray(x)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("size", [(40, 52), (101, 150)], ids=["down", "up"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax_image_resize(shape, size, antialias, method):
    x = _batch(shape)
    got = TG.resize(torch.from_numpy(x), *size, method, antialias).numpy()
    want = np.stack([np.asarray(jax.image.resize(
        jnp.asarray(s), size, method=method, antialias=antialias))
        for s in x])
    assert got.shape == want.shape == (shape[0], *size)
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


@pytest.mark.parametrize("size", [(64, 50), (30, 96), (64, 96)])
def test_resize_one_axis_or_none(size):
    """An axis that keeps its size is not resampled (jax skips it)."""
    x = _batch((2, 64, 96))
    got = TG.resize(torch.from_numpy(x), *size, "lanczos3").numpy()
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(s), size,
                                                 "lanczos3")) for s in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_resize_weights_equal_the_jitted_library():
    """The host weight matrix against jax's compute_weight_mat as jit
    compiles it, at output sizes that XLA:CPU's vector loop covers whole
    (a multiple of 8: no scalar tail)."""
    from jax._src.image import scale as S

    for m, n, method, kern in [
            (67, 104, "bilinear", S._fill_triangle_kernel),
            (93, 152, "bicubic", S._fill_keys_cubic_kernel),
            (96, 40, "lanczos3", lambda x: S._fill_lanczos_kernel(3.0, x))]:
        ref = np.asarray(jax.jit(lambda: S.compute_weight_mat(
            m, n, n / m, 0.0, kern, True))())
        np.testing.assert_allclose(TG.resize_weights(m, n, method, True), ref,
                                   rtol=0, atol=2e-7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,kw", [
    ("flip", {}), ("flip", {"horizontal": False, "vertical": True}),
    ("flip", {"horizontal": True, "vertical": True}),
    ("rot90", {}), ("rot90", {"k": 2}), ("rot90", {"k": 3}), ("rot90", {"k": -1}),
    ("center_crop", {"height": 40, "width": 50}),
    ("center_crop", {"height": 80, "width": 101}),
    ("center_crop", {"height": 30, "width": 120})])
def test_flip_rot90_crop_bit_equal(shape, op, kw):
    x = _batch(shape)
    got = getattr(TG, op)(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, _eager(getattr(JG, op), x, **kw))


WARPS = [
    ("rotate", {"angle": 7.0}),
    ("rotate", {"angle": -33.0, "mode": "nearest"}),
    ("rotate", {"angle": 12.5, "cval": 0.25}),
    ("affine_warp", {"matrix": [[1.1, 0.1], [-0.05, 0.9]],
                     "offset": [2.0, -3.0]}),
    ("affine_warp", {"matrix": [[0.8, -0.2], [0.3, 1.2]],
                     "offset": [-4.0, 6.5], "mode": "nearest"}),
    ("perspective_warp", {"matrix": [[1.0, 0.05, 1.0], [0.02, 1.0, -2.0],
                                     [0.001, 0.0005, 1.0]]}),
    ("perspective_warp", {"matrix": [[0.9, 0.0, 3.0], [0.1, 1.1, 0.0],
                                     [-0.002, 0.001, 1.0]],
                          "mode": "nearest", "cval": 0.5}),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op,kw", WARPS)
def test_warps_bit_equal_to_the_eager_op(shape, op, kw):
    x = _batch(shape)
    got = getattr(TG, op)(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, _eager(getattr(JG, op), x, **kw))
    np.testing.assert_allclose(got, _jit(getattr(JG, op), x, **kw), rtol=0,
                               atol=3e-7)


@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 67, 93), (2, 40, 40),
                                   (1, 31, 48)])
@pytest.mark.parametrize("angle", [90.0, 180.0, 270.0, -90.0])
@pytest.mark.parametrize("mode", ["constant", "nearest"])
def test_rotate_by_right_angles(shape, angle, mode):
    x = _batch(shape)
    got = TG.rotate(torch.from_numpy(x), angle, mode, 0.3).numpy()
    np.testing.assert_array_equal(
        got, _eager(JG.rotate, x, angle=angle, mode=mode, cval=0.3))


@pytest.mark.parametrize("shape", [(2, 17, 1), (2, 1, 23), (1, 1, 1)])
@pytest.mark.parametrize("mode", ["constant", "nearest"])
@pytest.mark.parametrize("op,kw", [
    ("affine_warp", {"matrix": [[0.9, 0.0], [0.0, 1.0]], "offset": [0.6, 0.0]}),
    ("affine_warp", {"matrix": [[1.0, 0.3], [0.2, 0.7]], "offset": [-0.4, 0.1]}),
    ("rotate", {"angle": 15.0}),
    ("perspective_warp", {"matrix": [[1.0, 0.0, 0.5], [0.0, 1.0, 0.0],
                                     [0.01, 0.0, 1.0]]}),
])
def test_warps_at_width_and_height_one(shape, mode, op, kw):
    """The reference gathers row pairs at clip(x0, 0, w - 2), which fails at
    width 1; the port's point gathers hold scipy's order-1 sampling at the
    same float32 coordinates."""
    x = _batch(shape)
    b, h, w = shape
    got = getattr(TG, op)(torch.from_numpy(x), mode=mode, cval=0.4, **kw)
    assert tuple(got.shape) == shape and bool(torch.isfinite(got).all())
    iy, ix = _coords(op, kw, h, w)
    for i in range(b):
        want = ndimage.map_coordinates(
            x[i].astype(np.float64), [iy.astype(np.float64),
                                      ix.astype(np.float64)],
            order=1, mode=mode, cval=0.4)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-6)


def _coords(op, kw, h, w):
    """The float32 coordinates (iy, ix) that ``op`` samples at, by the
    port's own host arithmetic."""
    if op == "rotate":
        a = np.deg2rad(kw["angle"])
        c, s = np.cos(a), np.sin(a)
        m = np.array([[c, s], [-s, c]])
        center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
        op, kw = "affine_warp", {"matrix": m, "offset": center - m @ center}
    oy = np.arange(h, dtype=np.float64)
    ox = np.arange(w, dtype=np.float64)
    m = np.asarray(kw["matrix"], np.float64)
    if op == "affine_warp":
        off = np.asarray(kw["offset"], np.float64)
        iy = ((m[0, 0] * oy + off[0]).astype(np.float32)[:, None]
              + (m[0, 1] * ox).astype(np.float32)[None, :])
        ix = ((m[1, 0] * oy + off[1]).astype(np.float32)[:, None]
              + (m[1, 1] * ox).astype(np.float32)[None, :])
        return iy, ix

    def terms(r):
        return ((m[r, 0] * oy + m[r, 2]).astype(np.float32)[:, None]
                + (m[r, 1] * ox).astype(np.float32)[None, :])

    return terms(0) / terms(2), terms(1) / terms(2)


# --- the shape changers through the volume drivers ------------------------

@pytest.mark.parametrize("stage", [
    ("rot90", {"k": 1}), ("center_crop", {"height": 40, "width": 56}),
    ("resize", {"height": 20, "width": 30, "method": "bicubic"})])
def test_volume_drivers_size_the_shape_changers(tmp_path, stage):
    """enhance_volume writes the changed slice shape, equal to the
    reference's; enhance_volume_stream, whose header is sized from the
    input, refuses the stage by name."""
    import mies_tpu
    from mies_tpu.pipeline import runner as jrunner
    from mies_tpu_torch.io.volume import save_volume
    from mies_tpu_torch.pipeline import runner
    from mies_tpu_torch.pipeline.config import PipelineConfig

    vol = _batch((6, 24, 40))
    cfg = PipelineConfig.make([("gaussian_blur", {"sigma": 1.0}), stage])
    got = runner.enhance_volume(vol, cfg, slab_size=4, device="cpu")
    want = jrunner.enhance_volume(vol, mies_tpu.PipelineConfig.make(
        [("gaussian_blur", {"sigma": 1.0}), stage]), slab_size=4)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    save_volume(tmp_path / "v.npy", (vol * 1000).astype(np.int16))
    with pytest.raises(ValueError, match=f"shape-changing stages.*{stage[0]}"):
        runner.enhance_volume_stream(tmp_path / "v.npy", cfg,
                                     tmp_path / "o.npy", device="cpu")


@pytest.mark.parametrize("mode", ["constant", "nearest"])
def test_perspective_warp_against_the_golden(mode):
    """scipy's geometric_transform with the homography, at the reference's
    own bound (tests/test_intensity.py)."""
    import tests.goldens.golden_ops as G

    img = _batch((1, 64, 80))[0]
    m = ((0.95, 0.08, 2.3), (-0.05, 1.02, -1.6), (0.0004, -0.0003, 1.0))
    got = TG.perspective_warp(torch.from_numpy(img), m, mode, 0.25).numpy()
    np.testing.assert_allclose(got, G.perspective_warp(img, m, mode, 0.25),
                               atol=2e-5)
