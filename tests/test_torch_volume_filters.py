"""The volume program's 3-D filters, morphology and resample against the
JAX package on the CPU.

The same seeded numpy volumes ([8, 24, 32] and the ragged [7, 23, 31])
go through each op of ``mies_tpu_torch.ops.volume3d`` and its reference in
``mies_tpu.ops.volume3d``, run op by op (``jax.disable_jit()``). The
morphology ops and the median are min/max only, and the box, Gaussian,
unsharp and difference-of-Gaussians passes keep the reference's shifted-add
tap order, so every one of them is held bit-equal. ``resample3d`` is three
float32 products whose summation order is the library's: within 1e-6 of
the reference and of scipy.ndimage.map_coordinates(order=1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from mies_tpu.ops import filters as JF
from mies_tpu.ops import volume3d as JV
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import volume3d as TV
from mies_tpu_torch.pipeline import compiler as TC
from mies_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(2)

SHAPES = [(8, 24, 32), (7, 23, 31)]


def _volume(shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]].astype(np.float32)
    smooth = 0.5 + 0.3 * np.sin(y / 4) * np.cos(x / 5) * np.cos(z / 3)
    v = 0.6 * smooth + 0.4 * rng.random(shape, dtype=np.float32)
    return np.clip(v, 0.0, 1.0).astype(np.float32)


def _both(op, vol, kw):
    with jax.disable_jit():
        want = np.asarray(getattr(JV, op)(jnp.asarray(vol), **kw))
    got = getattr(TV, op)(torch.from_numpy(vol), **kw).numpy()
    return got, want


EVEN, RAGGED = SHAPES
# (op, params, shape): every op at both shapes; the variants whose
# reference, run op by op, compiles many small passes on one shape only
BIT_EQUAL = [
    ("guided_blur3d", {}, EVEN),
    ("guided_blur3d", {"kernel_size": 5, "eps": 0.05, "mode": "nearest"},
     RAGGED),
    ("median_blur3d", {}, EVEN),
    ("median_blur3d", {}, RAGGED),
    ("median_blur3d", {"kernel_size": 5, "mode": "reflect"}, RAGGED),
    ("unsharp_mask3d", {"radius": 1.0, "amount": 0.5}, EVEN),
    ("unsharp_mask3d", {"radius": 0.8, "amount": 2.0, "clip": False,
                        "mode": "mirror"}, RAGGED),
    ("difference_of_gaussians3d", {"low_sigma": 0.6}, EVEN),
    ("difference_of_gaussians3d", {"low_sigma": 0.5, "high_sigma": 0.9,
                                   "mode": "reflect"}, RAGGED),
    *[(op, kw, shape) for shape in SHAPES for op, kw in (
        ("erode3d", {}),
        ("dilate3d", {"mode": "nearest"}),
        ("morph_open3d", {"kernel_size": 5}),
        ("morph_close3d", {"mode": "constant"}),
        ("morph_gradient3d", {}),
        ("top_hat3d", {"kernel_size": 5}),
        ("black_hat3d", {"mode": "reflect"}),
    )],
]


@pytest.mark.parametrize("op,kw,shape", BIT_EQUAL, ids=[
    f"{o}{sorted(k.items())}-{s}" for o, k, s in BIT_EQUAL])
def test_filter_bit_equals_the_eager_reference(op, kw, shape):
    got, want = _both(op, _volume(shape), kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_median3d_cut_network_equals_the_full_network():
    """126 comparators of the 27-wire Batcher network reach the middle
    wire; the cut network's output equals the full network's (the
    reference's) on the same 27 shifted views."""
    assert len(TF._median_network(27)) == 126
    assert len(JF._batcher_network(27)) > 126
    vol = torch.from_numpy(_volume((6, 20, 22), seed=3))
    p = vol
    for axis in (-3, -2, -1):
        p = TF._pad_axis(p, 1, axis, "nearest")
    vals = [p[a:a + 6, b:b + 20, c:c + 22]
            for a in range(3) for b in range(3) for c in range(3)]
    for i, j in JF._batcher_network(27):
        vals[i], vals[j] = torch.minimum(vals[i], vals[j]), torch.maximum(
            vals[i], vals[j])
    torch.testing.assert_close(TV.median_blur3d(vol), vals[13], rtol=0, atol=0)
    np.testing.assert_array_equal(
        TV.median_blur3d(vol).numpy(),
        ndi.median_filter(vol.numpy(), size=3, mode="nearest"))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("out_shape", [(11, 17, 40), (4, 23, 9), (1, 1, 5)],
                         ids=str)
def test_resample3d_within_1e6_of_the_reference_and_scipy(shape, out_shape):
    vol = _volume(shape)
    d, h, w = out_shape
    got, want = _both("resample3d", vol, {"depth": d, "height": h, "width": w})
    assert got.shape == out_shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    coords = []
    for n_in, n_out in zip(shape, out_shape):
        coords.append(np.full(1, 0.5 * (n_in - 1)) if n_out == 1 else
                      np.arange(n_out) * (n_in - 1) / (n_out - 1))
    grid = np.meshgrid(*coords, indexing="ij")
    ref = ndi.map_coordinates(vol.astype(np.float64), grid, order=1)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_resample3d_same_shape_is_the_float_volume_and_int16_casts():
    hu = np.random.default_rng(2).integers(-1000, 2000, (5, 9, 11),
                                           dtype=np.int16)
    same = TV.resample3d(torch.from_numpy(hu), 5, 9, 11)
    assert same.dtype == torch.float32
    np.testing.assert_array_equal(same.numpy(), hu.astype(np.float32))
    got = TV.resample3d(torch.from_numpy(hu), 9, 9, 11).numpy()
    np.testing.assert_allclose(got[::2], hu, atol=0, rtol=0)
    with pytest.raises(ValueError, match="depth must be >= 1"):
        TV.resample3d(torch.from_numpy(hu), 0, 9, 11)


def test_volume_pipeline_resample3d_changes_the_shape():
    """The program's output takes the resampled shape (uint8 out)."""
    vol = _volume((8, 24, 32))
    cfg = PipelineConfig.make([("resample3d", {"depth": 12, "height": 20,
                                               "width": 40}),
                               ("median_blur3d", {})])
    out = TC.compile_volume_pipeline(cfg, device="cpu")(vol)
    assert out.shape == (12, 20, 40) and out.dtype == torch.uint8


@pytest.mark.parametrize("op", ["guided_blur3d", "median_blur3d",
                                "erode3d", "resample3d"])
def test_volume_op_refuses_a_slice(op):
    kw = {"depth": 2, "height": 2, "width": 2} if op == "resample3d" else {}
    with pytest.raises(ValueError, match=r"\[Z, H, W\]"):
        getattr(TV, op)(torch.zeros(4, 4), **kw)


@pytest.mark.parametrize("op", ["guided_blur3d", "median_blur3d",
                                "erode3d"])
def test_even_kernel_is_refused(op):
    with pytest.raises(ValueError, match="kernel_size must be odd"):
        getattr(TV, op)(torch.zeros(4, 4, 4), kernel_size=4)
