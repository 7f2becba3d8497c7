"""mies_tpu_torch.ops (plain PyTorch) against the JAX package and cv2, on CPU.

The same seeded numpy inputs go through the JAX op and its port. The
tolerances are the reference's own contracts: OpenCV-convention CLAHE is
bit-exact against cv2 (eager torch does not contract multiply-adds into
FMAs, so the port needs no CPU allowance); against JAX on XLA:CPU, which
does contract them, the cv2 CPU rule of tests/test_clahe.py applies
(<= 1 level on < 1e-3 of pixels); the bilateral twin holds atol 2e-6
(tests/test_kernels.py) and the unsharp mask atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.ops import filters as JF
from mies_tpu.ops import histogram as JH
from mies_tpu.pipeline.compiler import _quantize_u8 as _j_quantize_u8
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.pipeline.compiler import _quantize_u8 as _t_quantize_u8

torch.set_num_threads(2)


def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def _assert_levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """<= 1 uint8 level on < 0.1% of pixels (XLA:CPU FMA rounding ties)."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1, f"max level diff {d.max()}"
    assert (d > 0).mean() < 1e-3, f"mismatch frac {(d > 0).mean()}"


def _clahe_input(case, xray, rng) -> np.ndarray:
    if case == "ragged":
        return rng.random((251, 333)).astype(np.float32)
    return xray


@pytest.mark.parametrize(
    "case,clip", [("512", 2.0), ("512", 40.0), ("ragged", 2.0)]
)
def test_clahe_plain_equals_cv2(xray, rng, case, clip):
    import cv2

    u8 = _u8(_clahe_input(case, xray, rng))
    ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(u8)
    out = TH.clahe(torch.from_numpy(u8.astype(np.float32) / 255.0), clip, (8, 8))
    np.testing.assert_array_equal(_u8(out.numpy()), ref)


@pytest.mark.parametrize("case", ["512", "ragged"])
def test_clahe_plain_matches_jax(xray, rng, case):
    img = _clahe_input(case, xray, rng)
    ref = np.asarray(JH.clahe(jnp.asarray(img), clip_limit=2.0,
                              grid_size=(8, 8), convention="opencv"))
    out = TH.clahe(torch.from_numpy(img), 2.0, (8, 8)).numpy()
    # levels, not floats: XLA:CPU multiplies by the f32 reciprocal of 255
    # where the port divides, a 1-ulp difference on the same level
    _assert_levels_close(_u8(out), _u8(ref))


def test_clahe_batch_dims_match_per_slice(rng):
    imgs = rng.random((3, 64, 80)).astype(np.float32)
    batched = TH.clahe(torch.from_numpy(imgs), 3.0, (4, 4))
    for i in range(3):
        single = TH.clahe(torch.from_numpy(imgs[i]), 3.0, (4, 4))
        assert torch.equal(batched[i], single)


@pytest.mark.parametrize("convention,nbins,exc,match", [
    ("nope", 256, ValueError, "unknown CLAHE convention"),
    ("opencv", 128, NotImplementedError, "only the skimage convention"),
    ("skimage", 1, ValueError, "nbins must be >= 2"),
])
def test_clahe_argument_errors_match_jax(convention, nbins, exc, match):
    """Every convention is ported; the reference's own argument rules
    remain, with the same exception in both packages."""
    with pytest.raises(exc, match=match):
        JH.clahe(jnp.zeros((16, 16), jnp.float32), convention=convention,
                 nbins=nbins)
    with pytest.raises(exc, match=match):
        TH.clahe(torch.zeros(16, 16), convention=convention, nbins=nbins)


@pytest.mark.parametrize("clip_value", [1.0, 8.0, 32.0, 100.0])
def test_clip_redistribute_opencv_equals_jax(rng, clip_value):
    hist = rng.integers(0, 120, (16, 256)).astype(np.float32)
    hist[3] = 0
    hist[3, 17] = 4096  # one tile with all its mass in one bin
    ref = np.asarray(JH._clip_redistribute_opencv(
        jnp.asarray(hist), jnp.float32(clip_value)))
    out = TH._clip_redistribute_opencv(torch.from_numpy(hist), clip_value)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_tile_histograms_count_every_pixel(rng):
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 64, 96)).astype(np.int32))
    hists = TH._tile_histograms(u8, (4, 2))
    assert hists.shape == (2, 8, 256)
    np.testing.assert_array_equal(hists.sum(-1).numpy(), 16 * 48)
    tile = u8[1, 16:32, 48:96].numpy().ravel()  # tile (1, 1) of slice 1
    np.testing.assert_array_equal(hists[1, 3].numpy(),
                                  np.bincount(tile, minlength=256))


@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest"])
@pytest.mark.parametrize("k", [3, 5, 9])
def test_bilateral_plain_matches_jax(rng, mode, k):
    imgs = rng.random((2, 64, 96)).astype(np.float32)
    ref = np.asarray(jax.vmap(
        lambda x: JF.bilateral_blur(x, k, 0.1, 1.5, mode))(jnp.asarray(imgs)))
    out = TF.bilateral_blur(torch.from_numpy(imgs), k, 0.1, 1.5, mode).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize(
    "mode,np_mode",
    [("reflect", "symmetric"), ("mirror", "reflect"), ("nearest", "edge"),
     ("wrap", "wrap"), ("constant", "constant")],
)
def test_border_equals_np_pad(rng, mode, np_mode):
    """scipy 'reflect' is numpy 'symmetric' — which torch's F.pad lacks —
    so the port builds borders by np.pad index arithmetic."""
    img = rng.random((5, 7)).astype(np.float32)
    for r in (1, 3, 9):  # 9 > both sides: repeated reflections
        out = TF._pad2d(torch.from_numpy(img), r, r, mode).numpy()
        np.testing.assert_array_equal(out, np.pad(img, r, mode=np_mode))


@pytest.mark.parametrize("sigma,radius", [(1.5, 6), (1.0, 4), (3.0, 12)])
def test_gaussian_taps_identical(sigma, radius):
    np.testing.assert_array_equal(TF.gaussian_kernel1d(sigma, radius),
                                  JF.gaussian_kernel1d(sigma, radius))


@pytest.mark.parametrize("mode", ["nearest", "reflect", "mirror", "wrap",
                                  "constant"])
def test_gaussian_blur_matches_jax(rng, mode):
    img = rng.random((48, 80)).astype(np.float32)
    ref = np.asarray(JF.gaussian_blur(jnp.asarray(img), 1.5, mode=mode))
    out = TF.gaussian_blur(torch.from_numpy(img), 1.5, mode=mode).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_unsharp_mask_matches_jax(rng):
    imgs = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(jax.vmap(
        lambda x: JF.unsharp_mask(x, 1.5, 1.0))(jnp.asarray(imgs)))
    out = TF.unsharp_mask(torch.from_numpy(imgs), 1.5, 1.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    _assert_levels_close(_t_quantize_u8(out).numpy(),
                         np.asarray(_j_quantize_u8(jnp.asarray(ref))))
