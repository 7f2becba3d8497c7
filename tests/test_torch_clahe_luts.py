"""K1 ending in the OpenCV LUTs (``kernels.clahe.tile_luts``) on the CPU.

On a CPU tensor ``tile_luts`` runs its plain version (K1's counts, then
``ops.histogram._luts_opencv``); on the card the kernel counts and builds
the LUTs in one launch. Both are held to the JAX package's LUTs exactly,
built as ``mies_tpu.kernels.clahe.clahe_tpu`` builds them: the Pallas row
histogram in interpret mode (``quantize_input=True``), then
``_clip_redistribute_opencv``, ``jnp.cumsum`` and clip(rint(cdf *
f32(255 / tile_area)), 0, 255). Every value is an integer below 2**24, so
the comparison is exact.

Clip limits: 2.0 (the shipped one), 0.01 (clip 1: the largest
redistribution) and 40 (nothing clipped on noise); the data gives tiles
whose residual (the excess mod 256) is below 128, where the spread step is
above 1, and 128 or more, where it is 1. The JAX package pads an axis by
``(g - n % g) % g``, cv2 both axes by ``g - n % g`` once either is ragged
(``tests/test_torch_clahe_cv2.py``): the JAX comparison runs where the two
rules agree (both axes divide, or both are ragged), and at one ragged axis
``clahe_cuda`` is held to ``cv2.createCLAHE`` at the same clip limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.kernels.clahe import tile_hists_rows_pallas
from mies_tpu.ops import histogram as JH
from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.ops import histogram as TH

torch.set_num_threads(2)

CLIPS = (2.0, 0.01, 40.0)
# [B, H, W] and grid: both axes divide; both ragged (pads 2 and 2)
SHAPES = (((2, 128, 128), (2, 2)), ((2, 94, 122), (4, 4)))


def _image(shape, grid, noise: bool) -> np.ndarray:
    """Noise, or tiles of few levels: each tile draws from a spread of its
    own (0 to 1), so the tiles' counts pile up in a few bins by differing
    amounts."""
    rng = np.random.default_rng(sum(shape) + noise)
    if noise:
        return rng.random(shape).astype(np.float32)
    b, h, w = shape
    gy, gx = grid
    ys = np.minimum(np.arange(h) * gy // h, gy - 1)
    xs = np.minimum(np.arange(w) * gx // w, gx - 1)
    spreads = np.array([0.004, 0.03, 0.3, 0.6, 0.01, 0.08, 0.7, 1.0])
    spread = rng.permutation(np.resize(spreads, b * gy * gx)).reshape(b, gy, gx)
    base = rng.random((b, gy, gx)) * (1.0 - spread)
    per_px = (base[:, ys][:, :, xs], spread[:, ys][:, :, xs])
    return (per_px[0] + per_px[1] * rng.random(shape)).astype(np.float32)


def _jax_luts(x: np.ndarray, grid, clip_limit: float):
    """clahe_tpu's LUTs and the tiles' clipped counts' excess."""
    gy, gx = grid
    pad = np.stack([np.asarray(JH._pad_reflect101(jnp.asarray(s), grid)[0])
                    for s in x])
    th, tw = pad.shape[1] // gy, pad.shape[2] // gx
    area = th * tw
    hists = tile_hists_rows_pallas(jnp.asarray(pad), gy, gx, interpret=True,
                                   quantize_input=True).reshape(-1, 256)
    clip_value = jnp.float32(max(int(clip_limit * area / 256), 1))
    excess = np.asarray(jnp.sum(jnp.maximum(hists - clip_value, 0.0), axis=1))
    cdf = jnp.cumsum(JH._clip_redistribute_opencv(hists, clip_value), axis=1)
    lut_scale = jnp.float32(255) / area
    luts = jnp.clip(jnp.rint(cdf * lut_scale), 0, 255)
    return np.asarray(luts).reshape(x.shape[0], gy, gx, 256), excess


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("shape,grid", SHAPES)
def test_tile_luts_equal_jax_reference(shape, grid, clip):
    x = _image(shape, grid, noise=clip == 40.0)
    want, excess = _jax_luts(x, grid, clip)
    got = KC.tile_luts(torch.from_numpy(x), grid, clip)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        KC.tile_luts_plain(torch.from_numpy(x), grid, clip).numpy(), want)
    residual = excess.astype(np.int64) % 256
    if clip == 40.0:
        assert (excess == 0).all()  # nothing clipped
    else:
        # a spread step above 1 (residual < 128) and of 1 (>= 128)
        assert ((residual > 0) & (residual < 128)).any(), residual
        assert (residual >= 128).any(), residual


# exactly one axis ragged at an 8x8 grid (cv2 pads both axes)
ONE_RAGGED = [(67, 128), (128, 93), (65, 64)]


@pytest.mark.parametrize("clip", CLIPS)
def test_clahe_cuda_opencv_equals_cv2_one_ragged_axis(clip):
    """K1 to the LUTs -> K2 (plain versions on the CPU) against
    cv2.createCLAHE at the clip limits above, on noise and on few-level
    tiles, at shapes with one ragged axis."""
    import cv2

    cl = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8))
    for shape in ONE_RAGGED:
        for noise in (True, False):
            x = _image((2, *shape), (8, 8), noise)
            u8 = np.clip(np.rint(x * np.float32(255.0)), 0, 255).astype(np.uint8)
            levels = u8.astype(np.float32) / np.float32(255.0)
            out = KC.clahe_cuda(torch.from_numpy(levels), clip, (8, 8))
            got = np.clip(np.rint(out.numpy() * 255.0), 0, 255).astype(np.uint8)
            for b in range(2):
                np.testing.assert_array_equal(got[b], cl.apply(u8[b]),
                                              err_msg=f"{shape} noise={noise}")


def test_tile_luts_conventions_and_limits():
    """fraction's LUTs are K1's counts through the plain float build (at
    the JAX package's pad rule); kornia and skimage have no such LUTs; an
    opencv tile of 2**24 pixels, past the kernel's exact f32 counts, still
    runs the plain build on the CPU (the card refuses it:
    tests/test_torch_kernels.py)."""
    x = torch.from_numpy(_image((2, 61, 83), (4, 4), noise=False))
    hists = KC.tile_hists(x, (4, 4), "fraction").reshape(2, 16, 256).float()
    want = TH._luts_fraction(hists, 0.02, 16 * 21).reshape(2, 4, 4, 256)
    assert torch.equal(KC.tile_luts(x, (4, 4), 0.02, "fraction"), want)
    assert torch.equal(KC.tile_luts_plain(x, (4, 4), 0.02, "fraction"), want)
    for convention in ("kornia", "skimage"):
        with pytest.raises(ValueError, match="opencv or fraction"):
            KC.tile_luts(x, (4, 4), 2.0, convention)
    with pytest.raises(TypeError):
        KC.tile_luts(x.double(), (4, 4), 2.0)
    # a 4096 x 4096 tile: 2**24 pixels
    big = torch.linspace(0, 1, 4096 * 4096).reshape(1, 4096, 4096)
    assert torch.equal(KC.tile_luts(big, (1, 1), 2.0),
                       KC.tile_luts_plain(big, (1, 1), 2.0))
