"""OpenCV-convention CLAHE against cv2 where one axis is ragged, on CPU.

``cv2.createCLAHE`` pads BOTH axes by ``g - n % g`` (reflect-101, bottom
and right) as soon as either axis is not a multiple of the tile grid, so
an axis that divides evenly gains a full tile and its tiles grow. The
JAX package pads each axis by ``(g - n % g) % g`` (mies_tpu/ops/
histogram.py ``_pad_reflect101``) and so differs from cv2 at these shapes:
the port's opencv convention follows cv2, and is held here to 0 pixels
off cv2 (plain torch: the single-slice op, the batched op and the K1 ->
LUT build -> K2 composition, whose wrappers run their plain versions on a
CPU tensor). The fraction convention has no outside ground truth and keeps
the JAX package's rule: it is held to the JAX package (atol 1e-6, the
FMA and reciprocal allowance of tests/test_torch_clahe.py). The ``cuda``
twin runs K1 -> K2 on the card against cv2's output hashes, pinned in
chip_smoke.py (the card's machine has no cv2) and checked here.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from pytest import skip

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.ops import histogram as TH

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

# exactly one axis ragged at an 8x8 grid
ONE_RAGGED = [(67, 128), (128, 93), (64, 93), (65, 64), (121, 200),
              (512, 500)]
# the pad is as long as the image or longer (several reflect-101 bounces)
TINY = [(3, 3), (8, 5), (5, 8), (1, 9), (9, 1), (2, 2)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cv2(u8: np.ndarray) -> np.ndarray:
    import cv2  # not on the card's machine, where only the cuda twin runs

    return cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(u8)


def _levels(out: torch.Tensor) -> np.ndarray:
    return np.clip(np.rint(out.cpu().numpy() * 255.0), 0, 255).astype(np.uint8)


def _f32(u8: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u8.astype(np.float32) / np.float32(255.0))


@pytest.mark.parametrize("shape", ONE_RAGGED + TINY)
def test_opencv_single_slice_equals_cv2(shape):
    u8 = SMOKE.cv2_noise(shape)
    out = TH.clahe(_f32(u8), 2.0, (8, 8), "opencv")
    np.testing.assert_array_equal(_levels(out), _cv2(u8))


@pytest.mark.parametrize("shape", ONE_RAGGED + TINY)
def test_opencv_batched_equals_cv2(shape):
    """Three slices at once through the batched op and through K1 -> LUT
    build -> K2: each row equals cv2 on that slice."""
    rng = np.random.default_rng(sum(shape))
    u8 = (rng.random((3, *shape)) * 256).astype(np.uint8)
    want = np.stack([_cv2(s) for s in u8])
    x = _f32(u8)
    np.testing.assert_array_equal(_levels(KC.clahe_batched(x, 2.0, (8, 8))),
                                  want)
    np.testing.assert_array_equal(_levels(KC.clahe_cuda(x, 2.0, (8, 8))), want)


def test_cv2_hashes_pinned_for_the_card():
    for shape, digest in SMOKE.CV2_CLAHE_SHA256.items():
        assert SMOKE.levels_sha256(_cv2(SMOKE.cv2_noise(shape))) == digest
    assert sorted(SMOKE.CV2_CLAHE_SHA256) == sorted(ONE_RAGGED)


@pytest.mark.parametrize("shape,want", [
    ((512, 512), {"opencv": (0, 0), "fraction": (0, 0)}),   # the flagship
    ((67, 128), {"opencv": (5, 8), "fraction": (5, 0)}),
    ((128, 93), {"opencv": (8, 3), "fraction": (0, 3)}),
    ((67, 93), {"opencv": (5, 3), "fraction": (5, 3)}),
])
def test_grid_pads_by_convention(shape, want):
    for convention, pads in want.items():
        assert TH.grid_pads(shape, (8, 8), convention) == pads


@pytest.mark.parametrize("shape", ONE_RAGGED)
def test_fraction_keeps_the_jax_rule(shape):
    import jax.numpy as jnp

    from mies_tpu.ops import histogram as JH

    img = np.random.default_rng(7).random(shape).astype(np.float32)
    ref = np.asarray(JH.clahe(jnp.asarray(img), clip_limit=0.02,
                              convention="fraction"))
    out = TH.clahe(torch.from_numpy(img), 0.02, (8, 8), "fraction")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    x = torch.from_numpy(img)[None]
    assert torch.equal(KC.clahe_cuda(x, 0.02, (8, 8), "fraction")[0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ONE_RAGGED + TINY)
def test_k1_k2_on_card_equal_cv2(cuda_device, shape):
    """K1 to the LUTs -> K2 on the card: one launch each, equal to the
    plain version, and at the pinned shapes equal to cv2's hash."""
    u8 = np.stack([SMOKE.cv2_noise(shape)] * 2)
    x = _f32(u8).to(cuda_device)
    _build.reset_launches()
    got = KC.clahe_cuda(x, 2.0, (8, 8))
    assert _build.LAUNCHES["tile_luts"] == 1
    assert _build.LAUNCHES["clahe_apply_lut"] == 1
    assert torch.equal(got.cpu(), TH.clahe(x.cpu(), 2.0, (8, 8)))
    if shape in SMOKE.CV2_CLAHE_SHA256:
        for row in _levels(got):
            assert SMOKE.levels_sha256(row) == SMOKE.CV2_CLAHE_SHA256[shape]
