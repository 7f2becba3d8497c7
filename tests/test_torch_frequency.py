"""The port's frequency-domain ops (``mies_tpu_torch/ops/frequency.py``)
against the JAX package on the CPU and the float64 goldens.

* ``butterworth_transfer`` equals the reference's table bit for bit.
* ``butterworth`` and ``homomorphic`` on one slice and on a [3, H, W]
  batch against ``jax.jit(jax.vmap(op))`` on the same seeded input, within
  2e-6 (both run a float32 FFT: pocketfft in torch, XLA's on the CPU); the
  batch's slices differ in contrast and the pad, the transform and the
  transfer must be one image's (H + 2 npad, W + 2 npad), never the
  batch tensor's. Each slice alone is held to the same bound.
* Against ``tests/goldens/golden_ops.py`` (numpy's float64 FFT): 2e-5, the
  reference's own bound for its float32 FFT (``tests/test_frequency.py``).
* The precision defaults: importing ``mies_tpu_torch`` turns TF32 off in
  cuBLAS and cuDNN.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mies_tpu_torch  # noqa: F401  (sets the precision defaults)
import tests.goldens.golden_ops as G
from mies_tpu.ops import frequency as JFQ
from mies_tpu_torch.ops import frequency as TFQ
from mies_tpu_torch.pipeline.config import PipelineConfig, validate

torch.set_num_threads(2)

SHAPES = [(3, 64, 80), (1, 67, 93)]


def _batch(shape, seed) -> np.ndarray:
    """Seeded slices in (0, 1] whose contrast and offset differ by slice."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    imgs = []
    for i in range(b):
        ramp = 0.3 * (x / w) + 0.2 * np.sin(y / (4.0 + 3 * i))
        noise = (0.05 + 0.1 * i) * rng.standard_normal((h, w))
        imgs.append(np.clip(0.2 + 0.1 * i + ramp + noise, 0.01, 1.0))
    return np.stack(imgs).astype(np.float32)


def _check(top, jop, x, atol):
    """The port's batch, and each slice alone, against jit(vmap) of the
    JAX op (a batched FFT need not round as one slice's does)."""
    got = top(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jop))(jnp.asarray(x)))
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for i in range(x.shape[0]):
        np.testing.assert_allclose(top(torch.from_numpy(x[i])).numpy(),
                                   want[i], rtol=0, atol=atol)
    return got


@pytest.mark.parametrize("shape", [(64, 80), (67, 93), (544, 273), (9, 2)])
@pytest.mark.parametrize("cutoff,order,high,squared", [
    (0.02, 2.0, True, True), (0.005, 1.0, False, True),
    (0.1, 3.5, True, False), (0.5, 2.0, False, False)])
def test_transfer_equals_reference(shape, cutoff, order, high, squared):
    TFQ.butterworth_transfer.cache_clear()
    got = TFQ.butterworth_transfer(shape, cutoff, order, high, squared)
    want = JFQ.butterworth_transfer(shape, cutoff, order, high, squared)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {"cutoff_frequency_ratio": 0.02},
    {"cutoff_frequency_ratio": 0.05, "high_pass": False, "npad": 7},
    {"cutoff_frequency_ratio": 0.1, "order": 3.0, "squared_butterworth": False,
     "npad": 16},
])
def test_butterworth_matches_jax_and_golden(shape, kw):
    x = _batch(shape, seed=len(kw) + shape[1])
    got = _check(functools.partial(TFQ.butterworth, **kw),
                 functools.partial(JFQ.butterworth, **kw), x, 2e-6)
    for i in range(shape[0]):
        np.testing.assert_allclose(
            got[i], G.butterworth_filter(x[i], **kw), rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {},  # the defaults: npad 16
    # configs/xray_homomorphic.yaml
    {"cutoff_frequency_ratio": 0.02, "order": 2.0, "low_gain": 0.4,
     "high_gain": 1.4, "npad": 16},
    {"cutoff_frequency_ratio": 0.1, "order": 1.0, "low_gain": 0.8,
     "high_gain": 2.0, "eps": 0.01, "npad": 0},
])
def test_homomorphic_matches_jax_and_golden(shape, kw):
    x = _batch(shape, seed=3 + len(kw) + shape[1])
    got = _check(functools.partial(TFQ.homomorphic, **kw),
                 functools.partial(JFQ.homomorphic, **kw), x, 2e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0
    for i in range(shape[0]):
        np.testing.assert_allclose(
            got[i], G.homomorphic_filter(x[i], **kw), rtol=0, atol=2e-5)


def test_transfer_is_built_from_one_padded_image():
    """The homomorphic transfer of a [3, 64, 80] batch at npad 16 is the
    96 x 112 grid's (half spectrum 57), cached once on the device."""
    TFQ._device_transfer.cache_clear()
    x = torch.from_numpy(_batch((3, 64, 80), seed=5))
    TFQ.homomorphic(x, npad=16)
    TFQ.homomorphic(x, npad=16)
    info = TFQ._device_transfer.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    w = TFQ._device_transfer((96, 112), 0.02, 2.0, True, True, (0.5, 1.5),
                             torch.device("cpu"))
    assert tuple(w.shape) == (96, 57)


def test_bad_arguments_raise():
    x = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="cutoff_frequency_ratio"):
        TFQ.butterworth(x, cutoff_frequency_ratio=0.6)
    with pytest.raises(ValueError, match="npad"):
        TFQ.butterworth(x, npad=-1)
    with pytest.raises(ValueError, match="eps"):
        TFQ.homomorphic(x, eps=0.0)
    with pytest.raises(ValueError, match="cutoff_frequency_ratio"):
        validate(PipelineConfig.make(
            [("butterworth", {"cutoff_frequency_ratio": 0.9})]))
    with pytest.raises(ValueError, match="low_gain"):
        validate(PipelineConfig.make([("homomorphic", {"low_gain": -1.0})]))


def test_import_turns_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
