"""The reference's public names in the port, and the two ops that were
missing from it, against the JAX package on CPU.

* ``mies_tpu_torch.ops`` exports every name of ``mies_tpu.ops.__all__``
  (the same ``__all__``), ``mies_tpu_torch.pipeline`` the reference's
  ``__all__``, ``mies_tpu_torch.kernels`` the reference's batched and
  LUT-apply names, and the package the reference's ``__version__``.
* ``is_low_contrast`` equals the JAX op on uniform noise, a narrow band, a
  constant image and spans 1e-3 either side of the 0.05 threshold, as a
  0-d bool tensor; past 2**24 elements (where ``torch.quantile`` refuses)
  its percentiles equal numpy's linear ones within one float32 ulp.
* ``joint_bilateral_blur`` with a guide that is not the image equals the
  JAX op at k 3, 5 and 7 in each border mode within the bilateral's atol
  2e-6 (tests/test_torch_ops.py; the reference sums the window in another
  order); with ``guide is img`` it is ``bilateral_blur`` bit for bit.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mies_tpu
import mies_tpu.kernels
import mies_tpu.ops
import mies_tpu.pipeline
import mies_tpu_torch
from mies_tpu.ops import filters as JF
from mies_tpu.ops import intensity as JI
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import intensity as TI

torch.set_num_threads(2)


def test_ops_export_every_reference_name():
    ops = importlib.import_module("mies_tpu_torch.ops")
    assert ops.__all__ == mies_tpu.ops.__all__
    assert len(ops.__all__) == 75
    for name in mies_tpu.ops.__all__:
        assert callable(getattr(ops, name)), name
    from mies_tpu_torch.ops import clahe, is_low_contrast, joint_bilateral_blur
    assert clahe.__module__ == "mies_tpu_torch.ops.histogram"
    assert is_low_contrast is TI.is_low_contrast
    assert joint_bilateral_blur is TF.joint_bilateral_blur


def test_pipeline_kernels_and_version_names():
    pipeline = importlib.import_module("mies_tpu_torch.pipeline")
    assert pipeline.__all__ == mies_tpu.pipeline.__all__
    for name in pipeline.__all__:
        assert getattr(pipeline, name) is not None, name
    from mies_tpu_torch.pipeline.export import export_pipeline
    assert pipeline.export_pipeline is export_pipeline
    kernels = importlib.import_module("mies_tpu_torch.kernels")
    assert set(kernels.__all__) == {"clahe_batched", "bilateral_batched",
                                    "clahe_apply_lut"}
    assert set(kernels.__all__) <= set(mies_tpu.kernels.__all__)
    for name in kernels.__all__:
        assert callable(getattr(kernels, name)), name
    assert mies_tpu_torch.__version__ == mies_tpu.__version__ == "0.1.0"
    assert "__version__" in mies_tpu_torch.__all__


def _span_image(span: float, shape=(64, 96), seed=0) -> np.ndarray:
    """Values spread evenly over [0.3, 0.3 + span], shuffled: its 1-99
    percentile span is 0.98 span."""
    n = int(np.prod(shape))
    v = np.linspace(0.3, 0.3 + span, n, dtype=np.float64)
    return np.random.default_rng(seed).permutation(v).astype(
        np.float32).reshape(shape)


LOW_CONTRAST_CASES = {
    "uniform noise": np.random.default_rng(1).random((64, 96), np.float32),
    "narrow band": (0.5 + 0.01 * np.random.default_rng(2).random(
        (64, 96), np.float32)).astype(np.float32),
    "constant": np.full((64, 96), 0.25, np.float32),
    "batch of two": np.random.default_rng(3).random((2, 40, 56), np.float32),
    **{f"span {s:.4f}": _span_image(s / 0.98, seed=i)
       for i, s in enumerate((0.049, 0.0495, 0.0505, 0.051))},
}


@pytest.mark.parametrize("case", list(LOW_CONTRAST_CASES))
@pytest.mark.parametrize("kw", [{}, {"fraction_threshold": 0.3,
                                     "lower_percentile": 5.0,
                                     "upper_percentile": 95.0}])
def test_is_low_contrast_equals_jax(case, kw):
    img = LOW_CONTRAST_CASES[case]
    got = TI.is_low_contrast(torch.from_numpy(img), **kw)
    ref = np.asarray(JI.is_low_contrast(jnp.asarray(img), **kw))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(ref)


def test_is_low_contrast_threshold_sides():
    """Spans 1e-3 below and above the threshold decide both ways."""
    for span, want in ((0.049, True), (0.051, False)):
        img = torch.from_numpy(_span_image(span / 0.98))
        assert bool(TI.is_low_contrast(img)) is want


def test_is_low_contrast_past_two_to_the_24_elements():
    n = 2**24 + 1001
    x = np.random.default_rng(4).random(n, np.float32) * np.float32(0.04)
    flat = torch.from_numpy(x)
    for p in (1.0, 99.0):
        want = np.percentile(x.astype(np.float64), p)  # numpy's linear rule
        got = float(TI._percentile(flat, p))
        assert abs(got - want) <= np.spacing(np.float32(want)), (p, got, want)
    assert bool(TI.is_low_contrast(flat.reshape(1, -1)))


@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest", "constant",
                                  "wrap"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_joint_bilateral_blur_equals_jax(mode, k):
    rng = np.random.default_rng(10 + k)
    img = rng.random((2, 48, 80), np.float32)
    guide = np.clip(img + 0.2 * rng.standard_normal(img.shape), 0, 1
                    ).astype(np.float32)
    ref = np.stack([np.asarray(JF.joint_bilateral_blur(
        jnp.asarray(img[i]), jnp.asarray(guide[i]), k, 0.1, 1.5, mode))
        for i in range(2)])
    got = TF.joint_bilateral_blur(torch.from_numpy(img),
                                  torch.from_numpy(guide), k, 0.1, 1.5,
                                  mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    # the guide matters: the self-guided filter is another result
    own = TF.bilateral_blur(torch.from_numpy(img), k, 0.1, 1.5, mode).numpy()
    assert np.abs(own - got).max() > 1e-3


@pytest.mark.parametrize("k", [3, 5, 7])
def test_joint_bilateral_blur_self_guided_is_bilateral_blur(k):
    img = torch.from_numpy(
        np.random.default_rng(20 + k).random((2, 48, 80), np.float32))
    for mode in ("reflect", "nearest"):
        assert torch.equal(
            TF.joint_bilateral_blur(img, img, k, 0.1, 1.5, mode),
            TF.bilateral_blur(img, k, 0.1, 1.5, mode))


def test_joint_bilateral_blur_refuses_a_guide_of_another_shape():
    img = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="guide shape"):
        TF.joint_bilateral_blur(img, torch.zeros(2, 16, 17))
    with pytest.raises(ValueError, match="odd"):
        TF.joint_bilateral_blur(img, img, kernel_size=4)
