"""The volume program's intensity and equalization ops, its registry and its
value rules, against the JAX package on the CPU.

The same seeded numpy volumes ([8, 24, 32] and the ragged [7, 23, 31])
go through each op of the port's ``_volume_registry()`` and the
reference's. Their slices have different ranges, so an op that took each
slice's statistic (min, max, histogram) instead of the whole volume's
would show. Tolerances:

* bit-equal against the reference run op by op (``jax.disable_jit()``):
  equalize_hist, normalize, rescale_intensity (both in_range forms),
  invert, window_hu, normalize_meanstd, denormalize_meanstd;
* <= 1e-6 abs: adjust_gamma, adjust_log, adjust_sigmoid (libm against
  XLA's pow/log2/exp).

``equalize_hist`` over more than 2**24 voxels is held against
tests/goldens/golden_ops.py's float64 transcription of skimage within
the reference's own golden bound (atol 2e-5, tests/test_histogram.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.pipeline import compiler as JC
from mies_tpu.pipeline.config import PipelineConfig as JConfig
from mies_tpu.pipeline.config import validate as j_validate
from mies_tpu_torch.ops import volume3d as TV
from mies_tpu_torch.pipeline import compiler as TC
from mies_tpu_torch.pipeline.config import PipelineConfig as TConfig
from mies_tpu_torch.pipeline.config import validate as t_validate
from tests.goldens import golden_ops as G

torch.set_num_threads(2)

SHAPES = [(8, 24, 32), (7, 23, 31)]


def _volume(shape, seed=0) -> np.ndarray:
    """A smooth field plus noise, slice z scaled by 0.3 .. 1.0 and shifted
    by 0 .. 0.2: every slice has its own range and histogram."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]].astype(np.float32)
    smooth = 0.5 + 0.3 * np.sin(y / 4) * np.cos(x / 5) * np.cos(z / 3)
    v = 0.6 * smooth + 0.4 * rng.random(shape, dtype=np.float32)
    scale = np.linspace(0.3, 1.0, shape[0], dtype=np.float32)[:, None, None]
    off = np.linspace(0.0, 0.2, shape[0], dtype=np.float32)[:, None, None]
    return np.clip(v * scale + off, 0.0, 1.0).astype(np.float32)


def _jax_eager(op, vol, kw):
    with jax.disable_jit():
        return np.asarray(JC._volume_registry()[op](jnp.asarray(vol), **kw))


def _port(op, vol, kw):
    return TC._volume_registry()[op](torch.from_numpy(vol), **kw).numpy()


BIT_EQUAL = [
    ("equalize_hist", {}),
    ("equalize_hist", {"nbins": 100}),
    ("normalize", {}),
    ("rescale_intensity", {}),
    ("rescale_intensity", {"in_range": (0.2, 0.7), "out_range": (0.1, 0.9)}),
    ("invert", {}),
    ("window_hu", {"center": 0.5, "width": 0.8}),
    ("normalize_meanstd", {"mean": 0.4, "std": 0.3}),
    ("denormalize_meanstd", {"mean": 0.4, "std": 0.3}),
]
LIBM = [
    ("adjust_gamma", {"gamma": 0.8}),
    ("adjust_log", {"gain": 0.7, "inv": True}),
    ("adjust_sigmoid", {"cutoff": 0.4, "gain": 6.0}),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op,kw", BIT_EQUAL,
                         ids=[f"{o}{sorted(k.items())}" for o, k in BIT_EQUAL])
def test_volume_op_bit_equals_the_eager_reference(shape, op, kw):
    vol = _volume(shape)
    got, want = _port(op, vol, kw), _jax_eager(op, vol, kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op,kw", LIBM, ids=[o for o, _ in LIBM])
def test_volume_pointwise_libm_op_within_1e6(shape, op, kw):
    vol = _volume(shape)
    np.testing.assert_allclose(_port(op, vol, kw), _jax_eager(op, vol, kw),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("op", ["equalize_hist", "normalize",
                                "rescale_intensity"])
def test_volume_statistics_are_the_whole_volumes(op):
    """The volume registry's form differs from the 2-D registry's (each
    slice's statistic) on a volume whose slices have different ranges, and
    equals the reference's volume op: the statistic is the whole volume's."""
    vol = _volume((8, 24, 32))
    whole = _port(op, vol, {})
    per_slice = TC.OP_REGISTRY[op](torch.from_numpy(vol)).numpy()
    assert np.abs(whole - per_slice).max() > 0.05
    np.testing.assert_array_equal(whole, _jax_eager(op, vol, {}))
    # one slice alone through the volume form is that slice's 2-D result
    np.testing.assert_array_equal(_port(op, vol[3:4], {})[0], per_slice[3])


def test_equalize_hist_past_2_24_voxels_within_the_golden_bound():
    """[65, 512, 512] = 17,039,360 voxels: past the float32 cumsum's exact
    range. The port counts in int64 and rounds each partial sum once."""
    shape = (65, 512, 512)
    assert np.prod(shape) > 2**24
    rng = np.random.default_rng(7)
    vol = np.clip(rng.normal(0.45, 0.15, shape), 0, 1).astype(np.float32)
    got = TV.equalize_hist_volume(torch.from_numpy(vol)).numpy()
    np.testing.assert_allclose(got, G.equalize_hist(vol), atol=2e-5, rtol=0)


def test_equalize_hist_cdf_is_exact_where_a_float32_cumsum_drifts():
    """The CDF the port interpolates comes from exact integer counts: on a
    volume of 2**24 + 1 voxels in two bins, the last partial sum below the
    total is 2**24, which a float32 running sum of float32 ones cannot
    pass (it sticks at 2**24); the port's value there is 2**24 / total."""
    n = 2**24 + 1
    vol = torch.zeros((1, 1, n))
    vol[0, 0, -1] = 1.0  # one voxel in the last bin, 2**24 in the first
    got = TV.equalize_hist_volume(vol, nbins=2)
    want = np.float32(np.float32(2**24) / np.float32(n))
    assert got[0, 0, 0].item() == want and got[0, 0, -1].item() == 1.0


# --- the registry --------------------------------------------------------


def test_volume_registry_has_the_references_37_ops():
    assert set(TC._volume_registry()) == set(JC._volume_registry())
    assert len(TC._volume_registry()) == 37


def test_volume_only_ops_equal_the_references():
    assert TC.VOLUME_ONLY_OPS == JC.VOLUME_ONLY_OPS
    assert len(TC.VOLUME_ONLY_OPS) == 27
    assert TC.VOLUME_ONLY_OPS <= set(TC.OP_REGISTRY)


@pytest.mark.parametrize("op", sorted(JC._volume_registry()))
def test_volume_op_signature_equals_the_references(op):
    def params(fn):
        return [(k, p.default) for k, p in
                list(inspect.signature(fn).parameters.items())[1:]]

    assert params(TC._volume_registry()[op]) == params(
        JC._volume_registry()[op])
    assert params(TC.OP_REGISTRY[op]) == params(JC.OP_REGISTRY[op])


@pytest.mark.parametrize("op", sorted(JC.VOLUME_ONLY_OPS))
def test_2d_chain_refuses_a_volume_only_op_by_name(op):
    cfg = TConfig.make([("invert", {}), (op, {})])
    with pytest.raises(ValueError, match=f"{op}.*volume-only"):
        TC.build_batched_chain(cfg, device="cpu")


def test_volume_pipeline_refuses_a_2d_only_op():
    cfg = TConfig.make([("clahe", {})])
    with pytest.raises(ValueError, match="'clahe' is not volume-capable"):
        TC.compile_volume_pipeline(cfg, device="cpu")


# --- value rules: bad params refused by both packages' validate ----------

BAD = [
    ("guided_blur3d", {"kernel_size": 4}),
    ("guided_blur3d", {"eps": 0}),
    ("median_blur3d", {"kernel_size": 2}),
    ("median_blur3d", {"mode": "bogus"}),
    ("unsharp_mask3d", {"radius": 0}),
    ("unsharp_mask3d", {"amount": -1}),
    ("erode3d", {"kernel_size": 0}),
    ("dilate3d", {"mode": "zero"}),
    ("morph_open3d", {"kernel_size": 4}),
    ("morph_close3d", {"kernel_size": 2.0}),
    ("morph_gradient3d", {"mode": "cross"}),
    ("top_hat3d", {"kernel_size": -3}),
    ("black_hat3d", {"kernel_size": True}),
    ("resample3d", {"depth": 0, "height": 4, "width": 4}),
    ("resample3d", {"depth": 4, "height": 2.5, "width": 4}),
    ("difference_of_gaussians3d", {"low_sigma": 0}),
    ("difference_of_gaussians3d", {"high_sigma": -1.0}),
    ("denoise_nl_means3d", {"patch_size": 0}),
    ("denoise_nl_means3d", {"h": 0}),
    ("denoise_tv3d", {"weight": 0}),
    ("denoise_tv3d", {"max_num_iter": 0}),
    ("wiener3d", {"psf_size": 4}),
    ("wiener3d", {"balance": 0}),
    ("wiener", {"clip": "yes"}),
    ("anisotropic_diffusion3d", {"option": 3}),
    ("anisotropic_diffusion3d", {"voxelspacing": [1.0, 0.0, 1.0]}),
    ("anisotropic_diffusion3d", {"voxelspacing": [1.0, 1.0]}),
    ("srad3d", {"dt": 0.3}),
    ("srad3d", {"q0": 0}),
    ("frangi3d", {"sigmas": []}),
    ("frangi3d", {"gamma": 0}),
    ("vessel_enhance3d", {"amount": -0.5}),
    ("sato3d", {"black_ridges": 1}),
    ("meijering3d", {"alpha": -0.1}),
    ("hessian3d", {"gamma": None}),
    ("butterworth3d", {"cutoff_frequency_ratio": 0.7}),
    ("homomorphic3d", {"npad": -1}),
    ("denoise_wavelet3d", {"mode": "medium"}),
    ("denoise_wavelet3d", {"wavelet_levels": 0}),
    ("normalize_meanstd", {"std": 0}),
    ("denormalize_meanstd", {"mean": "a"}),
]


@pytest.mark.parametrize("op,kw", BAD,
                         ids=[f"{o}{sorted(k.items())}" for o, k in BAD])
def test_bad_params_refused_by_both_packages(op, kw):
    with pytest.raises(ValueError, match=f"{op}.*param") as t:
        t_validate(TConfig.make([(op, kw)]))
    with pytest.raises(ValueError, match=f"{op}.*param") as j:
        j_validate(JConfig.make([(op, kw)]))
    assert str(t.value) == str(j.value)
