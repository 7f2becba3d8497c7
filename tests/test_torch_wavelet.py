"""The port's wavelet shrinkage (``mies_tpu_torch/ops/wavelet.py``) against
the JAX package on the CPU and the float64 goldens.

* The tables equal the reference's bit for bit: ``wavelet_filters`` for
  every name, ``dwt_max_level`` and ``default_levels``.
* The DWT: every subband equals the reference's bit for bit, and the
  round trip restores the input within 2e-6, at every level.
* ``denoise_wavelet``, ``estimate_sigma`` and ``cycle_spin`` on a
  [3, H, W] batch against ``jax.jit(jax.vmap(op))`` (the reference's
  batched ``cycle_spin_batched`` for cycle_spin) within 2e-6 (1e-7 for
  the estimate; the port sums BayesShrink's mean of squares in float64,
  the reference in float32), each slice alone equal to its row; against
  the goldens within 2e-6 (the reference's own bound,
  ``tests/test_wavelet.py``). The
  batch's slices differ in noise, so a threshold or a level count taken
  from the batch tensor instead of one image would not pass.
* Exact zero detail coefficients: a db1 (Haar) detail across an odd
  extent's mirrored edge pair, or across a clipped flat, is exactly 0.
  Jitted on XLA:CPU, the reference's fused shifted adds round otherwise
  and leave residues up to 3e-8 there (46 of the 80 zeros of a 67 x 93
  slice's finest diagonal subband); its nonzero-masked median counts
  them, the noise estimate moves (0.0187 against 0.0202) and the output
  lands 0.029 off the golden. Run op by op, the reference equals its
  golden within 4e-7, as the port does. So the odd-extent and clipped
  cases are held to the reference run op by op (each distinct shape
  compiles its primitives once: seconds), the rest to the jitted one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.goldens.golden_ops as G
from mies_tpu.ops import wavelet as JW
from mies_tpu_torch.ops import wavelet as TW

torch.set_num_threads(2)

SHAPES = [(3, 48, 64), (1, 67, 93)]


def _noisy(shape, seed, clip=False) -> np.ndarray:
    """A ramp plus noise whose level differs by slice (clipped to [0, 1]
    with ``clip``: flats at the ends of the ramp)."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    base = np.linspace(0.2, 0.8, w, dtype=np.float32)
    out = []
    for i in range(b):
        y = base + rng.normal(0.0, 0.03 + 0.05 * i, (h, w))
        out.append(np.clip(y, 0.0, 1.0) if clip else y)
    return np.stack(out).astype(np.float32)


def _check(top, jop, x, atol, jitted=True):
    """The port's batch against the JAX batched op (jitted, or run op by
    op); each slice alone equal to its row."""
    got = top(torch.from_numpy(x)).numpy()
    want = np.asarray((jax.jit(jop) if jitted else jop)(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for i in range(x.shape[0]):
        np.testing.assert_array_equal(top(torch.from_numpy(x[i])).numpy(),
                                      got[i])
    return got


@pytest.mark.parametrize("name", sorted(JW._WAVELETS))
def test_tables_equal_reference(name):
    for got, want in zip(TW.wavelet_filters(name), JW.wavelet_filters(name)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    flen = len(TW.wavelet_filters(name)[0])
    for n in (1, 2, 3, 7, 8, 64, 67, 93, 512, 4096):
        assert TW.dwt_max_level(n, flen) == JW.dwt_max_level(n, flen)
        assert (TW.default_levels((n, 93), flen)
                == JW.default_levels((n, 93), flen))
    with pytest.raises(ValueError, match="unknown wavelet"):
        TW.wavelet_filters("coif1")


@pytest.mark.parametrize("name", ["db1", "db2", "sym4"])
def test_dwt_matches_jax_and_round_trips(name):
    """Every subband at the deepest level equals the reference's (run op
    by op) bit for bit; the round trip at every level restores the input
    within 2e-6."""
    x = _noisy((2, 24, 40), seed=1, clip=True)
    flen = len(TW.wavelet_filters(name)[0])
    top = min(TW.dwt_max_level(n, flen) for n in x.shape[1:])
    a, det = TW.wavedec_nd(torch.from_numpy(x), name, top, 2)
    ja, jdet = JW.wavedec_nd(jnp.asarray(x[1]), name, top)
    np.testing.assert_array_equal(a[1].numpy(), np.asarray(ja))
    for lv, jlv in zip(det, jdet):
        assert lv.keys() == jlv.keys()
        for k in lv:
            np.testing.assert_array_equal(lv[k][1].numpy(), np.asarray(jlv[k]))
    for level in range(1, top + 1):
        a, det = TW.wavedec_nd(torch.from_numpy(x), name, level, 2)
        back = TW.waverec_nd(a, det, name, x.shape[1:]).numpy()
        np.testing.assert_allclose(back, x, rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape,kw", [
    *[((3, 48, 64), kw) for kw in (
        {},
        {"wavelet": "db2"},  # configs/xray_wavelet_denoise.yaml
        {"mode": "hard", "method": "VisuShrink"},
        {"sigma": 0.08},
        {"wavelet": "sym4", "sigma": 0.05, "mode": "hard"})],
    ((1, 67, 93), {}),  # odd extents: op by op
])
def test_denoise_wavelet_matches_jax_and_golden(shape, kw):
    x = _noisy(shape, seed=shape[1] + len(kw))
    got = _check(functools.partial(TW.denoise_wavelet, **kw),
                 jax.vmap(functools.partial(JW.denoise_wavelet, **kw)), x,
                 2e-6, jitted=shape[1] % 2 == 0)
    for i in range(shape[0]):
        np.testing.assert_allclose(got[i], G.denoise_wavelet(x[i], **kw),
                                   rtol=0, atol=2e-6)


def test_denoise_wavelet_at_every_level():
    """Explicit wavelet_levels from 1 to the maximum (db2 at 48 x 64: 4),
    and one past it refused as the reference refuses it."""
    x = _noisy((3, 48, 64), seed=9)
    top = min(TW.dwt_max_level(n, 4) for n in x.shape[1:])
    assert top == 4
    for level in range(1, top + 1):
        kw = {"wavelet": "db2", "wavelet_levels": level}
        got = TW.denoise_wavelet(torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jax.jit(jax.vmap(functools.partial(
            JW.denoise_wavelet, **kw)))(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        np.testing.assert_allclose(got[1], G.denoise_wavelet(x[1], **kw),
                                   rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="exceeds the maximum"):
        TW.denoise_wavelet(torch.from_numpy(x), wavelet="db2",
                           wavelet_levels=top + 1)


def test_default_levels_are_one_images():
    """A [32, 512, 512] batch at db2 decomposes 4 levels (dwt_max_level
    (512, 4) = 7, less 3), never a level count from the batch axis."""
    assert TW.default_levels((512, 512), 4) == 4
    assert TW.default_levels((32, 512, 512), 4) == 1


@pytest.mark.parametrize("shape", SHAPES)
def test_estimate_sigma_matches_jax_and_golden(shape):
    x = _noisy(shape, seed=4 + shape[1])
    got = TW.estimate_sigma(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.vmap(JW.estimate_sigma))(jnp.asarray(x)))
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    for i in range(shape[0]):
        assert abs(float(got[i]) - G.estimate_sigma(x[i])) < 1e-6
        assert TW.estimate_sigma(torch.from_numpy(x[i])).shape == ()


def test_clipped_flats_match_the_reference_op_by_op():
    """A 67 x 93 slice with clipped flats and a flat first column (at
    least 80 exact zeros in its finest diagonal db1 subband): the subbands
    equal the reference's bit for bit, the nonzero-masked noise estimates
    are equal, and the config's db2 denoise equals the reference's within
    2e-6 and the golden within 2e-6."""
    x = _noisy((1, 67, 93), seed=67, clip=True)
    x[0, :, 0] = 0.5  # a flat column: zeros in the estimator's subband
    d = TW.wavedec_nd(torch.from_numpy(x), "db1", 3, 2)[1][-1]["dd"]
    jd = JW.wavedec_nd(jnp.asarray(x[0]), "db1", 3)[1][-1]["dd"]
    np.testing.assert_array_equal(d[0].numpy(), np.asarray(jd))
    assert int((d == 0).sum()) >= 80
    assert (float(TW._masked_median_abs(d, 2).reshape(()))
            == float(JW._masked_median_abs(jd)))
    got = TW.estimate_sigma(torch.from_numpy(x)).numpy()
    assert float(got[0]) == float(JW.estimate_sigma(jnp.asarray(x[0])))
    assert abs(float(got[0]) - G.estimate_sigma(x[0])) < 1e-6
    kw = {"wavelet": "db2", "method": "BayesShrink", "mode": "soft"}
    out = TW.denoise_wavelet(torch.from_numpy(x), **kw).numpy()[0]
    np.testing.assert_allclose(
        out, np.asarray(JW.denoise_wavelet(jnp.asarray(x[0]), **kw)),
        rtol=0, atol=2e-6)
    np.testing.assert_allclose(out, G.denoise_wavelet(x[0], **kw), rtol=0,
                               atol=2e-6)


def test_zero_image():
    """All-zero detail: the estimate is exactly 0, BayesShrink's eps guard
    keeps the thresholds finite, the flat image comes back."""
    z = torch.zeros((2, 32, 32))
    assert TW.estimate_sigma(z).tolist() == [0.0, 0.0]
    flat = torch.full((2, 32, 32), 0.5)
    out = TW.denoise_wavelet(flat).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 0.5, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [
    {"max_shifts": 2},
    {"max_shifts": 3, "shift_steps": 2, "wavelet": "db2"},
    {"max_shifts": 1, "sigma": 0.08, "mode": "hard"},
])
def test_cycle_spin_matches_jax_and_golden(kw):
    x = _noisy((3, 32, 48), seed=len(kw))
    got = _check(functools.partial(TW.cycle_spin, **kw),
                 functools.partial(JW.cycle_spin_batched, **kw), x, 2e-6)
    for i in range(x.shape[0]):
        np.testing.assert_allclose(got[i], G.cycle_spin(x[i], **kw),
                                   rtol=0, atol=2e-6)


def test_cycle_spin_without_shifts_is_the_denoise():
    x = torch.from_numpy(_noisy((2, 48, 48), seed=2))
    np.testing.assert_allclose(TW.cycle_spin(x, 0).numpy(),
                               TW.denoise_wavelet(x).numpy(), rtol=0,
                               atol=1e-7)


def test_bad_arguments_raise():
    x = torch.zeros((1, 32, 32))
    with pytest.raises(ValueError, match="method"):
        TW.denoise_wavelet(x, method="SUREShrink")
    with pytest.raises(ValueError, match="mode"):
        TW.denoise_wavelet(x, mode="firm")
    with pytest.raises(ValueError, match="exceeds the maximum"):
        TW.denoise_wavelet(x, wavelet_levels=9)
    with pytest.raises(ValueError, match="max_shifts"):
        TW.cycle_spin(x, max_shifts=-1)
    with pytest.raises(ValueError, match="shift_steps"):
        TW.cycle_spin(x, shift_steps=0)
