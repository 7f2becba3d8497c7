"""The volume program's ridge, frequency and wavelet ops against the JAX
package on the CPU.

The same seeded numpy volumes ([8, 24, 32] and the ragged [7, 23, 31])
go through each op and its reference. Tolerances, as the 2-D forms are
held (ROADMAP.md queue 3):

* the closed-form 3x3 eigenvalues within 5e-6 (rtol 1e-5) of LAPACK's
  and 1e-6 of the reference run op by op; near repeated roots, where acos
  amplifies an ulp of its argument to about sqrt(ulp), within 5e-6 of the
  reference run op by op;
* frangi3d and vessel_enhance3d within 2e-6, sato3d and meijering3d within
  5e-6 of the jitted JAX op (XLA:CPU fuses the Hessian's shifted adds),
  and every one within the reference's own golden bounds (max 5e-5, mean
  1e-6: tests/test_ridges.py); hessian3d off frangi's gamma knife edge;
* butterworth3d and homomorphic3d within 2e-6 of the jitted JAX op and
  2e-5 of the float64 golden;
* denoise_wavelet3d within 2e-6 of the JAX op run op by op
  (``jax.disable_jit()``: jitted, XLA:CPU's fused DWT adds turn exact-zero
  details into residues on odd extents) and of its golden.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mies_tpu.ops import frequency as JQ
from mies_tpu.ops import ridges as JR
from mies_tpu.ops import wavelet as JW
from mies_tpu_torch.ops import frequency as TQ
from mies_tpu_torch.ops import ridges as TR
from mies_tpu_torch.ops import wavelet as TW
from tests.goldens import golden_ops as G

torch.set_num_threads(2)

SHAPES = [(8, 24, 32), (7, 23, 31)]


def _volume(shape, seed=0) -> np.ndarray:
    """Background with dark tubes along z and y, plus noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]].astype(np.float32)
    v = 0.7 + 0.1 * np.sin(x / 7)
    v = v - 0.4 * np.exp(-((y - shape[1] / 2) ** 2 + (x - 9) ** 2) / 4)
    v = v - 0.3 * np.exp(-((z - shape[0] / 2) ** 2 + (x - 22) ** 2) / 3)
    v = v + 0.05 * rng.standard_normal(shape)
    return np.clip(v, 0.0, 1.0).astype(np.float32)


def _port(fn, vol, **kw):
    return fn(torch.from_numpy(vol), **kw).numpy()


def _jit(fn, vol, **kw):
    return np.asarray(jax.jit(lambda v: fn(v, **kw))(jnp.asarray(vol)))


def _lapack_by_magnitude(a):
    h = np.zeros(a.shape[1:] + (3, 3))
    h[..., 0, 0], h[..., 0, 1], h[..., 0, 2] = a[0], a[1], a[2]
    h[..., 1, 0], h[..., 1, 1], h[..., 1, 2] = a[1], a[3], a[4]
    h[..., 2, 0], h[..., 2, 1], h[..., 2, 2] = a[2], a[4], a[5]
    eig = np.linalg.eigvalsh(h.astype(np.float64))
    return np.take_along_axis(eig, np.argsort(np.abs(eig), axis=-1), -1)


def test_eigvalsh3_matches_lapack_and_the_reference():
    a = np.random.default_rng(0).normal(size=(6, 24, 24)).astype(np.float32)
    got = TR._eigvalsh3_by_magnitude(*torch.from_numpy(a))
    with jax.disable_jit():
        ref = JR._eigvalsh3_by_magnitude(*jnp.asarray(a))
    eig = _lapack_by_magnitude(a)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), eig[..., i], atol=5e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=1e-6, rtol=0)


def test_eigvalsh3_near_repeated_roots():
    """Rotations of diag(a, a + delta, b): two roots delta apart, down to a
    double root. There r = det(B) / 2 nears +-1 and acos amplifies one ulp
    of r to about sqrt(ulp) of the roots: the closed form's own error
    against LAPACK reaches 5e-4 (the reference's, jitted, as much); the
    port stays within 5e-6 of the reference run op by op (the ops' bound)
    and the isotropic fallback gives a scaled identity its triple root."""
    rng = np.random.default_rng(1)
    mats = []
    for delta in (0.0, 1e-6, 1e-4, 1e-2):
        for _ in range(64):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            a, b = rng.normal(size=2)
            mats.append(q @ np.diag([a, a + delta, b]) @ q.T)
    m = np.asarray(mats, np.float32)
    comps = np.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2], m[:, 1, 1],
                      m[:, 1, 2], m[:, 2, 2]])
    got = TR._eigvalsh3_by_magnitude(*torch.from_numpy(comps))
    with jax.disable_jit():
        ref = JR._eigvalsh3_by_magnitude(*jnp.asarray(comps))
    eig = _lapack_by_magnitude(comps)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=5e-6, rtol=0)
        np.testing.assert_allclose(got[i].numpy(), eig[..., i], atol=1e-3)
    iso = TR._eigvalsh3_descending(*(torch.full((4,), v)
                                     for v in (0.7, 0, 0, 0.7, 0, 0.7)))
    for e in iso:
        np.testing.assert_allclose(e.numpy(), 0.7, atol=1e-6)


RIDGES = [
    ("frangi3d", {"sigmas": (1.0, 2.0)}, 2e-6),
    ("vessel_enhance3d", {"sigmas": (1.0,), "amount": 0.8}, 2e-6),
    ("sato3d", {"sigmas": (1.0, 2.0)}, 5e-6),
    ("meijering3d", {"sigmas": (1.0, 2.0)}, 5e-6),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op,kw,atol", RIDGES, ids=[r[0] for r in RIDGES])
def test_ridge3d_within_the_jitted_reference(shape, op, kw, atol):
    vol = _volume(shape)
    if shape == SHAPES[1]:  # one scale on the ragged shape: compile time
        kw = {**kw, "sigmas": (1.0,)}
    np.testing.assert_allclose(_port(getattr(TR, op), vol, **kw),
                               _jit(getattr(JR, op), vol, **kw),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("op,golden", [
    ("frangi3d", G.frangi3d_vesselness), ("sato3d", G.sato3d_tubeness),
    ("meijering3d", G.meijering3d_neuriteness)])
def test_ridge3d_within_the_golden_bounds(op, golden):
    vol = np.random.default_rng(2).random((12, 28, 30)).astype(np.float32)
    d = np.abs(_port(getattr(TR, op), vol, sigmas=(1.0, 2.0))
               - golden(vol, sigmas=(1.0, 2.0)))
    assert d.max() < 5e-5 and d.mean() < 1e-6


def test_frangi3d_selects_a_dark_tube():
    tube = np.full((16, 32, 32), 0.8, np.float32)
    _, yy, xx = np.mgrid[0:16, 0:32, 0:32]
    tube[(yy - 16) ** 2 + (xx - 16) ** 2 <= 4] = 0.2
    v = _port(TR.frangi3d, tube, sigmas=(1.0, 2.0))
    assert v[8, 16, 16] > 0.5 and v[8, 4, 4] < 1e-3


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_hessian3d_off_the_knife_edge(shape):
    """At gamma 0.5 (off frangi's 1 - exp(-S^2 / 2 gamma^2) knife edge at
    skimage's gamma 15) within 1e-5 of the jitted op and the golden; the
    <= 0 -> 1 map included."""
    vol = _volume(shape, seed=3)
    kw = {"sigmas": (1.0,), "gamma": 0.5}
    got = _port(TR.hessian3d, vol, **kw)
    fr = G.frangi3d_vesselness(vol, sigmas=(1.0,), gamma=0.5)
    knife = np.abs(fr) <= 1e-6
    assert knife.mean() < 0.9 and (got == 1.0).any()
    np.testing.assert_allclose(got[~knife], _jit(JR.hessian3d, vol, **kw)[
        ~knife], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[~knife], G.hessian3d_ridge(vol, **kw)[
        ~knife], atol=1e-5, rtol=0)


FREQ = [
    ("butterworth3d", {"cutoff_frequency_ratio": 0.08}, G.butterworth_filter),
    ("butterworth3d", {"cutoff_frequency_ratio": 0.1, "high_pass": False,
                       "order": 3.0, "squared_butterworth": False,
                       "npad": 3}, G.butterworth_filter),
    ("homomorphic3d", {}, lambda v, **kw: G.homomorphic_filter(v, npad=8)),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op,kw,golden", FREQ,
                         ids=["butterworth3d", "butterworth3d_lowpass",
                              "homomorphic3d"])
def test_frequency3d_within_2e6_and_the_golden(shape, op, kw, golden):
    vol = _volume(shape, seed=4)
    got = _port(getattr(TQ, op), vol, **kw)
    np.testing.assert_allclose(got, _jit(getattr(JQ, op), vol, **kw),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, golden(vol, **kw), atol=2e-5, rtol=0)


WAVELET = [
    (SHAPES[0], {}),
    (SHAPES[1], {"wavelet": "db2", "mode": "hard", "method": "VisuShrink",
                 "sigma": 0.05}),
]


@pytest.mark.parametrize("shape,kw", WAVELET,
                         ids=["defaults-even", "db2_visu_sigma-ragged"])
def test_denoise_wavelet3d_within_2e6_of_the_op_by_op_reference(shape, kw):
    vol = _volume(shape, seed=5)
    with jax.disable_jit():
        want = np.asarray(JW.denoise_wavelet3d(jnp.asarray(vol), **kw))
    np.testing.assert_allclose(_port(TW.denoise_wavelet3d, vol, **kw), want,
                               atol=2e-6, rtol=0)


def test_denoise_wavelet3d_matches_the_golden():
    rng = np.random.default_rng(6)
    vol = np.clip(np.linspace(0.2, 0.8, 32, dtype=np.float32)
                  + rng.normal(0, 0.06, (16, 32, 32)), 0, 1).astype(np.float32)
    np.testing.assert_allclose(_port(TW.denoise_wavelet3d, vol),
                               G.denoise_wavelet(vol), atol=2e-6, rtol=0)
