"""The port's restoration ops and chains against the JAX package, on CPU.

The same seeded numpy inputs go through the JAX function (its batched
dispatcher, which takes the vmapped jnp op on the CPU, or its Pallas kernel
in interpret mode) and its port (plain PyTorch: on a CPU tensor every
kernel wrapper runs its plain version). Tolerances are the JAX package's
own contracts for its kernels (tests/test_kernels.py): NL-means and TV
atol 2e-6, Perona-Malik and SRAD atol 1e-6, since XLA:CPU contracts the
twins' multiply-adds into FMAs where the port rounds every product (and TV
sums its energies in another order); the pyramids atol 1e-6 against cv2
and MUSICA 2e-5 against its cv2 golden (tests/test_pyramid.py), 4e-6
against the jitted JAX op; the
chains' uint8 output within 1 level on < 1e-3 of pixels.
"""

import inspect
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mies_tpu
import mies_tpu_torch
import tests.goldens.golden_ops as G
from mies_tpu.kernels import diffusion as JD
from mies_tpu.kernels import nlmeans as JN
from mies_tpu.kernels import tv as JT
from mies_tpu.ops import filters as JF
from mies_tpu.ops import intensity as JI
from mies_tpu.ops import pyramid as JP
from mies_tpu.ops import restoration as JR
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import diffusion as KD
from mies_tpu_torch.kernels import nlmeans as KN
from mies_tpu_torch.kernels import tv as KT
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import intensity as TI
from mies_tpu_torch.ops import pyramid as TP
from mies_tpu_torch.ops import restoration as TR

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CT_YAML = REPO / "configs" / "ct_lowdose_nlm.yaml"
US_YAML = REPO / "configs" / "ultrasound_despeckle.yaml"
# BASELINE w8, w9 and w10 (benchmarks/workloads.py)
W8 = [("anisotropic_diffusion", {"niter": 6, "kappa": 0.05, "gamma": 0.2}),
      ("musica", {"levels": 5, "p": 0.6, "gain": 1.5})]
W9 = [("srad", {"niter": 15, "dt": 0.15}),
      ("clahe", {"clip_limit": 2.0, "grid_size": (8, 8),
                 "convention": "opencv"})]
W10 = [("window_hu", {"center": 40.0, "width": 400.0}),
       ("denoise_nl_means", {"patch_size": 5, "patch_distance": 6,
                             "h": 0.06, "sigma": 0.04})]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _speckle(rng, shape) -> np.ndarray:
    """Positive speckle-like float32 slices: a smooth mean times unit-mean
    gamma noise, clipped into (0, 1]."""
    mean = 0.3 + 0.3 * np.sin(np.arange(shape[-1]) / 9.0)[None, :]
    noise = rng.gamma(4.0, 0.25, shape)
    return np.clip(mean * noise, 0.01, 1.0).astype(np.float32)


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


# --- window_hu ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"center": 40.0, "width": 400.0},
    {"preset": "lung"},
    {"preset": "bone", "width": 1000.0},
])
def test_window_hu_equals_jax(rng, kw):
    hu = rng.integers(-1024, 2000, (2, 32, 48)).astype(np.int16)
    ref = np.asarray(JI.window_hu(jnp.asarray(hu), **kw))
    out = TI.window_hu(_t(hu), **kw)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_window_hu_levels_equal_float64_at_in_window_ties():
    """The uint8 levels of window_hu at center 40, width 400 (the CT
    configs' window) equal the exact levels, rint((hu + 160) * 255 / 400)
    in float64 (exact: one rounding of an integer quotient), at every HU
    of the window [-160, 240]. -120, -40, 40, 120 and 200 land on a tie
    (25.5, 76.5, 127.5, 178.5, 229.5), where a reciprocal multiply's ulp
    would pick the other level (the jitted reference does)."""
    from mies_tpu_torch.ops.histogram import _levels

    hu = np.arange(-160, 241, dtype=np.int16)
    exact = np.rint((hu.astype(np.float64) + 160.0) * 255.0 / 400.0)
    ties = np.isin(hu, (-120, -40, 40, 120, 200))
    assert (exact[ties] % 2 == 0).all() and np.array_equal(
        np.abs((hu[ties] + 160.0) * 255.0 / 400.0 - exact[ties]),
        np.full(5, 0.5))
    got = _levels(TI.window_hu(_t(hu), center=40.0, width=400.0)).numpy()
    np.testing.assert_array_equal(got, exact)


def test_window_hu_argument_errors():
    with pytest.raises(ValueError, match="unknown HU preset"):
        TI.window_hu(torch.zeros(4, 4, dtype=torch.int16), preset="spleen")
    with pytest.raises(ValueError, match="center"):
        TI.window_hu(torch.zeros(4, 4, dtype=torch.int16), center=40.0)


# --- NL-means (K11's plain version) -----------------------------------------


@pytest.mark.parametrize("shape,s,d,h,sigma", [
    ((2, 32, 48), 5, 6, 0.06, 0.04),   # configs/ct_lowdose_nlm.yaml, w10
    ((1, 24, 40), 4, 3, 0.1, 0.0),     # even patch -> s + 1, sigma 0
    ((2, 21, 19), 3, 2, 0.08, 0.02),   # odd sizes
])
def test_nl_means_matches_jax(rng, shape, s, d, h, sigma):
    x = rng.random(shape).astype(np.float32)
    ref = np.asarray(JN.nl_means_batched(jnp.asarray(x), patch_size=s,
                                         patch_distance=d, h=h, sigma=sigma))
    out = KN.nl_means_cuda(_t(x), s, d, h, sigma).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_half_shift_table_equals_jax():
    for d in (1, 3, 6, 11):
        np.testing.assert_array_equal(TR.half_shift_table(d),
                                      JR._half_shift_table(d, 2))
    assert len(TR.half_shift_table(6)) == 84


def test_nl_means_shared_memory_guard():
    """The kernel stages its tile and an s//2 + d halo in shared memory,
    and a pair's column sums and weights over the tile grown by d and
    s - 1: the one real limit, raised with its reason (no plain
    fallback)."""
    # 32 x 32 tile, s 5, d 6: 48 x 48 staged and 8 rows of padding, column
    # sums 46 x 43 and weights 38 x 47 (odd pitches, 8 rows / columns more
    # for the register windows)
    assert KN.shared_bytes(5, 6) == 4 * (56 * 48 + 46 * 43 + 38 * 47)
    KN.check_shared(7, 70)  # the largest halos still fit
    with pytest.raises(ValueError, match="shared memory"):
        KN.check_shared(7, 75)


# --- TV-Chambolle (K12's plain version) --------------------------------------


@pytest.mark.parametrize("weight,max_iter", [(0.1, 60), (0.03, 60)])
def test_tv_matches_jax(rng, weight, max_iter):
    x = rng.random((2, 48, 64)).astype(np.float32)
    ref = np.asarray(JT.denoise_tv_batched(jnp.asarray(x), weight, 2e-4,
                                           max_iter))
    out = KT.denoise_tv_cuda(_t(x), weight, 2e-4, max_iter).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_tv_each_slice_stops_on_its_own(rng):
    """A smooth slice converges long before a noisy one: each keeps the
    out of its own stop iteration (vmap-of-while semantics), equal to a
    run of that slice alone, and to the JAX package's vmapped loop."""
    ramp = np.tile(np.linspace(0, 1, 64, dtype=np.float32), (48, 1))
    smooth = ramp + rng.normal(0, 0.02, ramp.shape).astype(np.float32)
    noisy = rng.random((48, 64)).astype(np.float32)
    x = np.stack([smooth, noisy])
    out, iters = KT.denoise_tv_cuda(_t(x), 0.2, 2e-4, 200, return_iters=True)
    assert iters.dtype == torch.int32 and iters.shape == (2,)
    assert iters[0] != iters[1] and int(iters.max()) < 200, iters
    for i in range(2):
        alone, it = TR.tv_chambolle(_t(x[i:i + 1]), 0.2, 2e-4, 200)
        assert it.item() == iters[i].item()
        assert torch.equal(alone[0], out[i])
    ref = np.asarray(JT.denoise_tv_batched(jnp.asarray(x), 0.2, 2e-4, 200))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("where", ["top-left", "inside", "bottom-right"])
def test_tv_chunk_halo_covers_its_steps(where):
    """K12 runs kernels/tv.py STEPS steps on a tile and a halo of HALO
    pixels: those steps on the window (image edges where it meets them,
    window edges wrong elsewhere) equal, on the tile, the same steps on the
    whole slice: the last out, each step's d^2 and |g| (the energy sums)
    and the new dual field. A halo one pixel narrower does not. The launch
    passes HALO, and csrc/tv.cu refuses any other than the one it loads
    (test_k12_refuses_a_halo_it_does_not_load, on the card)."""
    rng = np.random.default_rng(5)
    x = _t(rng.random((1, 40, 52)).astype(np.float32))
    tau_w = TR.tv_constants((40, 52), 0.1, 2e-4)[2]
    p1 = p2 = torch.zeros_like(x)
    for _ in range(3):  # a dual field that is not zero
        p1, p2 = TR.tv_step(x, p1, p2, tau_w)[3:]
    th, tw = 10, 12
    y0, x0 = {"top-left": (0, 0), "inside": (15, 20),
              "bottom-right": (40 - th, 52 - tw)}[where]

    def run(a1, a2, img):
        seen = []
        for _ in range(KT.STEPS):
            cand, dd, norm, a1, a2 = TR.tv_step(img, a1, a2, tau_w)
            seen += [dd, norm]
        return [*seen, cand, a1, a2]

    whole = [f[:, y0:y0 + th, x0:x0 + tw] for f in run(p1, p2, x)]

    def on_window(halo):
        wy, wx = max(y0 - halo, 0), max(x0 - halo, 0)
        rows = slice(wy, min(y0 + th + halo, 40))
        cols = slice(wx, min(x0 + tw + halo, 52))
        got = run(p1[:, rows, cols], p2[:, rows, cols], x[:, rows, cols])
        return [f[:, y0 - wy:y0 - wy + th, x0 - wx:x0 - wx + tw] for f in got]

    assert KT.HALO == KT.STEPS
    assert all(torch.equal(a, b) for a, b in zip(on_window(KT.HALO), whole))
    if where == "inside":
        assert not all(torch.equal(a, b)
                       for a, b in zip(on_window(KT.HALO - 1), whole))


# --- Perona-Malik and SRAD (K9 and K10's plain versions) ---------------------


@pytest.mark.parametrize("option", [1, 2])
def test_perona_malik_matches_jax(rng, option):
    x = rng.random((3, 40, 64)).astype(np.float32)
    ref = np.asarray(JD.anisotropic_diffusion_batched(
        jnp.asarray(x), 9, 0.1, 0.2, option))
    out = KD.anisotropic_diffusion_cuda(_t(x), 9, 0.1, 0.2, option).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [
    {"niter": 15, "dt": 0.15},
    {"niter": 8, "dt": 0.25, "q0": 0.5, "rho": 0.1, "eps": 1e-4},
])
def test_srad_matches_jax(rng, kw):
    x = _speckle(rng, (2, 40, 56))
    ref = np.asarray(JD.srad_batched(jnp.asarray(x), **kw))
    out = KD.srad_cuda(_t(x), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("where", ["top-left", "inside", "bottom-right"])
def test_srad_chunk_halo_covers_its_steps(where):
    """K10 runs kernels/diffusion.py STEPS steps on a tile and its halo of
    HALO = (above / left, below / right) pixels: those steps, from a t0 >
    0, on the window (replicated edges and the virtual ring where it meets
    the image's edge, wrong values elsewhere) equal, on the tile, the same
    steps on the whole slice. A halo one pixel narrower on either side does
    not, in float32 and in float64 (float64 keeps the far reach visible at
    more steps: after 4, a pixel 8 rows below moves the tile by about 1e-16
    of its value, which float32 rounds away). The launch passes HALO, and
    csrc/diffusion.cu refuses any other than the one it loads
    (test_k10_refuses_a_halo_it_does_not_load, on the card)."""
    x = _t(_speckle(np.random.default_rng(6), (1, 40, 52)))
    th, tw, t0 = 10, 12, 5
    y0, x0 = {"top-left": (0, 0), "inside": (15, 20),
              "bottom-right": (40 - th, 52 - tw)}[where]

    def run(img):
        for t in range(t0, t0 + KD.STEPS):
            img = TR.srad_iteration(img, t, 0.15, 1.0, 0.2, 1e-6)
        return img

    def on_window(img, lo, hi):
        wy, wx = max(y0 - lo, 0), max(x0 - lo, 0)
        got = run(img[:, wy:min(y0 + th + hi, 40), wx:min(x0 + tw + hi, 52)])
        return got[:, y0 - wy:y0 - wy + th, x0 - wx:x0 - wx + tw]

    lo, hi = KD.HALO
    assert (lo, hi) == (KD.STEPS, 2 * KD.STEPS)
    for img in (x, x.double()):
        whole = run(img)[:, y0:y0 + th, x0:x0 + tw]
        assert torch.equal(on_window(img, lo, hi), whole)
        if where == "inside":
            assert not torch.equal(on_window(img, lo, hi - 1), whole)
            assert not torch.equal(on_window(img, lo - 1, hi), whole)


@pytest.mark.parametrize("niter,launches", [(1, 1), (4, 2), (5, 3), (15, 8)])
def test_srad_launches_per_call(niter, launches):
    """ceil(niter / STEPS) K10 launches (at the shipped 2 steps each)."""
    assert KD.STEPS == 2
    assert KD.launches_per_call(niter) == launches


@pytest.mark.parametrize("where", ["top-left", "inside", "bottom-right"])
def test_pm_chunk_halo_covers_its_steps(where):
    """K9 runs kernels/diffusion.py PM_STEPS Perona-Malik steps on a tile
    and its halo of PM_HALO pixels on every side: those steps on the window
    (the image's zero-flux border rule at the window's edges, wrong values
    where the window ends inside the image) equal, on the tile, the same
    steps on the whole slice, in float32 and float64. Inside the image a
    halo one pixel narrower on either side does not. The launch passes
    PM_HALO, and csrc/diffusion.cu refuses any other than the one it loads
    (test_k9_refuses_a_halo_it_does_not_load, on the card)."""
    x = _t(np.random.default_rng(7).random((1, 40, 52)).astype(np.float32))
    th, tw = 10, 12
    y0, x0 = {"top-left": (0, 0), "inside": (15, 20),
              "bottom-right": (40 - th, 52 - tw)}[where]
    # kappa 0.5: the noise's differences pass (at w8's 0.05 they stop
    # nearly all flux, and a narrower halo would change nothing)
    inv_k2, g32 = TR.pm_constants(0.5, 0.2)

    def run(img):
        for _ in range(KD.PM_STEPS):
            img = TR._pm_step(img, inv_k2, g32, 1)
        return img

    def on_window(img, lo, hi):
        wy, wx = max(y0 - lo, 0), max(x0 - lo, 0)
        got = run(img[:, wy:min(y0 + th + hi, 40), wx:min(x0 + tw + hi, 52)])
        return got[:, y0 - wy:y0 - wy + th, x0 - wx:x0 - wx + tw]

    halo = KD.PM_HALO
    assert halo == KD.PM_STEPS
    for img in (x, x.double()):
        whole = run(img)[:, y0:y0 + th, x0:x0 + tw]
        assert torch.equal(on_window(img, halo, halo), whole)
        if where == "inside":
            assert not torch.equal(on_window(img, halo, halo - 1), whole)
            assert not torch.equal(on_window(img, halo - 1, halo), whole)


@pytest.mark.parametrize("niter,launches", [(1, 1), (2, 1), (3, 1), (6, 2),
                                            (7, 3), (15, 5)])
def test_pm_launches_per_call(niter, launches):
    """ceil(niter / PM_STEPS) K9 launches (at the shipped 3 steps each):
    w8's 6 steps in 2."""
    assert KD.PM_STEPS == 3
    assert KD.pm_launches_per_call(niter) == launches


# --- box blur, Lee ------------------------------------------------------------


def test_box_blur_matches_jax(rng):
    x = rng.random((2, 30, 41)).astype(np.float32)
    for k, mode in ((3, "reflect"), (5, "nearest"), (7, "mirror")):
        ref = np.asarray(jax.jit(jax.vmap(lambda v: JF.box_blur(v, k, mode)))(
            jnp.asarray(x)))
        np.testing.assert_allclose(TF.box_blur(_t(x), k, mode).numpy(), ref,
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("sigma", [0.03, None])
def test_lee_filter_matches_jax_per_slice(rng, sigma):
    """sigma=None estimates each slice's own noise (its mean local
    variance), never the batch's: a quiet and a loud slice together give
    what each gives alone."""
    x = np.stack([_speckle(rng, (40, 56)) * 0.2, _speckle(rng, (40, 56))])
    ref = np.asarray(jax.jit(jax.vmap(lambda v: JF.lee_filter(v, 5, sigma)))(
        jnp.asarray(x)))
    out = TF.lee_filter(_t(x), 5, sigma)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    for i in range(2):
        assert torch.equal(TF.lee_filter(_t(x[i]), 5, sigma), out[i])


# --- pyramids and MUSICA ------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (65, 63), (17, 33)])
def test_pyramids_match_cv2_and_jax(rng, shape):
    img = rng.random(shape).astype(np.float32)
    down = TP.pyr_down(_t(img)).numpy()
    np.testing.assert_allclose(down, cv2.pyrDown(img), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        down, np.asarray(jax.jit(JP.pyr_down)(jnp.asarray(img))), atol=1e-6,
        rtol=0)
    small = cv2.pyrDown(img)
    up = TP.pyr_up(_t(small), shape).numpy()
    np.testing.assert_allclose(up, cv2.pyrUp(small, dstsize=shape[::-1]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        up, np.asarray(jax.jit(lambda v: JP.pyr_up(v, shape))(
            jnp.asarray(small))), atol=1e-6, rtol=0)
    # batched: every leading index its own slice
    both = np.stack([img, img[::-1].copy()])
    assert torch.equal(TP.pyr_down(_t(both))[1], TP.pyr_down(_t(both[1])))


@pytest.mark.parametrize("kw", [
    {"levels": 5, "p": 0.6, "gain": 1.5},          # BASELINE w8
    {"levels": 3, "p": 1.0, "gain": (2.0, 1.5, 1.0)},
])
def test_musica_matches_jax_and_golden(rng, kw):
    x = rng.random((2, 64, 72)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda v: JP.musica(v, **kw)))(
        jnp.asarray(x)))
    out = TP.musica(_t(x), **kw).numpy()
    # jit lets XLA:CPU contract the pyramid's multiply-adds into FMAs
    # over five levels of pyr_up: a few ulp of values in [0, 1]
    np.testing.assert_allclose(out, ref, atol=4e-6, rtol=0)
    np.testing.assert_allclose(out[0], G.musica(x[0], **kw), atol=2e-5)


def test_musica_argument_errors():
    z = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="p must be"):
        TP.musica(z, p=0.0)
    with pytest.raises(ValueError, match="levels"):
        TP.musica(z, levels=0)
    with pytest.raises(ValueError, match="too small"):
        TP.musica(torch.zeros(8, 8), levels=4)
    with pytest.raises(ValueError, match="gain"):
        TP.musica(z, levels=3, gain=(1.0, 2.0))
    with pytest.raises(ValueError, match="out_shape"):
        TP.pyr_up(torch.zeros(16, 16), (34, 32))


# --- the plain versions against the TPU kernels (Pallas interpret mode) ------


def test_k9_plain_matches_pallas_perona_malik(rng):
    x = rng.random((3, 64, 128)).astype(np.float32)
    ref = np.asarray(JD.anisotropic_diffusion_tpu(
        jnp.asarray(x), 9, 0.1, 0.2, 1, interpret=True))
    out = KD.anisotropic_diffusion_cuda(_t(x), 9, 0.1, 0.2, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_k10_plain_matches_pallas_srad(rng):
    x = (0.4 + 0.1 * rng.standard_normal((2, 64, 128))).clip(
        0.01, 1.0).astype(np.float32)
    ref = np.asarray(JD.srad_tpu(jnp.asarray(x), 8, interpret=True))
    np.testing.assert_allclose(KD.srad_cuda(_t(x), 8).numpy(), ref,
                               atol=1e-6, rtol=0)


def test_k11_plain_matches_pallas_nl_means(rng, monkeypatch):
    # the Pallas kernel's exact shift-sum box form (its MXU 'dot' form
    # holds only 2e-3 on the chip)
    monkeypatch.setenv("MIES_TPU_NLM_BOX", "shift")
    x = rng.random((1, 16, 128)).astype(np.float32)
    ref = np.asarray(JN.nl_means_tpu(jnp.asarray(x), patch_size=4,
                                     patch_distance=3, h=0.1, interpret=True))
    out = KN.nl_means_cuda(_t(x), 4, 3, 0.1).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_k12_plain_matches_pallas_tv(rng):
    x = rng.random((2, 64, 128)).astype(np.float32)
    ref = np.asarray(JT.denoise_tv_tpu(jnp.asarray(x), 0.1, 2e-4, 60,
                                       interpret=True))
    np.testing.assert_allclose(
        KT.denoise_tv_cuda(_t(x), 0.1, 2e-4, 60).numpy(), ref, atol=2e-6,
        rtol=0)


# --- the argument errors, the defaults, the wrappers on the CPU ----------------


@pytest.mark.parametrize("jax_fn,torch_fn,shape,kw,match", [
    (JD.anisotropic_diffusion_batched, KD.anisotropic_diffusion_cuda,
     (1, 8, 16), {"niter": 0}, "niter"),
    (JD.anisotropic_diffusion_batched, KD.anisotropic_diffusion_cuda,
     (1, 8, 16), {"option": 5}, "option"),
    (JD.srad_batched, KD.srad_cuda, (1, 8, 16), {"niter": 0}, "niter"),
    (JD.srad_batched, KD.srad_cuda, (1, 8, 16), {"dt": 0.3}, "dt"),
    (JD.srad_batched, KD.srad_cuda, (1, 8, 16), {"q0": -1.0}, "q0"),
    (JT.denoise_tv_batched, KT.denoise_tv_cuda, (1, 8, 16),
     {"max_num_iter": 0}, "max_num_iter"),
    (JN.nl_means_batched, KN.nl_means_cuda, (1, 8, 16),
     {"patch_size": 5, "patch_distance": 6}, "patch_distance"),
])
def test_argument_errors_are_the_references(jax_fn, torch_fn, shape, kw,
                                            match):
    with pytest.raises(ValueError, match=match):
        jax_fn(jnp.zeros(shape, jnp.float32), **kw)
    with pytest.raises(ValueError, match=match):
        torch_fn(torch.zeros(shape), **kw)


@pytest.mark.parametrize("batched,op,ref", [
    (KN.nl_means_batched, TR.denoise_nl_means, JR.denoise_nl_means),
    (KT.denoise_tv_batched, TR.denoise_tv, JR.denoise_tv),
    (KD.srad_batched, TR.srad, JR.srad),
    (KD.anisotropic_diffusion_batched, TR.anisotropic_diffusion,
     JR.anisotropic_diffusion),
])
def test_batched_defaults_equal_op_defaults(batched, op, ref):
    """The compiler binds omitted config params from the batched
    wrapper's signature: its defaults must be the op's, and the op's the
    reference's (the NL-means patch_distance=11 included)."""
    sb = inspect.signature(batched).parameters
    so = inspect.signature(op).parameters
    sr = inspect.signature(ref).parameters
    names = [n for n in sr if n not in ("img",)]
    for name in names:
        assert sb[name].default == so[name].default == sr[name].default, name


def test_wrappers_count_no_launch_on_cpu(rng):
    _build.reset_launches()
    x = _t(_speckle(rng, (2, 24, 32)))
    KN.nl_means_cuda(x, 3, 2, 0.1)
    KT.denoise_tv_cuda(x, 0.1, 2e-4, 5)
    KD.srad_cuda(x, 2)
    KD.anisotropic_diffusion_cuda(x, 2, 0.1, 0.2)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)


def test_wrappers_reject_bad_tensors():
    for fn in (KN.nl_means_cuda, KT.denoise_tv_cuda, KD.srad_cuda,
               KD.anisotropic_diffusion_cuda):
        with pytest.raises(TypeError):
            fn(torch.zeros(1, 16, 16, dtype=torch.float64))
        with pytest.raises(ValueError):
            fn(torch.zeros(16, 16))


# --- configs: validation and the chains end to end ---------------------------


@pytest.mark.parametrize("path", [CT_YAML, US_YAML])
def test_yaml_loads_the_same_in_both_packages(path):
    assert (mies_tpu_torch.load_config(path).to_dict()
            == mies_tpu.load_config(path).to_dict())


@pytest.mark.parametrize("stage,match", [
    ({"op": "srad", "dt": 0.5}, "dt=0.5"),
    ({"op": "anisotropic_diffusion", "option": 3}, "option=3"),
    ({"op": "lee_filter", "kernel_size": 4}, "kernel_size=4"),
    ({"op": "denoise_nl_means", "patch_distance": 0}, "patch_distance=0"),
    ({"op": "denoise_tv", "max_num_iter": 0}, "max_num_iter=0"),
    ({"op": "window_hu", "preset": "spleen"}, "preset='spleen'"),
    ({"op": "musica", "p": 1.5}, "p=1.5"),
    ({"op": "musica", "sigma": 1.0}, "does not accept param 'sigma'"),
])
def test_bad_restoration_config_raises_at_load(tmp_path, stage, match):
    p = tmp_path / "cfg.json"
    p.write_text('{"name": "t", "pipeline": [%s]}'
                 % str(stage).replace("'", '"'))
    with pytest.raises(ValueError, match=match):
        mies_tpu_torch.load_config(p)
    with pytest.raises(ValueError):
        mies_tpu.load_config(p)


def _ct_batch() -> np.ndarray:
    """Two int16 64x64 HU slices: soft tissue in air with a bone ring
    and noise (the crops cross the body's edge and the ring)."""
    rng = np.random.default_rng(2042)
    y, x = np.mgrid[0:96, 0:96].astype(np.float32)
    r = np.sqrt((y - 60) ** 2 + (x - 60) ** 2)
    hu = np.where(r < 50, 40.0, -1000.0) + np.where(np.abs(r - 45) < 3, 700, 0)
    hu = hu + 15.0 * rng.standard_normal(hu.shape)
    return np.stack([hu[:64, :64], hu[32:, 32:]]).astype(np.int16)


@pytest.mark.parametrize("name", ["ct_lowdose_nlm", "ultrasound_despeckle",
                                  "w8", "w9", "w10"])
def test_chain_matches_jax(rng, name):
    if name == "ct_lowdose_nlm":
        jcfg, tcfg = mies_tpu.load_config(CT_YAML), mies_tpu_torch.load_config(
            CT_YAML)
        x = _ct_batch()
    elif name == "ultrasound_despeckle":
        jcfg, tcfg = mies_tpu.load_config(US_YAML), mies_tpu_torch.load_config(
            US_YAML)
        x = np.rint(_speckle(rng, (2, 64, 64)) * 255).astype(np.uint8)
    else:
        stages = {"w8": W8, "w9": W9, "w10": W10}[name]
        jcfg = mies_tpu.PipelineConfig.make(stages, name=name)
        tcfg = mies_tpu_torch.PipelineConfig.make(stages, name=name)
        x = _ct_batch() if name == "w10" else _speckle(rng, (2, 64, 64))
    ref = np.asarray(mies_tpu.compile_pipeline(jcfg, batched=True,
                                               donate=False)(jnp.asarray(x)))
    _build.reset_launches()
    out = mies_tpu_torch.compile_pipeline(tcfg, batched=True, device="cpu")(x)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)
    assert out.dtype == torch.uint8 and tuple(out.shape) == x.shape
    _levels_close(out.numpy(), ref)


def test_compile_pipeline_defaults_to_the_card(monkeypatch):
    """Without a card the default device raises: nothing carries on on
    the CPU unless the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mies_tpu_torch.load_config(US_YAML)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mies_tpu_torch.compile_pipeline(cfg, batched=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mies_tpu_torch.pipeline.compiler.build_chain(cfg)
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        mies_tpu_torch.compile_pipeline(cfg, device="meta")
    x = np.full((1, 32, 32), 100, np.uint8)
    out = mies_tpu_torch.compile_pipeline(cfg, batched=True, device="cpu")(x)
    assert out.device.type == "cpu" and out.dtype == torch.uint8
