"""The port's kernel wrappers (mies_tpu_torch.kernels).

On the CPU each wrapper runs its plain version; those plain versions are
held here against the TPU kernels they replace, run in Pallas interpret
mode as tests/test_kernels.py runs them. The CUDA kernels themselves
compile and run only on the card: the tests that launch them carry the
``cuda`` marker (registered in pyproject.toml) and take the ``cuda_device``
fixture, which skips without a card. They need neither jax nor
tests/conftest.py, so on a card without jax they run as
``python -m pytest tests/test_torch_kernels.py --noconftest -m cuda``;
chip_smoke.py runs the same comparisons at the main path's shapes.
"""

import hashlib

import numpy as np
import pytest
import torch
from pytest import skip

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import bilateral as KB
from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.kernels import diffusion as KD
from mies_tpu_torch.kernels import nlmeans as KN
from mies_tpu_torch.kernels import tv as KT
from mies_tpu_torch.kernels import unsharp_gauss as KU
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.ops import restoration as TR

torch.set_num_threads(2)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """<= 1 uint8 level on < 0.1% of pixels (XLA:CPU FMA rounding ties)."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


# --- plain versions against the TPU kernels (Pallas interpret mode) -------


def test_k1_plain_equals_pallas_hist_rows(rng):
    import jax.numpy as jnp
    from mies_tpu.kernels.clahe import tile_hists_rows_pallas

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(tile_hists_rows_pallas(
        jnp.asarray(x), 2, 2, interpret=True, quantize_input=True))
    u8, _, _ = TH._pad_reflect101(TH._levels(torch.from_numpy(x)), (2, 2),
                                  "opencv")
    counts = TH._tile_histograms(u8, (2, 2)).reshape(2, 2, 2, 256)
    np.testing.assert_array_equal(counts.numpy(), ref)
    np.testing.assert_array_equal(
        KC.tile_hists(torch.from_numpy(x), (2, 2)).numpy(), ref)


def test_k2_plain_matches_pallas_apply33(rng):
    import jax.numpy as jnp
    from mies_tpu.kernels.clahe import clahe_apply_lut

    x = rng.random((2, 128, 128)).astype(np.float32)
    luts = np.rint(rng.random((2, 2, 2, 256)).astype(np.float32) * 255)
    ref = np.asarray(clahe_apply_lut(
        jnp.asarray(x), jnp.asarray(luts), (2, 2), integer_luts=True,
        interpret=True, quantize_input=True, finalize="u8norm"))
    out = KC.clahe_apply_lut(torch.from_numpy(x), torch.from_numpy(luts),
                             (2, 2)).numpy()
    _levels_close(np.rint(out * 255), np.rint(ref * 255))


def test_k3_plain_matches_pallas_bilateral(rng):
    import jax.numpy as jnp
    from mies_tpu.kernels.bilateral import bilateral_tpu

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(bilateral_tpu(jnp.asarray(x), 5, 0.1, 1.5, "reflect",
                                   interpret=True))
    out = KB.bilateral_cuda(torch.from_numpy(x), 5, 0.1, 1.5, "reflect")
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("quantize", [True, False])
def test_k4_plain_matches_pallas_unsharp_quant(rng, quantize):
    import jax.numpy as jnp
    from mies_tpu.kernels.unsharp_gauss import unsharp_quant_tpu

    x = rng.random((2, 128, 128)).astype(np.float32)
    ref = np.asarray(unsharp_quant_tpu(jnp.asarray(x), 1.5, 1.0,
                                       quantize=quantize, interpret=True))
    out = KU.unsharp_quant_cuda(torch.from_numpy(x), 1.5, 1.0,
                                quantize=quantize).numpy()
    if quantize:
        assert out.dtype == np.uint8
        _levels_close(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


# one [1, 64, 64] image: bilateral_tpu takes heights that are multiples of
# 32, unsharp_quant_tpu of 64
@pytest.mark.parametrize("mode", ["mirror", "nearest"])
@pytest.mark.parametrize("k", [3, 7, 9])
def test_k3_plain_matches_pallas_bilateral_at_every_size(k, mode):
    import jax.numpy as jnp
    from mies_tpu.kernels.bilateral import bilateral_tpu

    x = np.random.default_rng(21).random((1, 64, 64)).astype(np.float32)
    ref = np.asarray(bilateral_tpu(jnp.asarray(x), k, 0.1, 1.5, mode,
                                   interpret=True))
    out = KB.bilateral_cuda(torch.from_numpy(x), k, 0.1, 1.5, mode)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("radius", [1.0, 4.0])  # r 4 and r 16
def test_k4_plain_matches_pallas_unsharp_quant_radii(radius):
    import jax.numpy as jnp
    from mies_tpu.kernels.unsharp_gauss import unsharp_quant_tpu

    x = np.random.default_rng(22).random((1, 64, 64)).astype(np.float32)
    ref = np.asarray(unsharp_quant_tpu(jnp.asarray(x), radius, 1.0,
                                       interpret=True))
    out = KU.unsharp_quant_cuda(torch.from_numpy(x), radius, 1.0).numpy()
    assert out.dtype == np.uint8
    _levels_close(out, ref)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (65, 129)])
def test_k3_k4_plain_match_jax_on_tiny_and_ragged_shapes(shape):
    """Shapes the Pallas wrappers refuse, against the JAX package's XLA
    functions: the bilateral in each border within 2e-6, the unsharp tail
    (with the compiler's quantize) within the uint8 rule."""
    import jax
    import jax.numpy as jnp
    from mies_tpu.ops import filters as JF
    from mies_tpu.pipeline.compiler import _quantize_u8

    x = np.random.default_rng(23).random(shape).astype(np.float32)
    t = torch.from_numpy(x[None])
    bilateral = jax.jit(JF.bilateral_blur, static_argnums=(1, 2, 3, 4))
    for k, mode in ((3, "mirror"), (5, "reflect"), (9, "nearest")):
        ref = np.asarray(bilateral(jnp.asarray(x), k, 0.1, 1.5, mode))
        np.testing.assert_allclose(
            KB.bilateral_cuda(t, k, 0.1, 1.5, mode)[0].numpy(), ref,
            atol=2e-6, rtol=0)
    for radius in (1.0, 1.5, 4.0):
        ref = np.asarray(_quantize_u8(JF.unsharp_mask(jnp.asarray(x), radius,
                                                      1.0)))
        _levels_close(KU.unsharp_quant_cuda(t, radius, 1.0)[0].numpy(), ref)


# --- the wrappers on CPU tensors -------------------------------------------


@pytest.mark.parametrize("shape,grid", [((2, 64, 64), (4, 4)),
                                        ((2, 61, 83), (4, 4)),
                                        ((1, 251, 333), (8, 8))])
def test_clahe_cuda_composition_equals_plain_clahe(rng, shape, grid):
    """K1 -> LUT build -> K2 (plain versions on the CPU) is the whole
    plain CLAHE, ragged shapes included."""
    x = torch.from_numpy(rng.random(shape).astype(np.float32))
    assert torch.equal(KC.clahe_cuda(x, 2.0, grid), TH.clahe(x, 2.0, grid))


def test_wrappers_count_no_launch_on_cpu(rng):
    _build.reset_launches()
    x = torch.from_numpy(rng.random((2, 64, 64)).astype(np.float32))
    KC.clahe_batched(x, 2.0, (4, 4))
    KB.bilateral_batched(x)
    KU.unsharp_quant_cuda(x, 1.5, 1.0)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros(2, 64, 64, dtype=torch.float64), TypeError),
    (torch.zeros(64, 64), ValueError),
    (torch.zeros(2, 64, 128)[:, :, ::2], ValueError),
])
def test_wrappers_reject_bad_tensors(bad, exc):
    with pytest.raises(exc):
        KC.tile_hists(bad, (4, 4))
    with pytest.raises(exc):
        KB.bilateral_cuda(bad)
    with pytest.raises(exc):
        KU.unsharp_quant_cuda(bad, 1.5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 32, 32)
    with pytest.raises(ValueError):
        KB.bilateral_cuda(x, kernel_size=11)
    with pytest.raises(ValueError):
        KB.bilateral_cuda(x, mode="constant")
    with pytest.raises(ValueError):
        KU.unsharp_quant_cuda(x, radius=5.0)  # 20-pixel halo > 16
    with pytest.raises(ValueError):
        KC.clahe_apply_lut(x, torch.zeros(1, 4, 4, 255), (4, 4))
    with pytest.raises(ValueError):
        KC.tile_hists(torch.zeros(1, 3, 3), (0, 8))  # no tile grid
    # a pad longer than the image is taken, as cv2 takes it
    # (tests/test_torch_clahe_cv2.py)
    assert KC.tile_hists(torch.zeros(1, 3, 3), (8, 8)).sum() == 8 * 8 * 1
    assert KU.unsharp_quant_supported(1.5)
    assert not KU.unsharp_quant_supported(5.0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc -> RuntimeError; nothing runs its plain version instead."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_HOMES", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(_build, "_lib", None)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.launch("tile_hists", "mies_tile_hists", torch.device("cuda"))
    assert _build.LAUNCHES["tile_hists"] == 0


def test_build_digest_covers_the_headers(monkeypatch, tmp_path):
    """A csrc/*.cuh edit changes the digest, so the library is rebuilt."""
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    assert _build._digest() == before
    (tmp_path / "b.cuh").write_text("// two\n")
    after = _build._digest()
    assert after != before
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n// a\n')
    assert _build._digest() != after
    assert _build._sources() == [tmp_path / "a.cu"]  # headers build no object


# --- the CUDA kernels against their plain versions (card only) -------------


def _on(device, shape, seed: int) -> torch.Tensor:
    a = np.random.default_rng(seed).random(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid", [((3, 128, 128), (2, 2)),
                                        ((2, 251, 333), (8, 8)),
                                        # tiles of 502 x 400: strips of rows
                                        ((1, 1003, 1200), (2, 3))])
def test_k1_k2_on_card_equal_plain(cuda_device, shape, grid):
    """The opencv CLAHE is K1 to the LUTs -> K2, one launch each; K1's
    float mode (fraction, clahe3d) counts as its plain version."""
    x = _on(cuda_device, shape, 1)
    _build.reset_launches()
    got = KC.clahe_cuda(x, 2.0, grid)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "tile_luts": 1, "clahe_apply_lut": 1}
    assert torch.equal(KC.tile_hists(x, grid), KC.tile_hists_plain(x, grid))
    assert torch.equal(got, TH.clahe(x, 2.0, grid))


def _xray(device, shape, seed: int) -> torch.Tensor:
    """Smooth glow, a flat background at one level and noise: hot bins."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    glow = np.exp(-(((y - h / 2) ** 2 + (x - w / 2) ** 2) / (0.2 * h * w)))
    img = 0.6 * glow + 0.03 * rng.standard_normal(shape)
    img[:, :, : w // 4] = 0.0  # flat: one level over whole tiles
    return torch.from_numpy(np.clip(img, 0, 1).astype(np.float32)).to(device)


# K1 to the LUTs: one block per tile (512^2), tiles split over blocks with
# the last arrival building the LUT (1024^2 at 8x8: 2 blocks a tile; 4096^2:
# 32), ragged tiles (cv2's pad on one ragged axis; 251x333 at (6, 5)), and
# rows that are not 16-byte aligned
@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid", [((32, 512, 512), (8, 8)),
                                        ((2, 1024, 1024), (8, 8)),
                                        ((1, 4096, 4096), (8, 8)),
                                        ((2, 67, 128), (8, 8)),
                                        ((2, 251, 333), (6, 5))])
@pytest.mark.parametrize("clip", [2.0, 0.01, 40.0])
def test_tile_luts_on_card_equal_plain(cuda_device, shape, grid, clip):
    for x in (_on(cuda_device, shape, 2), _xray(cuda_device, shape, 3)):
        _build.reset_launches()
        got = KC.tile_luts(x, grid, clip)
        assert _build.LAUNCHES["tile_luts"] == 1
        want = KC.tile_luts_plain(x, grid, clip)
        assert torch.equal(got, want), (got - want).abs().max().item()
        # a second call (fresh scratch, zeroed when tiles split) gives the
        # same LUTs
        assert torch.equal(KC.tile_luts(x, grid, clip), want)


@pytest.mark.cuda
def test_clahe_kernels_on_card_take_unaligned_rows(cuda_device):
    """A contiguous tensor 4 bytes off a 16-byte boundary: the kernels
    read it pixel by pixel and still equal their plain versions."""
    base = _on(cuda_device, (2 * 128 * 128 + 1,), 4)
    x = base[1:].view(2, 128, 128)
    assert x.data_ptr() % 16 != 0
    luts = KC.tile_luts(x, (4, 4), 2.0)
    assert torch.equal(luts, KC.tile_luts_plain(x, (4, 4), 2.0))
    assert torch.equal(KC.tile_hists(x, (4, 4)), KC.tile_hists_plain(x, (4, 4)))
    assert torch.equal(KC.clahe_apply_lut(x, luts, (4, 4)),
                       KC.clahe_apply_lut_plain(x, luts, (4, 4)))


@pytest.mark.cuda
def test_tile_luts_on_card_refuse_tiles_of_2_24_pixels(cuda_device):
    """Past 2**24 pixels a tile's f32 counts in the reference stop being
    exact integers: the kernel's wrapper raises before any launch."""
    _build.reset_launches()
    with pytest.raises(ValueError, match="2\\*\\*24"):
        KC.tile_luts(torch.empty((1, 4096, 4096), device=cuda_device), (1, 1),
                     2.0)
    assert _build.LAUNCHES["tile_luts"] == 0


# K1 float and bins, and K2 in both epilogues, at the 4096^2 slice of the
# sharded chain (tiles and cells in strips of rows) and on the X-ray image
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 512, 512), (1, 4096, 4096)])
def test_k1_k2_on_card_equal_plain_at_main_path_shapes(cuda_device, shape):
    x = _xray(cuda_device, shape, 5)
    assert torch.equal(KC.tile_hists(x, (8, 8)), KC.tile_hists_plain(x, (8, 8)))
    bins = torch.clamp((x * 256).to(torch.int32), 0, 255).contiguous()
    tile = (shape[1] // 8 - 4, shape[2] // 8 - 4)  # 16-byte rows
    assert torch.equal(KC.tile_hists_bins(bins, (8, 8), (8, 8), tile, 256),
                       KC.tile_hists_bins_plain(bins, (8, 8), (8, 8), tile, 256))
    counts = KC.tile_hists(x, (8, 8)).reshape(shape[0], 64, 256).float()
    area = shape[1] * shape[2] // 64
    for fin, luts in (("u8norm", KC.tile_luts(x, (8, 8), 2.0)),
                      ("clip01", TH._luts_fraction(counts, 0.01, area)
                       .reshape(shape[0], 8, 8, 256))):
        got = KC.clahe_apply_lut(x, luts, (8, 8), fin)
        want = KC.clahe_apply_lut_plain(x, luts, (8, 8), fin)
        assert torch.equal(got, want), (fin, (got - want).abs().max().item())


# K3 walks strips of 128 columns down runs of 32 rows with pair weights in
# rings of r + 1 rows: shapes below, across and beyond one strip and run
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 3), (2, 5, 130),
                                   (2, 77, 130), (1, 513, 511)])
@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest"])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_k3_on_card_matches_plain(cuda_device, mode, k, shape):
    x = _on(cuda_device, shape, 2)
    _build.reset_launches()
    got = KB.bilateral_cuda(x, k, 0.1, 1.5, mode)
    assert _build.LAUNCHES["bilateral"] == 1
    want = TF.bilateral_blur(x, k, 0.1, 1.5, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_k3_on_card_repeats_its_bits(cuda_device):
    """Each pair weight is written once and read by its two pixels in a
    fixed order (no atomics): two calls give the same bits."""
    x = _on(cuda_device, (3, 300, 260), 13)
    first = KB.bilateral_cuda(x, 5, 0.1, 1.5)
    assert torch.equal(KB.bilateral_cuda(x, 5, 0.1, 1.5), first)


# K3's output before its strip walk moved to csrc/bilateral.cuh (shared
# with K13): the first 16 hex digits of the sha256 of bilateral_cuda's f32
# output, sigma_color 0.1, sigma_space 1.5, on
# np.random.default_rng(31).random(shape), by (shape, k) and border
K3_SHA256 = {
    ((1, 513, 511), 1): {"reflect": "b1cad589ff29f476", "mirror": "b1cad589ff29f476",
                         "nearest": "b1cad589ff29f476"},
    ((1, 513, 511), 3): {"reflect": "54297271bdcaee0d", "mirror": "2919165abcbaf9d2",
                         "nearest": "54297271bdcaee0d"},
    ((1, 513, 511), 5): {"reflect": "a2bead2ca342d7b9", "mirror": "78839b540b45948b",
                         "nearest": "ddeaf0426908e3cc"},
    ((1, 513, 511), 7): {"reflect": "bb35d74808e74228", "mirror": "86f80a9ea9799cba",
                         "nearest": "4f869a6016f6c79d"},
    ((1, 513, 511), 9): {"reflect": "4f16622f8f489aa3", "mirror": "e10b8048e6353ad9",
                         "nearest": "dfc13f02e9ddf3ac"},
    ((2, 77, 130), 1): {"reflect": "088579a882a1efaf", "mirror": "088579a882a1efaf",
                         "nearest": "088579a882a1efaf"},
    ((2, 77, 130), 3): {"reflect": "231ffd11fbc17137", "mirror": "e96e303f3cd1551a",
                         "nearest": "231ffd11fbc17137"},
    ((2, 77, 130), 5): {"reflect": "18c901c463dbb1bb", "mirror": "8a9ad2c1d538dce3",
                         "nearest": "ac98e5b2bf66e060"},
    ((2, 77, 130), 7): {"reflect": "5f4247c32623dc52", "mirror": "cad5ea54dea34c5e",
                         "nearest": "d99e9712f27aa0d5"},
    ((2, 77, 130), 9): {"reflect": "d9f89ff44f019bcb", "mirror": "3202320eecf04f06",
                         "nearest": "27f1704931f1fe34"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", sorted(K3_SHA256))
def test_k3_on_card_hashes_as_before_the_shared_walk(cuda_device, shape, k):
    x = torch.from_numpy(np.random.default_rng(31).random(shape).astype(
        np.float32)).to(cuda_device)
    for mode, want in K3_SHA256[(shape, k)].items():
        got = KB.bilateral_cuda(x, k, 0.1, 1.5, mode).cpu().numpy()
        assert hashlib.sha256(got.tobytes()).hexdigest()[:16] == want, mode


@pytest.mark.cuda
def test_k3_refuses_asymmetric_spatial_weights(cuda_device):
    """The pair weights assume spatial[c + i] == spatial[c - i]; the C entry
    point refuses other weights rather than give another filter."""
    x = _on(cuda_device, (1, 40, 40), 14)
    out = torch.empty_like(x)
    spatial = TF.spatial_weights(5, 1.5)
    spatial[3] *= 2.0
    with pytest.raises(RuntimeError, match="did not launch"):
        _build.launch("bilateral", "mies_bilateral", x.device, x.data_ptr(),
                      out.data_ptr(), 1, 40, 40, 5, spatial.ctypes.data, 50.0,
                      0)


# K4: registers at r 6 (radius 1.5) and r 4 (1.0), shared-memory rings at
# r 2 (0.5) and r 16 (4.0)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 3, 5), (2, 64, 1),
                                   (2, 65, 129), (2, 77, 130),
                                   (1, 1024, 1024)])
@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5, 4.0])
@pytest.mark.parametrize("quantize", [True, False])
def test_k4_on_card_equals_plain(cuda_device, quantize, radius, shape):
    x = _on(cuda_device, shape, 3)
    _build.reset_launches()
    got = KU.unsharp_quant_cuda(x, radius, 1.0, quantize=quantize)
    assert _build.LAUNCHES["unsharp_quant"] == 1
    assert torch.equal(got, KU.unsharp_quant_plain(x, radius, 1.0,
                                                   quantize=quantize))


@pytest.mark.cuda
@pytest.mark.parametrize("origin,grid,tile,nbins", [
    ((32, 32), (4, 5), (64, 64), 256),
    ((15, 20), (8, 8), (31, 41), 253),
    ((3, 5), (2, 2), (140, 190), 256),  # regions counted in strips of rows
])
def test_k1_bins_on_card_equals_plain(cuda_device, origin, grid, tile, nbins):
    rng = np.random.default_rng(4)
    bins = torch.from_numpy(
        rng.integers(0, nbins, (2, 300, 400)).astype(np.int32)).to(cuda_device)
    _build.reset_launches()
    got = KC.tile_hists_bins(bins, origin, grid, tile, nbins)
    assert _build.LAUNCHES["tile_hists_bins"] == 1
    assert torch.equal(got, KC.tile_hists_bins_plain(bins, origin, grid, tile,
                                                      nbins))


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,clim", [(256, 12), (100, 25), (1000, 3)])
def test_k6a_on_card_equals_plain(cuda_device, nbins, clim):
    rng = np.random.default_rng(5)
    hists = rng.poisson(np.linspace(1.0, 40.0, nbins), (2, 4, 4, nbins))
    hists = torch.from_numpy(hists.astype(np.int32)).to(cuda_device)
    _, steps = TH._clip_histogram_skimage(hists, clim, nbins, with_steps=True)
    assert steps.max().item() > 0  # phase 3 runs
    got = KC.skimage_maps(hists, clim, 4096)
    assert torch.equal(got, KC.skimage_maps_plain(hists, clim, 4096))


def _k6a_hists(shape, k_elems: int, clim: int) -> torch.Tensor:
    """[..., nbins] int32 region counts, the regions in turn: random and
    peaked counts of k_elems pixels, and two kinds that phase 3 sweeps more
    than once (more excess than the under-limit bins hold; two under-limit
    bins at the front with room for two each)."""
    rng = np.random.default_rng(6)
    nbins = shape[-1]
    regions = int(np.prod(shape[:-1]))
    peak = np.exp(-0.5 * ((np.arange(nbins) - nbins / 3)
                          / max(nbins / 16, 0.5)) ** 2) + 1e-3
    out = np.empty((regions, nbins), np.int64)
    for r in range(regions):
        kind = r % 4
        if kind == 0:
            out[r] = rng.multinomial(k_elems, np.full(nbins, 1.0 / nbins))
        elif kind == 1:
            out[r] = rng.multinomial(k_elems, peak / peak.sum())
        elif kind == 2:
            front = max(nbins // 4, 1)
            out[r] = clim
            out[r, :front] = clim - 1
            out[r, -1] += front + 5
        else:
            out[r] = clim
            out[r, :2] = max(clim - 2, 0)
            out[r, -1] += 4
    return torch.from_numpy(out.reshape(shape).astype(np.int32))


# K6a holds a region in one warp, 8 bins a lane up to 256 and 32 up to
# 1024: the main path's shapes, then bin counts that leave lanes empty or
# part full
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 8, 8, 256), (4, 8, 8, 1000),
                                   (2, 2, 4, 2), (2, 2, 4, 31),
                                   (2, 2, 4, 33), (2, 2, 4, 1024)])
@pytest.mark.parametrize("clim", ["1", "2", "0.01k"])
def test_k6a_on_card_equals_plain_at_every_clip(cuda_device, shape, clim):
    k_elems = 4096
    c = {"1": 1, "2": 2, "0.01k": int(0.01 * k_elems)}[clim]
    hists = _k6a_hists(shape, k_elems, c).to(cuda_device)
    _build.reset_launches()
    got = KC.skimage_maps(hists, c, k_elems)
    assert _build.LAUNCHES["skimage_maps"] == 1
    assert torch.equal(got, KC.skimage_maps_plain(hists, c, k_elems))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ks", [((2, 128, 128), (64, 64)),
                                      ((1, 251, 333), (31, 41))])
def test_skimage_on_card_equals_plain(cuda_device, shape, ks):
    x = _on(cuda_device, shape, 6)
    _build.reset_launches()
    got = KC.clahe_skimage_cuda(x, ks, 0.01)
    for name in ("tile_hists_bins", "skimage_maps", "skimage_apply"):
        assert _build.LAUNCHES[name] == 1
    assert torch.equal(got, TH.clahe(x, 0.01, convention="skimage",
                                     kernel_size=ks))
    (pr0, _, pc0, _), (nr, nc) = TH.skimage_geometry(shape[1:], ks)
    binned = TH._skimage_binned(x, ks, 256)
    maps = KC.skimage_maps(
        KC.tile_hists_bins(binned, (pr0, pc0), (nr, nc), ks, 256), 10, 4096)
    args = (ks, (pr0, pc0), shape[1:])
    assert torch.equal(KC.skimage_apply(binned, maps, *args),
                       KC.skimage_apply_plain(binned, maps, *args))


def _k6_inputs(device, shape, ks, nbins, seed):
    """The padded bins and K6a's maps of a random batch, and K6's crop."""
    x = _on(device, shape, seed)
    (pr0, _, pc0, _), (nr, nc) = TH.skimage_geometry(shape[1:], ks)
    binned = TH._skimage_binned(x, ks, nbins)
    k_elems = ks[0] * ks[1]
    hists = KC.tile_hists_bins(binned, (pr0, pc0), (nr, nc), ks, nbins)
    maps = KC.skimage_maps(hists, max(k_elems // 100, 1), k_elems)
    return binned, maps, (ks, (pr0, pc0), shape[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ks", [
    ((2, 128, 128), (64, 64)),   # the vector path (x0 = 32, kc = 64)
    ((1, 251, 333), (31, 41)),   # scalar columns: W0 % 4 != 0
    ((2, 40, 130), (64, 16)),    # a single region row (nr = 1)
    ((2, 130, 7), (16, 64)),     # a single region column (nc = 1)
    ((1, 4096, 4096), (512, 512))])  # blocks of 512^2 in strips of rows
@pytest.mark.parametrize("nbins", [2, 256, 1000])
def test_k6_on_card_equals_plain(cuda_device, shape, ks, nbins):
    """K6's interpolation blocks, their four maps as one float4 a bin:
    bit-equal to the plain blend at every bin count the convention takes
    (up to 1000: 16 KB of quads), at unaligned widths, at a single region
    on an axis and at 4096^2; one launch."""
    binned, maps, args = _k6_inputs(cuda_device, shape, ks, nbins, 9)
    _build.reset_launches()
    got = KC.skimage_apply(binned, maps, *args)
    assert _build.LAUNCHES["skimage_apply"] == 1
    assert torch.equal(got, KC.skimage_apply_plain(binned, maps, *args))


@pytest.mark.cuda
def test_k6_on_card_takes_unaligned_rows(cuda_device):
    """Bins one int into their storage (rows not 16-byte aligned) run the
    scalar columns where the shape alone would take the vector path."""
    binned, maps, args = _k6_inputs(cuda_device, (2, 128, 128), (64, 64),
                                    256, 10)
    off = torch.empty(binned.numel() + 1, dtype=torch.int32,
                      device=cuda_device)[1:].view(binned.shape)
    off.copy_(binned)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert torch.equal(KC.skimage_apply(off, maps, *args),
                       KC.skimage_apply_plain(binned, maps, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128), (1, 251, 333)])
def test_k2_clip01_on_card_equals_plain(cuda_device, shape):
    x = _on(cuda_device, shape, 7)
    _build.reset_launches()
    got = KC.clahe_cuda(x, 0.01, (8, 8), "fraction")
    assert _build.LAUNCHES["clahe_apply_lut"] == 1
    assert torch.equal(got, TH.clahe(x, 0.01, (8, 8), "fraction"))


# K9 runs one launch per iteration, K10 one per STEPS iterations, K11 one
# per call, K12 three per chunk of its STEPS; measured bit-equal to their
# plain versions, held here to the reference's own contracts (1e-6, TV
# 2e-6) with TV's per-slice stop iterations equal, and K10 bit-equal.


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128), (1, 251, 333)])
@pytest.mark.parametrize("option", [1, 2])
def test_k9_on_card_matches_plain(cuda_device, shape, option):
    x = _on(cuda_device, shape, 8)
    _build.reset_launches()
    got = KD.anisotropic_diffusion_cuda(x, 6, 0.05, 0.2, option)
    assert _build.LAUNCHES["perona_malik"] == KD.pm_launches_per_call(6)
    want = TR.anisotropic_diffusion(x, 6, 0.05, 0.2, option)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 7, 5), (1, 251, 333),
                                   (32, 512, 512)])
@pytest.mark.parametrize("niter", [1, 2, 6, 7, 15])
@pytest.mark.parametrize("option", [1, 2])
def test_k9_on_card_bit_equal(cuda_device, shape, niter, option):
    """K9's chunks of PM_STEPS steps, each warp a window of 32 columns x
    32 rows in registers that writes its inner tile (a halo of PM_HALO on
    every side; the window moved inside the image at its edges): bit-equal
    to the plain Perona-Malik at images smaller than a window or its halo,
    at tile edges, and at step counts that are not a multiple of PM_STEPS;
    ceil(niter / PM_STEPS) launches. kappa 0.3: the noise's differences
    pass (w8's 0.05 stops most of them)."""
    x = _on(cuda_device, shape, 8)
    _build.reset_launches()
    got = KD.anisotropic_diffusion_cuda(x, niter, 0.3, 0.2, option)
    assert _build.LAUNCHES["perona_malik"] == KD.pm_launches_per_call(niter)
    assert torch.equal(got, TR.anisotropic_diffusion(x, niter, 0.3, 0.2,
                                                     option))


@pytest.mark.cuda
def test_k9_refuses_a_halo_it_does_not_load(cuda_device, monkeypatch):
    """kernels/diffusion.py PM_HALO (pinned on the CPU by
    test_pm_chunk_halo_covers_its_steps) is passed to the launch;
    csrc/diffusion.cu refuses any other than the halo it loads."""
    x = _on(cuda_device, (1, 80, 96), 12)
    for halo in (KD.PM_HALO - 1, KD.PM_HALO + 1):
        monkeypatch.setattr(KD, "PM_HALO", halo)
        with pytest.raises(RuntimeError, match="did not launch"):
            KD.anisotropic_diffusion_cuda(x, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128), (1, 251, 333)])
def test_k10_on_card_matches_plain(cuda_device, shape):
    x = _on(cuda_device, shape, 9) * 0.9 + 0.05
    _build.reset_launches()
    got = KD.srad_cuda(x, 15, 0.15)
    assert _build.LAUNCHES["srad"] == KD.launches_per_call(15)
    want = TR.srad(x, 15, 0.15)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 1, 9), (2, 9, 1), (2, 3, 3),
                                   (2, 7, 5), (2, 65, 64), (1, 251, 333),
                                   (32, 512, 512)])
@pytest.mark.parametrize("niter", [1, 3, 4, 5, 15])
def test_k10_on_card_bit_equal(cuda_device, shape, niter):
    """K10's chunks of STEPS steps on 64 x 64 tiles: bit-equal to the plain
    SRAD at images smaller than a tile or its halo, at tile edges, and at a
    step count that is not a multiple of STEPS; ceil(niter / STEPS)
    launches."""
    x = _on(cuda_device, shape, 9) * 0.9 + 0.05
    _build.reset_launches()
    got = KD.srad_cuda(x, niter, 0.15)
    assert _build.LAUNCHES["srad"] == KD.launches_per_call(niter)
    assert torch.equal(got, TR.srad(x, niter, 0.15))


@pytest.mark.cuda
def test_k10_step_on_card_equals_srad_iteration(cuda_device):
    """srad_step (the band chain's) is one launch of the one step t."""
    x = _on(cuda_device, (2, 70, 130), 11) * 0.9 + 0.05
    _build.reset_launches()
    got = KD.srad_step(x, 7, 0.2, 0.8, 0.1, 1e-5)
    assert _build.LAUNCHES["srad"] == 1
    assert torch.equal(got, TR.srad_iteration(x, 7, 0.2, 0.8, 0.1, 1e-5))


@pytest.mark.cuda
def test_k10_refuses_a_halo_it_does_not_load(cuda_device, monkeypatch):
    """kernels/diffusion.py HALO (pinned on the CPU by
    test_srad_chunk_halo_covers_its_steps) is passed to the launch;
    csrc/diffusion.cu refuses any other than the halo it loads."""
    x = _on(cuda_device, (1, 80, 96), 12)
    lo, hi = KD.HALO
    for halo in ((lo, hi - 1), (lo + 1, hi)):
        monkeypatch.setattr(KD, "HALO", halo)
        with pytest.raises(RuntimeError, match="did not launch"):
            KD.srad_cuda(x, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 128), (1, 251, 333),
                                   # H and W not multiples of the tile
                                   (2, 33, 65), (1, 47, 100)])
@pytest.mark.parametrize("s,d,h,sigma", [(5, 6, 0.06, 0.04), (4, 3, 0.1, 0.0),
                                         (3, 0, 0.1, 0.0),  # no pair
                                         (9, 2, 0.08, 0.02)])  # runtime s
def test_k11_on_card_matches_plain(cuda_device, shape, s, d, h, sigma):
    x = _on(cuda_device, shape, 10)
    _build.reset_launches()
    got = KN.nl_means_cuda(x, s, d, h, sigma)
    assert _build.LAUNCHES["nl_means"] == 1
    want = TR.denoise_nl_means(x, s, d, h, sigma)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6


def _tv_batch(device, shape, seed):
    """A smooth ramp slice (stops early) among noise slices (late)."""
    x = _on(device, shape, seed)
    x[0] = torch.linspace(0, 1, shape[2], device=device) + 0.02 * x[0]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 128, 128), (2, 251, 333)])
@pytest.mark.parametrize("weight,max_iter", [(0.1, 60), (0.2, 200)])
def test_k12_on_card_matches_plain(cuda_device, shape, weight, max_iter):
    x = _tv_batch(cuda_device, shape, 11)
    _build.reset_launches()
    got, iters = KT.denoise_tv_cuda(x, weight, 2e-4, max_iter,
                                    return_iters=True)
    assert _build.LAUNCHES["tv"] == KT.launches_per_call(max_iter)
    want, want_iters = TR.tv_chambolle(x, weight, 2e-4, max_iter)
    torch.cuda.synchronize()
    assert torch.equal(iters, want_iters), (iters, want_iters)
    assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("eps,max_iter,positions", [
    (3e-4, 61, {3, 0, 1}), (2e-4, 61, {2, 0, 1}), (2e-4, 37, set()),
    (2e-4, 9, set())])
def test_k12_chunk_boundaries_on_card(cuda_device, eps, max_iter, positions):
    """Chunks of KT.STEPS = 4 steps: at 61 steps the slices stop at 32, 37
    and 38 (eps 3e-4) and at 39, 45, 46 and 47 (2e-4; the plain version on
    the CPU), so at the last, the first and a middle step of a chunk; at 37
    and 9 steps none stops; none of 61, 37 and 9 is a multiple of 4. Stop
    iterations equal, out within 2e-6, 3 launches a chunk."""
    assert KT.STEPS == 4  # the cases' stop positions are those of K = 4
    x = _tv_batch(cuda_device, (4, 96, 80), 12)
    want, want_iters = TR.tv_chambolle(x, 0.2, eps, max_iter)
    _build.reset_launches()
    got, iters = KT.denoise_tv_cuda(x, 0.2, eps, max_iter, return_iters=True)
    assert _build.LAUNCHES["tv"] == 3 * -(-max_iter // 4)
    torch.cuda.synchronize()
    assert torch.equal(iters, want_iters), (iters, want_iters)
    assert (got - want).abs().max().item() <= 2e-6
    assert {(n - 1) % 4 for n in want_iters.tolist()
            if n < max_iter} == positions, want_iters


@pytest.mark.cuda
def test_k12_refuses_a_halo_it_does_not_load(cuda_device, monkeypatch):
    """kernels/tv.py HALO (pinned on the CPU by test_tv_chunk_halo_covers_
    its_steps) is passed to the launch; csrc/tv.cu refuses any other than
    the halo it loads."""
    x = _tv_batch(cuda_device, (1, 96, 80), 12)
    monkeypatch.setattr(KT, "HALO", KT.HALO + 1)
    with pytest.raises(RuntimeError, match="did not launch"):
        KT.denoise_tv_cuda(x, 0.2, 2e-4, 9)


# --- denoise_bilateral's route and the dense conv2d ops on the card -------

@pytest.mark.cuda
@pytest.mark.parametrize("sigma,k", [(0.5, 5), (1.0, 7), (1.3, 9)])
def test_denoise_bilateral_runs_k3_within_2e6(cuda_device, sigma, k):
    """A window of at most 9 in the 'edge' border launches K3 once, within
    its 2e-6 of the plain filter."""
    x = _on(cuda_device, (4, 251, 333), 4)
    _build.reset_launches()
    got = KB.denoise_bilateral_batched(x, 0.1, sigma, "edge")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bilateral"] == 1
    want = TF.bilateral_blur(x, k, 0.1, sigma, "edge")
    assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_denoise_bilateral_wide_window_runs_plain(cuda_device):
    """sigma_spatial 1.4 gives k 11, past K3: the plain filter, no launch."""
    x = _on(cuda_device, (2, 67, 93), 5)
    _build.reset_launches()
    got = KB.denoise_bilateral_batched(x, 0.1, 1.4, "edge")
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values())
    assert torch.equal(got, TF.bilateral_blur(x, 11, 0.1, 1.4, "edge"))


@pytest.mark.cuda
@pytest.mark.parametrize("op,kw", [
    ("gabor", {}), ("gabor", {"frequency": 0.2, "theta": 0.7, "offset": 0.3}),
    ("gabor_bank", {}), ("motion_blur", {"angle": 30.0})])
def test_dense_conv2d_on_card_stays_float32(cuda_device, op, kw):
    """cuDNN runs the Gabor and motion-blur conv2d in float32 (importing
    mies_tpu_torch turns TF32 off): within 2e-6 of the CPU's float32
    conv, far below TF32's 10-bit mantissa."""
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    x = _on(cuda_device, (2, 128, 160), 6)
    fn = getattr(TF, op)
    got = fn(x, **kw).cpu()
    want = fn(x.cpu(), **kw)
    assert (got - want).abs().max().item() <= 2e-6
