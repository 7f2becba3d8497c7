"""The port's skimage, fraction and kornia CLAHE against the JAX package, on CPU.

The same seeded numpy inputs go through the JAX function (XLA:CPU, or its
Pallas kernel in interpret mode) and its port (plain PyTorch: on a CPU
tensor every kernel wrapper runs its plain version). Tolerances:
- counts (K1 bins) and the skimage map build (K6a) are integers until one
  f32 scale: exact;
- the skimage path holds the JAX package's own skimage contract
  (tests/test_histogram.py): at most 5e-5 of pixels beyond 1 uint8 ULP,
  since XLA:CPU multiplies by reciprocals and contracts the blend into
  FMAs where the port divides and rounds every product, which can move a
  floored 14-bit level;
- fraction and kornia: atol 1e-6, for the same FMA contraction and
  reciprocal divisions (about 1 ulp of values in [0, 1]); against the
  Pallas K2 also for its hi/lo bf16 split of fractional LUTs, which holds
  16 mantissa bits (exact for LUTs built from counts, as here);
- the pipeline's uint8 output: <= 1 level on < 1e-3 of pixels.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mies_tpu
import mies_tpu_torch
from mies_tpu.ops import histogram as JH
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.ops import histogram as TH

sys.path.insert(0, str(Path(__file__).parent))
from goldens import golden_ops as G  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SKIMAGE_YAML = REPO / "configs" / "xray_adapthist_skimage.yaml"


def _assert_skimage_match(out, ref, clip):
    """The JAX package's skimage contract (tests/test_histogram.py)."""
    d = np.abs(out - ref)
    outliers = d > 1.0 / 255.0
    assert outliers.mean() <= 5e-5, (outliers.mean(), d.max())
    assert d.max() <= max(2.0 / 255.0, clip + 1.0 / 255.0), d.max()


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _hist_cases(rng, nbins):
    """Region histograms [R, nbins] of three kinds: spread, one-bin
    spikes, and peaked counts whose excess phases 1-2 cannot place."""
    spread = rng.integers(0, 60, (6, nbins))
    spikes = np.zeros((4, nbins), np.int64)
    spikes[np.arange(4), rng.integers(0, nbins, 4)] = 4096
    peaked = rng.poisson(np.linspace(1.0, 40.0, nbins), (6, nbins))
    return np.concatenate([spread, spikes, peaked]).astype(np.int32)


# --- K1 bins mode: plain == the Pallas histogram kernels -------------------


@pytest.mark.parametrize("pallas", ["rows", "flat"])
def test_k1_bins_plain_equals_pallas_hists(rng, pallas):
    """K1's bins mode reads a window of a larger array in place; the TPU
    kernels count the cropped copy (rows: _hist_rows_kernel with integer
    bins; flat: _hist_kernel)."""
    from mies_tpu.kernels.clahe import tile_hists_pallas, tile_hists_rows_pallas

    big = rng.integers(0, 256, (2, 44, 150)).astype(np.int32)
    crop = big[:, 5:37, 7:135]
    if pallas == "rows":
        ref = tile_hists_rows_pallas(jnp.asarray(crop), 2, 2, interpret=True,
                                     quantize_input=False)
    else:
        ref = tile_hists_pallas(jnp.asarray(crop), 2, 2, interpret=True)
    out = KC.tile_hists_bins(torch.from_numpy(big), (5, 7), (2, 2), (16, 64), 256)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int32))


def test_k1_bins_counts_any_nbins(rng):
    bins = rng.integers(0, 37, (2, 30, 44)).astype(np.int32)
    out = KC.tile_hists_bins(torch.from_numpy(bins), (2, 4), (2, 5), (13, 8), 37)
    for b in range(2):
        region = bins[b, 2 + 13:2 + 26, 4 + 24:4 + 32]  # region (1, 3)
        np.testing.assert_array_equal(out[b, 1, 3].numpy(),
                                      np.bincount(region.ravel(), minlength=37))


# --- K6a: skimage clip + redistribution + maps ------------------------------


@pytest.mark.parametrize("nbins,clim,k_elems", [(256, 40, 4096), (256, 12, 1024),
                                                (100, 25, 2000)])
def test_k6a_plain_equals_jax(rng, nbins, clim, k_elems):
    hists = _hist_cases(rng, nbins)
    _, steps = TH._clip_histogram_skimage(torch.from_numpy(hists), clim, nbins,
                                          with_steps=True)
    assert steps.max() > 0, "phase 3 did not run"  # the sweep is exercised
    ref_clip = JH._clip_histogram_skimage(jnp.asarray(hists), clim, nbins)
    ref = JH._skimage_maps(ref_clip, k_elems)
    out = KC.skimage_maps(torch.from_numpy(hists).reshape(2, 2, 4, nbins),
                          clim, k_elems)
    np.testing.assert_array_equal(out.reshape(-1, nbins).numpy(), np.asarray(ref))


def _k6a_warp_model(hists: np.ndarray, clim: int, nbins: int) -> np.ndarray:
    """numpy model of K6a's warp (csrc/clahe_skimage.cu): lane l of 32
    holds bins [l P, l P + P) (P = 8 up to 256 bins, else 32), bins past
    nbins held as invalid; sums are per-lane sums then the warp's; phase 3
    keeps the under-limit bins as masks and their count n_under, ends a
    sweep at once when no under-limit bin lies at or past index, and a step
    finds each lane's first selected bin with one modulo, selects every
    step-th under-limit bin from there, and takes the selected bins that
    reach the limit off n_under; the cumsum is a serial scan in each lane
    plus a Hillis-Steele exclusive scan of the lane totals (the shuffles).
    Returns the cumsums [R, nbins] int64."""
    p = 8 if nbins <= 256 else 32
    valid = (np.arange(32 * p) < nbins).reshape(32, p)
    lane_lo = np.arange(32) * p
    out = []
    for hist in hists.reshape(-1, nbins).astype(np.int64):
        h = np.zeros(32 * p, np.int64)
        h[:nbins] = hist
        h = h.reshape(32, p)

        def warp_sum(per_bin):
            return int(np.where(valid, per_bin, 0).sum(axis=1).sum())

        n = warp_sum(np.maximum(h - clim, 0))
        h = np.minimum(h, clim)
        incr = n // nbins
        upper = clim - incr
        low = valid & (h < upper)
        n -= warp_sum(low) * incr
        h = h + np.where(low, incr, 0)
        mid = valid & (h >= upper) & (h < clim)
        n -= warp_sum(np.where(mid, clim - h, 0))
        h = np.where(mid, clim, h)
        under = valid & (h < clim)
        n_under = warp_sum(under)
        index, sweep_start, stalled = 0, n, False
        while n > 0 and not stalled:
            if not (under & (np.arange(32 * p).reshape(32, p) >= index)).any():
                stalled, sweep_start, index = n == sweep_start, n, 0
                continue  # the sweep's steps left select nothing
            step = max(n_under // max(n, 1), 1)
            t0 = np.maximum(index, lane_lo)
            rem = (t0 - index) % step  # one modulo a lane
            first = t0 - lane_lo + np.where(rem > 0, step - rem, 0)
            walk = np.zeros_like(valid)
            for lane in np.flatnonzero(first < p):
                walk[lane, first[lane]::step] = True  # bits step apart
            sel = walk & under
            h = h + sel
            filled = sel & (h >= clim)
            under &= ~filled
            n -= warp_sum(sel)
            n_under -= warp_sum(filled)
            index += 1
            if index == nbins:
                stalled, sweep_start, index = n == sweep_start, n, 0
        run = np.cumsum(h, axis=1)
        before = run[:, -1].copy()
        off = 1
        while off < 32:  # __shfl_up_sync: lane l adds lane l - off's value
            before[off:] = before[off:] + before[:-off].copy()
            off *= 2
        out.append((run + (before - run[:, -1])[:, None]).reshape(-1)[:nbins])
    return np.stack(out)


def _k6a_cases(rng, nbins, k_elems, clim):
    """Region histograms: random and peaked of k_elems pixels, a one-bin
    spike, and two that phase 3 sweeps more than once: more excess than
    the under-limit bins hold (a sweep that fills them, then one that
    stalls), and two under-limit bins at the front with room for two each
    (a sweep that leaves one for the next)."""
    flat = rng.multinomial(k_elems, np.full(nbins, 1.0 / nbins), 2)
    peak = np.exp(-0.5 * ((np.arange(nbins) - nbins / 3)
                          / max(nbins / 16, 0.5)) ** 2) + 1e-3
    peaked = rng.multinomial(k_elems, peak / peak.sum(), 2)
    spike = np.zeros((1, nbins), np.int64)
    spike[0, rng.integers(0, nbins)] = k_elems
    front = max(nbins // 4, 1)
    overfull = np.full((1, nbins), clim, np.int64)
    overfull[0, :front] = clim - 1
    overfull[0, -1] += front + 5
    slow = np.full((1, nbins), clim, np.int64)
    slow[0, :2] = max(clim - 2, 0)
    slow[0, -1] += 4
    return np.concatenate([flat, peaked, spike, overfull, slow]).astype(
        np.int32)


@pytest.mark.parametrize("nbins", [2, 31, 33, 256, 1000, 1024])
@pytest.mark.parametrize("clim", ["1", "2", "0.01k"])
def test_k6a_warp_model_equals_jax_and_plain(rng, nbins, clim):
    """K6a's lane partition reproduces the JAX package's
    _clip_histogram_skimage (and its maps) and the port's plain version,
    at clip limits whose phase 3 needs several sweeps (1, 2) and the
    shipped 0.01 of a region."""
    k_elems = 1024
    c = {"1": 1, "2": 2, "0.01k": max(int(0.01 * k_elems), 1)}[clim]
    hists = _k6a_cases(rng, nbins, k_elems, c)
    _, steps = TH._clip_histogram_skimage(torch.from_numpy(hists), c, nbins,
                                          with_steps=True)
    cums = _k6a_warp_model(hists, c, nbins)
    ref_clip = np.asarray(JH._clip_histogram_skimage(jnp.asarray(hists), c,
                                                     nbins))
    np.testing.assert_array_equal(np.diff(cums, axis=1, prepend=0), ref_clip)
    scale = np.float32((TH.NR_OF_GRAY - 1) / k_elems)
    maps = np.floor(np.minimum(cums.astype(np.float32) * scale,
                               np.float32(TH.NR_OF_GRAY - 1)))
    np.testing.assert_array_equal(
        maps, np.asarray(JH._skimage_maps(jnp.asarray(ref_clip), k_elems)))
    plain = KC.skimage_maps(torch.from_numpy(hists).reshape(1, 1, -1, nbins),
                            c, k_elems)
    np.testing.assert_array_equal(maps, plain.reshape(-1, nbins).numpy())
    if nbins > 2:  # two bins: phase 2 spreads any excess a sweep could
        assert steps.max() > nbins, "no region swept more than once"


def test_k6a_clip_equals_golden_transcription(rng):
    """Phase by phase, the golden's sequential loop over one region."""
    hists = _hist_cases(rng, 256)
    out = TH._clip_histogram_skimage(torch.from_numpy(hists), 12, 256).numpy()
    for r in range(len(hists)):
        np.testing.assert_array_equal(out[r],
                                      G._clip_histogram_skimage(hists[r], 12))


# --- the skimage path -------------------------------------------------------


@pytest.mark.parametrize("shape,ks", [((1, 64, 128), (16, 64)),
                                      ((1, 320, 320), (80, 80))])
def test_skimage_path_matches_pallas_skimage(rng, shape, ks):
    """K1 bins -> K6a -> K6 (plain) against clahe_skimage_tpu in interpret
    mode: kc = 64 takes _apply_maps_rows_kernel (kr = 16 keeps its unrolled
    row loop cheap to interpret), kc = 80 _apply_maps_kernel."""
    from mies_tpu.kernels.clahe import clahe_skimage_tpu

    imgs = rng.random(shape).astype(np.float32)
    ref = np.asarray(clahe_skimage_tpu(jnp.asarray(imgs), ks, 0.02,
                                       interpret=True))
    out = KC.clahe_skimage_cuda(torch.from_numpy(imgs), ks, 0.02).numpy()
    _assert_skimage_match(out, ref, 0.02)


@pytest.mark.parametrize("case,clip,grid,ks,nbins", [
    ("xray", 0.01, (8, 8), None, 256),
    ("xray", 0.05, (5, 7), None, 256),
    ("ragged", 0.01, (8, 8), None, 256),
    ("wide", 0.02, (8, 8), (24, 40), 256),
    ("wide", 0.02, (4, 4), None, 100),
])
def test_skimage_matches_jax_and_golden(xray, rng, case, clip, grid, ks, nbins):
    img = {"xray": xray, "ragged": rng.random((101, 67)),
           "wide": rng.random((96, 160))}[case].astype(np.float32)
    ref = np.asarray(JH.clahe(jnp.asarray(img), clip_limit=clip, grid_size=grid,
                              convention="skimage", nbins=nbins,
                              kernel_size=ks))
    out = TH.clahe(torch.from_numpy(img), clip, grid, "skimage", nbins, ks)
    _assert_skimage_match(out.numpy(), ref, clip)
    kernel_size = ks or (max(img.shape[0] // grid[0], 1),
                         max(img.shape[1] // grid[1], 1))
    gold = G.equalize_adapthist_skimage(img, kernel_size=kernel_size,
                                        clip_limit=clip, nbins=nbins)
    _assert_skimage_match(out.numpy(), gold, clip)
    # the kernels' composition (plain on the CPU) is the plain op
    assert torch.equal(KC.clahe_skimage_cuda(torch.from_numpy(img)[None],
                                             kernel_size, clip, nbins)[0], out)


def test_skimage_min_max_are_per_image(rng):
    """A batch of a dark and a bright slice: each is stretched on its own
    range, so every batch row equals its slice alone."""
    imgs = np.stack([0.2 * rng.random((64, 96)), 0.6 + 0.4 * rng.random((64, 96))])
    x = torch.from_numpy(imgs.astype(np.float32))
    batched = KC.clahe_batched(x, 0.02, (4, 4), "skimage")
    for i in range(2):
        assert torch.equal(batched[i], TH.clahe(x[i], 0.02, (4, 4), "skimage"))


@pytest.mark.parametrize("n,before,after", [(5, 2, 7), (64, 32, 96), (3, 1, 5)])
def test_skimage_pad_is_numpy_reflect(rng, n, before, after):
    """skimage's 'reflect' pad (numpy 'reflect', edge not repeated) can run
    1.5 kernels past the edge: index arithmetic, not F.pad."""
    img = rng.random((n, n)).astype(np.float32)
    out = TH._pad_reflect(torch.from_numpy(img), (before, after), (after, before))
    np.testing.assert_array_equal(
        out.numpy(), np.pad(img, ((before, after), (after, before)), "reflect"))


def _units(lo: int, hi: int, aligned: bool) -> list[list[int]]:
    """The columns of each column unit of a row segment, as csrc/cells.cuh
    Units assigns them: scalar head, four columns a unit on aligned rows,
    scalar tail."""
    a = min((lo + 3) & ~3, hi) if aligned else hi
    e = max(hi & ~3, a) if aligned else hi
    return ([[c] for c in range(lo, a)]
            + [[c, c + 1, c + 2, c + 3] for c in range(a, e, 4)]
            + [[c] for c in range(e, hi)])


@pytest.mark.parametrize("hw,ks", [((512, 512), (64, 64)),
                                   ((4096, 4096), (512, 512)),
                                   ((251, 333), (31, 41)), ((1, 1), (1, 1)),
                                   ((7, 5), (3, 4)), ((40, 9), (64, 64))])
@pytest.mark.parametrize("aligned", [True, False])
def test_k6_blocks_cover_every_pixel_once(hw, ks, aligned):
    """K6's blocks (kernels/clahe.py skimage_launch; csrc/clahe_skimage.cu)
    cover every pixel of the crop exactly once, each in the interpolation
    block and at the weights ops.histogram._skimage_apply gives it. Per
    axis the blocks [b k, (b + 1) k) cut to the crop, a block's rows cut
    into `strips` runs of `rpb`, its column units (csrc/cells.cuh Units)
    into `col_splits` chunks of THREADS: each is checked whole."""
    (pr0, _, pc0, _), _ = TH.skimage_geometry(hw, ks)
    origin = (pr0, pc0)
    nbx, nby, rpb, strips, col_splits = KC.skimage_launch(32, ks, origin, hw,
                                                          aligned)
    extents = []
    for axis, (o, n, k, nb) in enumerate(zip(origin, hw, ks, (nby, nbx))):
        pos = np.arange(o, o + n)
        want_w = ((torch.from_numpy(pos) % k).to(torch.float32)
                  / torch.tensor(float(k))).numpy()  # the plain version's
        seen = np.zeros(n, np.int64)
        ext = []
        for b in range(o // k, o // k + nb):
            p0, p1 = max(b * k, o), min((b + 1) * k, o + n)
            assert p0 < p1
            seen[p0 - o:p1 - o] += 1
            assert (pos[p0 - o:p1 - o] // k == b).all()
            w = np.arange(p0 - b * k, p1 - b * k, dtype=np.float32) / \
                np.float32(k)  # csrc/regions.cuh region_weights
            np.testing.assert_array_equal(w, want_w[p0 - o:p1 - o])
            ext.append(p1 - p0)
            if axis == 1:
                units = _units(p0, p1, aligned)
                assert len(units) <= col_splits * KC.THREADS
                assert sorted(sum(units, [])) == list(range(p0, p1))
        assert (seen == 1).all(), axis
        extents.append(max(ext))
    assert extents[0] <= strips * rpb
    assert rpb == 1 or rpb * extents[1] <= KC.SK_PIXELS_PER_BLOCK
    if hw == (4096, 4096) and aligned:  # strips of 16 rows: 2,592 blocks
        assert (nbx * nby * strips * col_splits, rpb) == (2592, 16)


# --- fraction ---------------------------------------------------------------


def test_k2_clip01_plain_matches_pallas_apply33(rng):
    """K2's clip01 epilogue on fractional LUTs against _apply33_kernel
    (tw = 64: the tile33 layout) with quantize_input and finalize='clip01'."""
    from mies_tpu.kernels.clahe import clahe_apply_lut

    x = torch.from_numpy(rng.random((1, 64, 128)).astype(np.float32))
    hists = KC.tile_hists(x, (1, 2)).reshape(1, 2, 256).to(torch.float32)
    luts = TH._luts_fraction(hists, 0.01, 64 * 64).reshape(1, 1, 2, 256)
    assert not torch.equal(luts, torch.round(luts))  # fractional LUTs
    ref = clahe_apply_lut(jnp.asarray(x.numpy()), jnp.asarray(luts.numpy()),
                          (1, 2), integer_luts=False, interpret=True,
                          quantize_input=True, finalize="clip01")
    out = KC.clahe_apply_lut(x, luts, (1, 2), finalize="clip01")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case,clip", [("xray", 0.01), ("ragged", 0.02)])
def test_fraction_matches_jax(xray, rng, case, clip):
    img = xray if case == "xray" else rng.random((251, 333)).astype(np.float32)
    ref = np.asarray(JH.clahe(jnp.asarray(img), clip_limit=clip,
                              convention="fraction"))
    out = TH.clahe(torch.from_numpy(img), clip, (8, 8), "fraction")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    x = torch.from_numpy(img)[None]
    assert torch.equal(KC.clahe_cuda(x, clip, (8, 8), "fraction")[0], out)


def test_fraction_matches_golden(xray):
    """The JAX package's own fraction contract (tests/test_histogram.py)."""
    out = TH.clahe(torch.from_numpy(xray), 0.01, (8, 8), "fraction").numpy()
    ref = G.clahe_fraction(xray, clip_limit=0.01, grid_size=(8, 8))
    np.testing.assert_allclose(out, ref, atol=1e-5)


# --- kornia -----------------------------------------------------------------


@pytest.mark.parametrize("shape,clip,grid", [((512, 512), 40.0, (8, 8)),
                                             ((251, 333), 2.0, (8, 8)),
                                             ((100, 90), 0.0, (4, 4))])
def test_kornia_matches_jax(xray, rng, shape, clip, grid):
    img = xray if shape == (512, 512) else rng.random(shape).astype(np.float32)
    ref = np.asarray(JH.clahe(jnp.asarray(img), clip_limit=clip, grid_size=grid,
                              convention="kornia"))
    out = TH.clahe(torch.from_numpy(img), clip, grid, "kornia").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_kornia_geometry_mismatch_raises():
    """A reflect pad as long as the image: both packages refuse it."""
    with pytest.raises(ValueError, match="kornia"):
        JH.clahe(jnp.zeros((3, 3)), 2.0, (4, 4), "kornia")
    with pytest.raises(ValueError, match="kornia"):
        TH.clahe(torch.zeros(3, 3), 2.0, (4, 4), "kornia")


# --- the skimage config end to end ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_skimage_yaml_matches_jax(xray, rng, dtype):
    x = np.stack([xray, rng.random(xray.shape).astype(np.float32)])
    if dtype == "uint8":
        x = np.clip(np.rint(x * 255), 0, 255).astype(np.uint8)
    ref = np.asarray(mies_tpu.compile_pipeline(
        mies_tpu.load_config(SKIMAGE_YAML), batched=True, donate=False)(
            jnp.asarray(x)))
    _build.reset_launches()
    fn = mies_tpu_torch.compile_pipeline(
        mies_tpu_torch.load_config(SKIMAGE_YAML), batched=True, device="cpu")
    out = fn(torch.from_numpy(x))
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)  # CPU: plain
    assert out.dtype == torch.uint8 and tuple(out.shape) == x.shape
    _levels_close(out.numpy(), ref)
    single = mies_tpu_torch.compile_pipeline(
        mies_tpu_torch.load_config(SKIMAGE_YAML), device="cpu")(
            torch.from_numpy(x[1]))
    assert torch.equal(single, out[1])


# --- what the kernels do not take --------------------------------------------


def test_skimage_wrappers_reject_what_the_kernels_do_not_take():
    bins = torch.zeros(1, 64, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="nbins"):
        KC.tile_hists_bins(bins, (0, 0), (1, 1), (64, 64), 2048)
    with pytest.raises(ValueError, match="does not fit"):
        KC.tile_hists_bins(bins, (8, 0), (2, 2), (32, 32), 256)
    with pytest.raises(TypeError):
        KC.tile_hists_bins(bins.float(), (0, 0), (2, 2), (32, 32), 256)
    with pytest.raises(ValueError, match="nbins"):
        KC.skimage_maps(torch.zeros(1, 1, 1, 1025, dtype=torch.int32), 4, 64)
    with pytest.raises(ValueError, match="crop"):
        KC.skimage_apply(bins, torch.zeros(1, 1, 1, 256), (32, 32), (40, 0),
                         (32, 32))
    with pytest.raises(ValueError, match="finalize"):
        KC.clahe_apply_lut(torch.zeros(1, 32, 32), torch.zeros(1, 2, 2, 256),
                           (2, 2), finalize="rint")
    with pytest.raises(ValueError, match="opencv"):
        KC.clahe_cuda(torch.zeros(1, 32, 32), 2.0, (2, 2), "skimage")
