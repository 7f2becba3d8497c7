"""The port's volume path (mies_tpu_torch.ops.volume3d, kernels.clahe3d and
compile_volume_pipeline), against the JAX package on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
counterpart. The plain versions of K8 (trilinear LUT apply) and K8s
(skimage 8-map blend) are held against the TPU kernels they replace, run
in Pallas interpret mode as tests/test_volume3d.py and tests/test_kernels.py
run them, with those tests' tolerances. The CUDA kernels run only on the
card: the tests that launch them carry the ``cuda`` marker and skip
without one (``python -m pytest tests/test_torch_volume.py --noconftest -m
cuda`` on a card without jax).
"""

import numpy as np
import pytest
import torch
from pytest import skip

import mies_tpu_torch
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.kernels import clahe3d as K3D
from mies_tpu_torch.ops import volume3d as TV
from mies_tpu_torch.pipeline import compiler as TC
from mies_tpu_torch.pipeline.config import PipelineConfig
from mies_tpu_torch.pipeline.runner import make_batch, profile_volume, time_volume

torch.set_num_threads(2)

CT_VOLUME = "configs/ct_volume_3d.yaml"


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(v: np.ndarray) -> np.ndarray:
    return np.rint(v * 255.0).astype(np.int64)


# --- K8: the plain trilinear apply against the TPU kernel -------------------


@pytest.mark.parametrize("grid,shape", [((4, 4, 4), (16, 64, 256)),
                                        ((4, 4, 8), (16, 64, 256))])
def test_k8_plain_matches_pallas_tile33z(rng, grid, shape):
    """Levels bit-equal, values within the /255 reciprocal-vs-division
    ULP (tests/test_volume3d.py:test_tile33z_bit_equals_gather)."""
    import jax.numpy as jnp
    from mies_tpu.kernels.clahe import clahe3d_apply_tile33z

    imgs = rng.random(shape).astype(np.float32)
    luts = rng.integers(0, 256, (*grid, 256)).astype(np.float32)
    ref = np.asarray(clahe3d_apply_tile33z(
        jnp.asarray(imgs), jnp.asarray(luts), grid, interpret=True,
        quantize_input=True, finalize="u8norm"))
    out = K3D.clahe3d_apply_lut(_t(imgs), _t(luts), grid).numpy()
    np.testing.assert_array_equal(_levels(out), _levels(ref))
    np.testing.assert_allclose(out, ref, atol=1.3e-7, rtol=0)


@pytest.mark.parametrize("grid,shape", [((3, 3, 5), (12, 96, 160))])
def test_k8_gather_bit_equals_jax_gather(rng, grid, shape):
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import _apply_luts_trilinear_gather

    u8 = rng.integers(0, 256, shape).astype(np.int32)
    luts = rng.integers(0, 256, (*grid, 256)).astype(np.float32)
    ref = np.asarray(_apply_luts_trilinear_gather(
        jnp.asarray(u8), jnp.asarray(luts), grid))
    out = TV._apply_luts_trilinear_gather(_t(u8), _t(luts), grid).numpy()
    np.testing.assert_array_equal(out, ref)


def _cell_start(c: int, t: int, inv: np.float32, lo: int, hi: int) -> int:
    """csrc/cells.cuh cell_start in numpy float32 (each product and
    difference rounded once, as the kernel's _rn intrinsics)."""
    def cell(p):
        return int(np.floor(np.float32(p) * inv - np.float32(0.5)))
    p = min(max(c * t + (t + 1) // 2, lo), hi)
    while p > lo and cell(p - 1) >= c:
        p -= 1
    while p < hi and cell(p) < c:
        p += 1
    return p


def _k8_units(x_lo: int, x_hi: int, aligned: bool) -> list[list[int]]:
    """The columns of each of a cell's column units, as csrc/clahe3d.cu
    assigns them: scalar head, four columns a unit on aligned rows, scalar
    tail."""
    a = min((x_lo + 3) & ~3, x_hi) if aligned else x_hi
    e = max(x_hi & ~3, a) if aligned else x_hi
    return ([[c] for c in range(x_lo, a)]
            + [[c, c + 1, c + 2, c + 3] for c in range(a, e, 4)]
            + [[c] for c in range(e, x_hi)])


@pytest.mark.parametrize("shape,grid", [
    ((32, 512, 512), (4, 8, 8)), ((256, 512, 512), (4, 8, 8)),
    ((12, 96, 160), (3, 3, 5)), ((12, 96, 165), (3, 3, 5)),
    ((7, 33, 165), (1, 3, 5)), ((6, 20, 21), (2, 1, 3)),
    ((5, 9, 14), (5, 9, 7)), ((9, 15, 26), (3, 5, 2))])
@pytest.mark.parametrize("aligned", [True, False])
def test_k8_blocks_cover_every_voxel_once(shape, grid, aligned):
    """K8's blocks (kernels/clahe3d.py apply_launch, the cell edges by the
    kernel's own f32 formula) cover every voxel exactly once, and each voxel
    blends the tiles ops.volume3d._axis_weights gives it. The partition is
    the product of one cell partition per axis, a cell's (slice, row) pairs
    cut into `strips` runs of `rpb`, and its column units cut into
    `col_splits` chunks of THREADS: each is checked whole."""
    rpb, strips, col_splits = K3D.apply_launch(shape, grid, aligned)
    extents = []
    for axis, (n, g) in enumerate(zip(shape, grid)):
        t = n // g
        inv = np.float32(1.0) / np.float32(t)
        edges = [_cell_start(c, t, inv, 0, n) for c in range(-1, g + 1)]
        lo, hi, _ = TV._axis_weights(n, t, g, "cpu")
        seen = np.zeros(n, np.int64)
        for c in range(-1, g):  # block slot c + 1
            p0, p1 = edges[c + 1], edges[c + 2]
            seen[p0:p1] += 1
            assert (lo[p0:p1] == max(c, 0)).all()
            assert (hi[p0:p1] == min(c + 1, g - 1)).all()
            assert p1 - p0 <= t + 1
            if axis == 2:
                units = _k8_units(p0, p1, aligned)
                assert len(units) <= col_splits * K3D.THREADS
                assert sorted(sum(units, [])) == list(range(p0, p1))
        assert (seen == 1).all(), (axis, edges)
        extents.append(np.diff(edges))
    assert extents[0].max() * extents[1].max() <= strips * rpb
    assert rpb * (shape[2] // grid[2] + 1) <= K3D.PIXELS_PER_BLOCK


def test_k8_launch_takes_any_z_and_refuses_a_grid_past_the_card():
    """Z is no grid dimension of K8's launch (only the grid's cells are):
    70,000 slices launch; 70,000 tiles on one axis do not."""
    rpb, strips, _ = K3D.apply_launch((70000, 2, 4), (2, 1, 1), True)
    assert strips * rpb >= (35000 + 1) * 3
    with pytest.raises(ValueError, match="launch grid"):
        K3D.apply_launch((1, 70000, 4), (1, 70000, 1), True)


@pytest.mark.parametrize("shape,kernel_size", [
    ((32, 512, 512), (8, 64, 64)), ((20, 251, 333), None),
    ((5, 9, 14), (3, 7, 11)), ((9, 40, 70), (3, 7, 11)),
    ((7, 33, 165), (2, 5, 9)), ((1, 1, 1), (1, 1, 1)), ((6, 3, 2), (4, 8, 8))])
@pytest.mark.parametrize("aligned", [True, False])
def test_k8s_blocks_cover_every_voxel_once(shape, kernel_size, aligned):
    """K8s's blocks (kernels/clahe3d.py skimage_launch; csrc/clahe3d.cu)
    cover every voxel of the crop exactly once, each in the region block
    and at the weights ops.volume3d._apply_maps_3d gives it. Per axis the
    region blocks [b k, (b + 1) k) cut to the crop, a block's (slice, row)
    pairs cut into `strips` runs of `rpb`, its column units (csrc/
    cells.cuh Units) into `col_splits` chunks of THREADS: each is checked
    whole."""
    ks = TV.skimage3d_kernel_size(shape, (4, 8, 8), kernel_size)
    origin, _, _ = TV.skimage3d_geometry(shape, ks)
    *nblocks, rpb, strips, col_splits = K3D.skimage_launch(ks, origin, shape,
                                                           aligned)
    nbx, nby, nbz = nblocks
    extents = []
    for axis, (o, n, k, nb) in enumerate(zip(origin, shape, ks,
                                             (nbz, nby, nbx))):
        pos = np.arange(o, o + n)
        want_w = ((_t(pos) % k).to(torch.float32)
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
            if axis == 2:
                units = _k8_units(p0, p1, aligned)
                assert len(units) <= col_splits * K3D.THREADS
                assert sorted(sum(units, [])) == list(range(p0, p1))
        assert (seen == 1).all(), axis
        extents.append(max(ext))
    assert extents[0] * extents[1] <= strips * rpb
    assert rpb == 1 or rpb * extents[2] <= KC.SK_PIXELS_PER_BLOCK


def test_k8s_launch_takes_any_z_and_refuses_a_grid_past_the_card():
    """Z is no grid dimension of K8s's launch (only its region blocks
    are): 70,000 slices at kz = 2 launch; 70,000 region blocks on an axis
    do not."""
    nbx, nby, nbz, rpb, strips, _ = K3D.skimage_launch(
        (2, 1, 4), (1, 0, 2), (70000, 2, 4), True)
    assert (nbz, nby, nbx) == (35001, 2, 2) and strips * rpb >= 2 * 1
    with pytest.raises(ValueError, match="launch grid"):
        K3D.skimage_launch((1, 1, 4), (0, 0, 2), (70000, 2, 4), True)


def test_k8_opencv_mode_matches_pallas_blocks8(rng):
    """The global-cell fractions of _blocks8_kernel's opencv mode, on the
    half-tile-shifted cells of the reference's selection form, within the
    reference's 2e-4 (tests/test_kernels.py:test_blocks8_kernel_opencv_
    interpret)."""
    import jax.numpy as jnp
    from mies_tpu.kernels.clahe import blocks8_apply

    grid, shape = (2, 2, 2), (8, 32, 64)
    (gz, gy, gx), (z, h, w) = grid, shape
    tz, th, tw = z // gz, h // gy, w // gx
    u8 = rng.integers(0, 256, shape).astype(np.int32)
    luts = rng.integers(0, 256, (*grid, 256)).astype(np.float32)
    pads = ((tz // 2, tz - tz // 2), (th // 2, th - th // 2),
            (tw // 2, tw - tw // 2))
    n1 = (gz + 1, gy + 1, gx + 1)
    blocks = (np.pad(u8, pads, mode="edge")
              .reshape(n1[0], tz, n1[1], th, n1[2], tw)
              .transpose(0, 2, 4, 1, 3, 5).reshape(-1, tz * th * tw))
    lp = np.pad(luts, ((1, 1), (1, 1), (1, 1), (0, 0)), mode="edge")
    m8 = np.stack([lp[ez:ez + n1[0], ey:ey + n1[1], ex:ex + n1[2]]
                   for ez in range(2) for ey in range(2) for ex in range(2)],
                  axis=3).reshape(-1, 8, 256)
    res = np.asarray(blocks8_apply(
        jnp.asarray(blocks), jnp.asarray(m8), dims=(tz, th, tw), grids=n1,
        mode="opencv", split=False, interpret=True))
    ref = (res.reshape(*n1, tz, th, tw).transpose(0, 3, 1, 4, 2, 5)
           .reshape(z + tz, h + th, w + tw))
    ref = ref[pads[0][0]:pads[0][0] + z, pads[1][0]:pads[1][0] + h,
              pads[2][0]:pads[2][0] + w]
    out = TV._apply_luts_trilinear_gather(_t(u8), _t(luts), grid).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


# --- K8s: the plain skimage 8-map blend against the TPU kernel --------------


def _blocks_and_maps(binned, map_array, ks):
    nz, ny, nx = (s // k for s, k in zip(binned.shape, ks))
    blocks = (binned.reshape(nz, ks[0], ny, ks[1], nx, ks[2])
              .transpose(0, 2, 4, 1, 3, 5).reshape(nz * ny * nx, -1))
    m8 = np.stack([map_array[ez:ez + nz, ey:ey + ny, ex:ex + nx]
                   for ez in range(2) for ey in range(2) for ex in range(2)],
                  axis=3).reshape(nz * ny * nx, 8, -1)
    return blocks, m8, (nz, ny, nx)


def test_k8s_plain_matches_pallas_blocks8_skimage(rng):
    """<= 1 on < 1e-3 of voxels (tests/test_kernels.py:test_blocks8_kernel_
    skimage_interpret: the Pallas selection and f32 sum orders)."""
    import jax.numpy as jnp
    from mies_tpu.kernels.clahe import blocks8_apply

    ks, grid = (4, 8, 8), (2, 3, 2)
    binned = rng.integers(0, 256, tuple(g * k for g, k in zip(grid, ks)),
                          dtype=np.int32)
    map_array = np.rint(rng.random((*(g + 1 for g in grid), 256)) * 16383
                        ).astype(np.float32)
    blocks, m8, n = _blocks_and_maps(binned, map_array, ks)
    res = np.asarray(blocks8_apply(
        jnp.asarray(blocks), jnp.asarray(m8), dims=ks, grids=n,
        mode="skimage", split=True, interpret=True))
    ref = res.reshape(*n, *ks).transpose(0, 3, 1, 4, 2, 5).reshape(binned.shape)
    out = K3D.clahe3d_skimage_apply(_t(binned), _t(map_array), ks, (0, 0, 0),
                                    binned.shape).numpy()
    d = np.abs(out - ref)
    assert d.max() <= 1.0 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_k8s_plain_matches_jax_selection_on_the_crop(rng):
    """The crop of the padded volume, read in place, against the
    reference's whole-volume selection form cropped afterwards."""
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import _apply_maps_selection3d

    ks = (4, 8, 8)
    binned = rng.integers(0, 256, (12, 24, 32), dtype=np.int32)
    map_array = np.rint(rng.random((4, 4, 5, 256)) * 16383).astype(np.float32)
    ref = np.asarray(_apply_maps_selection3d(
        jnp.asarray(binned), jnp.asarray(map_array), ks, 256))
    origin, out_shape = (2, 4, 4), (7, 15, 21)
    out = K3D.clahe3d_skimage_apply(_t(binned), _t(map_array), ks, origin,
                                    out_shape).numpy()
    crop = ref[2:9, 4:19, 4:25]
    d = np.abs(out - crop)
    assert d.max() <= 1.0 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


# --- the ops against the JAX package ---------------------------------------


@pytest.mark.parametrize("grid,shape", [((2, 4, 4), (16, 64, 64)),
                                        ((4, 2, 3), (8, 32, 48))])
def test_clahe3d_opencv_levels_equal_jax(grid, shape):
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import clahe3d

    vol = np.random.default_rng(77).random(shape).astype(np.float32)
    ref = np.asarray(clahe3d(jnp.asarray(vol), clip_limit=2.0, grid_size=grid))
    out = TV.clahe3d(_t(vol), 2.0, grid).numpy()
    np.testing.assert_array_equal(_levels(out), _levels(ref))


def test_clahe3d_opencv_levels_on_an_in_window_ct_phantom_match_jax():
    """clahe3d opencv (grid (4, 8, 8), clip 2) on identical float input, the
    windowed levels of a CT phantom whose HU lie mostly inside the window
    (center 40, width 400: soft tissue, fat, a vessel, noise of 25 HU):
    levels within 1 on < 1e-3 of voxels of the JAX package (XLA:CPU's
    reciprocal multiplies move a level at its rounding edges)."""
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import clahe3d

    from mies_tpu_torch.ops.intensity import window_hu

    z, h, w = 16, 64, 96
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot((yy - h / 2) / (0.45 * h), (xx - w / 2) / (0.45 * w))
    hu = np.where(r < 1.0, 40.0, -100.0)
    hu = np.where((yy - 0.35 * h) ** 2 + (xx - w / 2) ** 2 < (0.1 * w) ** 2,
                  200.0, hu)
    hu = hu[None] + 25.0 * np.random.default_rng(83).standard_normal((z, h, w))
    hu = np.rint(hu).astype(np.int16)
    assert ((hu > -160) & (hu < 240)).mean() > 0.95
    vol = window_hu(_t(hu), center=40.0, width=400.0).numpy()
    ref = np.asarray(clahe3d(jnp.asarray(vol), clip_limit=2.0,
                             grid_size=(4, 8, 8)))
    out = TV.clahe3d(_t(vol), 2.0, (4, 8, 8)).numpy()
    d = np.abs(_levels(out) - _levels(ref))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_clahe3d_fraction_matches_jax():
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import clahe3d

    vol = np.random.default_rng(79).random((16, 64, 64)).astype(np.float32)
    ref = np.asarray(clahe3d(jnp.asarray(vol), 0.01, (4, 8, 8), "fraction"))
    out = TV.clahe3d(_t(vol), 0.01, (4, 8, 8), "fraction").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,kernel_size,clip", [
    ((16, 48, 48), None, 0.01),     # divisible: regions (8, 12, 12)
    ((10, 33, 47), (4, 8, 8), 0.02),  # non-divisible
])
def test_clahe3d_skimage_matches_jax(shape, kernel_size, clip):
    """The reference's outlier contract (tests/test_volume3d.py): at most
    5e-5 of voxels more than 1/255 apart."""
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import clahe3d

    vol = np.random.default_rng(11).random(shape).astype(np.float32)
    ref = np.asarray(clahe3d(jnp.asarray(vol), clip, (2, 4, 4), "skimage",
                             kernel_size))
    out = TV.clahe3d(_t(vol), clip, (2, 4, 4), "skimage", kernel_size).numpy()
    assert out.shape == vol.shape
    d = np.abs(out - ref)
    assert (d > 1.0 / 255.0).mean() <= 5e-5, d.max()


@pytest.mark.parametrize("sigma,mode", [(0.8, "nearest"), (1.0, "constant")])
def test_gaussian_blur3d_matches_jax(rng, sigma, mode):
    import jax.numpy as jnp
    from mies_tpu.ops.volume3d import gaussian_blur3d

    vol = rng.random((9, 20, 31)).astype(np.float32)
    ref = np.asarray(gaussian_blur3d(jnp.asarray(vol), sigma, mode=mode))
    out = TV.gaussian_blur3d(_t(vol), sigma, mode=mode).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


# --- the compositions on CPU tensors ---------------------------------------


@pytest.mark.parametrize("convention,clip,grid,shape", [
    ("opencv", 2.0, (4, 8, 8), (16, 64, 64)),
    ("fraction", 0.01, (3, 3, 5), (12, 96, 160)),
    ("skimage", 0.01, (4, 8, 8), (20, 51, 63)),
])
def test_clahe3d_volume_compositions_equal_plain_op(rng, convention, clip,
                                                    grid, shape):
    """K1 -> per-z-tile sums -> LUTs -> K8, and scale-in -> K1 bins ->
    per-kz sums -> K6a -> edge pad -> K8s -> stretch (plain versions on
    the CPU) are the whole plain op."""
    vol = _t(rng.random(shape).astype(np.float32))
    if convention == "skimage":
        ks = TV.skimage3d_kernel_size(shape, grid)
        got = K3D.clahe3d_skimage_cuda(vol, ks, clip)
    else:
        got = K3D.clahe3d_cuda(vol, clip, grid, convention)
    assert torch.equal(got, TV.clahe3d(vol, clip, grid, convention))


def test_volume_wrappers_count_no_launch_on_cpu(rng):
    _build.reset_launches()
    vol = _t(rng.random((8, 32, 32)).astype(np.float32))
    for conv in TV.CONVENTIONS_3D:
        K3D.clahe3d_volume(vol, 0.01, (2, 4, 4), conv)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)


def test_volume_wrappers_reject_what_the_kernels_do_not_take():
    vol = torch.zeros(8, 32, 32)
    with pytest.raises(ValueError, match="not divisible"):
        K3D.clahe3d_apply_lut(vol, torch.zeros(3, 4, 4, 256), (3, 4, 4))
    with pytest.raises(ValueError, match="luts"):
        K3D.clahe3d_apply_lut(vol, torch.zeros(2, 4, 4, 255), (2, 4, 4))
    with pytest.raises(ValueError, match="finalize"):
        K3D.clahe3d_apply_lut(vol, torch.zeros(2, 4, 4, 256), (2, 4, 4), "x")
    with pytest.raises(TypeError):
        K3D.clahe3d_apply_lut(vol.double(), torch.zeros(2, 4, 4, 256), (2, 4, 4))
    bins = torch.zeros(8, 16, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="crop"):
        K3D.clahe3d_skimage_apply(bins, torch.zeros(3, 3, 3, 256), (4, 8, 8),
                                  (1, 0, 0), (8, 16, 16))
    with pytest.raises(ValueError, match="cover"):
        K3D.clahe3d_skimage_apply(bins, torch.zeros(2, 2, 2, 256), (4, 8, 8),
                                  (0, 0, 0), (8, 16, 16))
    with pytest.raises(ValueError, match=r"\[Z, H, W\]"):
        TV.clahe3d(torch.zeros(32, 32))
    with pytest.raises(ValueError, match="convention"):
        K3D.clahe3d_volume(vol, 2.0, (2, 4, 4), "kornia")


# --- the slice: configs/ct_volume_3d.yaml and the volume compiler ----------


def test_ct_volume_yaml_matches_jax():
    """window_hu -> clahe3d opencv [4, 8, 8] -> gaussian_blur3d -> uint8 on
    a seeded int16 volume: within 1 level on < 1e-3 of voxels (XLA:CPU
    contracts the Gaussian passes into FMAs; the port does not)."""
    import jax.numpy as jnp

    import mies_tpu
    from mies_tpu.pipeline.compiler import compile_volume_pipeline

    hu = np.random.default_rng(5).integers(-1000, 1500, (16, 64, 64)
                                           ).astype(np.int16)
    ref = np.asarray(compile_volume_pipeline(mies_tpu.load_config(CT_VOLUME))(
        jnp.asarray(hu)))
    cfg = mies_tpu_torch.load_config(CT_VOLUME)
    out = TC.compile_volume_pipeline(cfg, device="cpu")(hu).numpy()
    assert out.dtype == np.uint8 and out.shape == hu.shape
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    assert cfg.to_dict() == mies_tpu.load_config(CT_VOLUME).to_dict()


def test_volume_pipeline_quantize_false_and_launches_nothing_on_cpu(rng):
    cfg = PipelineConfig.make(
        [("clahe3d", {"clip_limit": 2.0, "grid_size": (2, 4, 4)})], name="w6")
    vol = rng.random((8, 32, 32)).astype(np.float32)
    _build.reset_launches()
    out = TC.compile_volume_pipeline(cfg, quantize=False, device="cpu")(vol)
    assert out.dtype == torch.float32
    assert torch.equal(out, TV.clahe3d(_t(vol), 2.0, (2, 4, 4)))
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)


def test_volume_and_slice_compilers_refuse_each_others_ops():
    two_d = PipelineConfig.make([("median_blur", {"kernel_size": 3})])
    with pytest.raises(ValueError, match="not volume-capable"):
        TC.compile_volume_pipeline(
            PipelineConfig.make([("bilateral_blur", {})]), device="cpu")
    with pytest.raises(ValueError):
        TC.compile_volume_pipeline(two_d, device="cpu")
    with pytest.raises(ValueError, match="volume-only"):
        TC.build_batched_chain(mies_tpu_torch.load_config(CT_VOLUME),
                               device="cpu")
    with pytest.raises(ValueError, match="volume-only"):
        mies_tpu_torch.compile_pipeline(
            PipelineConfig.make([("clahe3d", {})]), batched=True, device="cpu")


def test_volume_pipeline_runs_on_the_card_by_default():
    cfg = mies_tpu_torch.load_config(CT_VOLUME)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TC.compile_volume_pipeline(cfg)


@pytest.mark.parametrize("stage,match", [
    ({"op": "clahe3d", "grid_size": [8, 8]}, "triple"),
    ({"op": "clahe3d", "convention": "kornia"}, "convention"),
    ({"op": "gaussian_blur3d", "sigma": 0}, "sigma"),
    ({"op": "gaussian_blur", "truncate": -1}, "truncate"),
])
def test_bad_volume_values_raise_at_load(tmp_path, stage, match):
    import json

    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"pipeline": [stage]}))
    with pytest.raises(ValueError, match=match):
        mies_tpu_torch.load_config(p)


@pytest.mark.parametrize("dtype,lo,hi", [("int16", -1000, 1499),
                                         ("uint8", 0, 255),
                                         ("uint16", 0, 65535),
                                         (None, 0.0, 1.0)])
def test_make_batch_takes_the_declared_dtype(dtype, lo, hi):
    cfg = PipelineConfig.make([("window_hu", {"preset": "brain"})],
                              io={"dtype": dtype} if dtype else None)
    a = make_batch(cfg, (64, 64), 4, "cpu")
    assert a.dtype == {"int16": torch.int16, "uint8": torch.uint8,
                       "uint16": torch.uint16, None: torch.float32}[dtype]
    v = a.to(torch.float64)
    assert lo <= v.min().item() and v.max().item() <= hi
    # seeded values spread over the type's whole declared range
    assert v.max().item() - v.min().item() > 0.95 * (hi - lo)


def test_volume_timing_refuses_the_cpu():
    cfg = mies_tpu_torch.load_config(CT_VOLUME)
    with pytest.raises(RuntimeError, match="CUDA device"):
        time_volume(cfg, (8, 32, 32), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_volume(cfg, (8, 32, 32), device="cpu")


# --- the kernels on the card ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("grid,shape", [((4, 8, 8), (16, 128, 128)),
                                        ((3, 3, 5), (12, 96, 160))])
@pytest.mark.parametrize("convention,clip", [("opencv", 2.0),
                                             ("fraction", 0.01)])
def test_k1_k8_on_card_equal_plain(cuda_device, grid, shape, convention, clip):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    vol = torch.rand(shape, generator=g, device=cuda_device)
    _build.reset_launches()
    got = K3D.clahe3d_cuda(vol, clip, grid, convention)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["clahe3d_apply"] == 1
    assert torch.equal(got, TV.clahe3d(vol, clip, grid, convention))


def _k8_inputs(device, shape, grid, finalize, seed):
    """A volume in [0, 1] and LUTs: integer levels for u8norm, fractions
    around [0, 1] (the clip at work) for clip01."""
    g = torch.Generator(device=device).manual_seed(seed)
    vol = torch.rand(shape, generator=g, device=device)
    luts = torch.rand((*grid, 256), generator=g, device=device)
    luts = (torch.round(luts * 255.0) if finalize == "u8norm"
            else luts * 1.2 - 0.1)
    return vol, luts


@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid", [
    ((32, 512, 512), (4, 8, 8)), ((256, 512, 512), (4, 8, 8)),
    ((12, 96, 160), (3, 3, 5)), ((12, 96, 165), (3, 3, 5)),
    ((7, 33, 165), (1, 3, 5)), ((6, 20, 21), (2, 1, 3)),
    ((5, 9, 14), (5, 9, 7))])
@pytest.mark.parametrize("finalize", ["u8norm", "clip01"])
def test_k8_on_card_equals_plain(cuda_device, shape, grid, finalize):
    """K8's cell blocks: bit-equal to the plain gather at the main paths'
    shapes, at widths that are no multiple of 4 (scalar columns), on a
    single-tile axis (g = 1) and at tiles of one voxel; one launch."""
    vol, luts = _k8_inputs(cuda_device, shape, grid, finalize, 3)
    _build.reset_launches()
    got = K3D.clahe3d_apply_lut(vol, luts, grid, finalize)
    assert _build.LAUNCHES["clahe3d_apply"] == 1
    assert torch.equal(got, K3D.clahe3d_apply_lut_plain(vol, luts, grid,
                                                        finalize))


@pytest.mark.cuda
@pytest.mark.parametrize("finalize", ["u8norm", "clip01"])
def test_k8_on_card_takes_unaligned_rows_and_any_z(cuda_device, finalize):
    """Rows that are not 16-byte aligned (a volume one float into its
    storage) run the scalar columns; 65,540 slices, more than a grid
    dimension of the card takes, launch."""
    shape, grid = (8, 24, 64), (2, 3, 4)
    vol, luts = _k8_inputs(cuda_device, shape, grid, finalize, 4)
    off = torch.empty(vol.numel() + 1, device=cuda_device)[1:].view(shape)
    off.copy_(vol)
    assert off.data_ptr() % 16 and off.is_contiguous()
    want = K3D.clahe3d_apply_lut_plain(vol, luts, grid, finalize)
    assert torch.equal(K3D.clahe3d_apply_lut(off, luts, grid, finalize), want)
    shape, grid = (65540, 2, 4), (2, 1, 1)
    vol, luts = _k8_inputs(cuda_device, shape, grid, finalize, 5)
    assert torch.equal(K3D.clahe3d_apply_lut(vol, luts, grid, finalize),
                       K3D.clahe3d_apply_lut_plain(vol, luts, grid, finalize))


@pytest.mark.cuda
@pytest.mark.parametrize("convention,clip", [("opencv", 2.0),
                                             ("fraction", 0.01)])
def test_clahe3d_volume_on_card_equals_plain_at_main_path_shapes(
        cuda_device, convention, clip):
    """clahe3d_volume (K1 -> LUT build -> K8) at w6's [32, 512, 512] and
    the CT volume's [256, 512, 512], grid (4, 8, 8)."""
    for shape in ((32, 512, 512), (256, 512, 512)):
        vol = _k8_inputs(cuda_device, shape, (4, 8, 8), "u8norm", 6)[0]
        assert torch.equal(K3D.clahe3d_volume(vol, clip, (4, 8, 8), convention),
                           TV.clahe3d(vol, clip, (4, 8, 8), convention))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel_size", [((16, 128, 128), None),
                                               ((20, 251, 333), None),
                                               ((9, 40, 70), (3, 7, 11))])
def test_skimage3d_on_card_equals_plain(cuda_device, shape, kernel_size):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    vol = torch.rand(shape, generator=g, device=cuda_device)
    _build.reset_launches()
    got = K3D.clahe3d_volume(vol, 0.01, (4, 8, 8), "skimage", kernel_size)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["clahe3d_skimage_apply"] == 1
    assert torch.equal(got, TV.clahe3d(vol, 0.01, (4, 8, 8), "skimage",
                                       kernel_size))


def _k8s_inputs(device, shape, ks, nbins, seed):
    """The padded bins and edge-padded maps of a random volume, and K8s's
    crop (the plain scale-in and binning, K1 bins summed per kz, K6a)."""
    g = torch.Generator(device=device).manual_seed(seed)
    vol = torch.rand(shape, generator=g, device=device)
    pad0, _, ns = TV.skimage3d_geometry(shape, ks)
    binned = TV._skimage3d_binned(vol, ks, nbins)
    slab = binned[pad0[0]:pad0[0] + ns[0] * ks[0]]
    hists = KC.tile_hists_bins(slab, pad0[1:], ns[1:], ks[1:], nbins)
    hists = hists.reshape(ns[0], ks[0], ns[1], ns[2], nbins).sum(
        1, dtype=torch.int32)
    k_elems = ks[0] * ks[1] * ks[2]
    maps = KC.skimage_maps(hists, max(k_elems // 100, 1), k_elems)
    return binned, TV._edge_pad_maps(maps), (ks, pad0, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ks", [
    ((32, 512, 512), (8, 64, 64)),   # the vector path (x0 = 32)
    ((20, 251, 333), (5, 31, 41)),   # scalar columns: W0 % 4 != 0
    ((9, 40, 70), (3, 7, 11)),       # x0 = 5: scalar columns
    ((6, 40, 130), (16, 64, 16)),    # a single region block on z and y
    ((4, 36, 9), (2, 8, 32))])       # a single region block on x
@pytest.mark.parametrize("nbins", [2, 256, 1000])
def test_k8s_on_card_equals_plain(cuda_device, shape, ks, nbins):
    """K8s's region blocks, their 8 maps as two float4 a bin: bit-equal to
    the plain blend at every bin count the convention takes (up to 1000:
    32 KB of quads), at unaligned widths and at a single region block on
    an axis; one launch."""
    binned, maps, args = _k8s_inputs(cuda_device, shape, ks, nbins, 7)
    _build.reset_launches()
    got = K3D.clahe3d_skimage_apply(binned, maps, *args)
    assert _build.LAUNCHES["clahe3d_skimage_apply"] == 1
    assert torch.equal(got, K3D.clahe3d_skimage_apply_plain(binned, maps,
                                                            *args))


@pytest.mark.cuda
def test_k8s_on_card_takes_unaligned_rows_and_any_z(cuda_device):
    """Bins one int into their storage run the scalar columns; 65,540
    slices at kz = 2 (32,771 region blocks on grid z) launch."""
    binned, maps, args = _k8s_inputs(cuda_device, (8, 64, 64), (4, 16, 16),
                                     256, 8)
    off = torch.empty(binned.numel() + 1, dtype=torch.int32,
                      device=cuda_device)[1:].view(binned.shape)
    off.copy_(binned)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert torch.equal(K3D.clahe3d_skimage_apply(off, maps, *args),
                       K3D.clahe3d_skimage_apply_plain(binned, maps, *args))
    # random bins and integer maps: K1 bins takes the slices as its grid z
    shape, ks = (65540, 4, 8), (2, 4, 8)
    pad0, pad1, ns = TV.skimage3d_geometry(shape, ks)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    binned = torch.randint(0, 256, [s + a + b for s, a, b in
                                    zip(shape, pad0, pad1)], generator=g,
                           device=cuda_device, dtype=torch.int32)
    maps = torch.randint(0, 16384, [n + 2 for n in ns] + [256], generator=g,
                         device=cuda_device).to(torch.float32)
    args = (ks, pad0, shape)
    assert torch.equal(K3D.clahe3d_skimage_apply(binned, maps, *args),
                       K3D.clahe3d_skimage_apply_plain(binned, maps, *args))


@pytest.mark.cuda
def test_ct_volume_yaml_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    hu = torch.randint(-1000, 1500, (16, 128, 128), generator=g,
                       device=cuda_device, dtype=torch.int16)
    cfg = mies_tpu_torch.load_config(CT_VOLUME)
    _build.reset_launches()
    out = TC.compile_volume_pipeline(cfg)(hu)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "tile_hists": 1, "clahe3d_apply": 1}
    ref = TC.compile_volume_pipeline(cfg, device="cpu")(hu.cpu())
    d = (out.cpu().int() - ref.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3


# --- the whole volume registry on the card (chip_smoke.py phase 7 small) ----

CT3D = [("window_hu", {"center": 40.0, "width": 400.0}),
        ("median_blur3d", {"kernel_size": 3}),
        ("denoise_tv3d", {"weight": 0.03, "max_num_iter": 60}),
        ("clahe3d", {"clip_limit": 2.0, "grid_size": (4, 8, 8),
                     "convention": "opencv"}),
        ("unsharp_mask3d", {"radius": 1.0, "amount": 0.5})]


@pytest.mark.cuda
def test_ct3d_chain_on_card_equals_the_cpu_plain_chain(cuda_device):
    """K1 and K8 once a call and no other kernel; TV's root and sums round
    alike on both devices, so the uint8 output equals the CPU's."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    hu = (40 + 25 * torch.randn((16, 128, 128), generator=g,
                                device=cuda_device)).round().to(torch.int16)
    cfg = PipelineConfig.make(CT3D)
    _build.reset_launches()
    out = TC.compile_volume_pipeline(cfg)(hu)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "tile_hists": 1, "clahe3d_apply": 1}
    ref = TC.compile_volume_pipeline(cfg, device="cpu")(hu.cpu())
    assert torch.equal(out.cpu(), ref)


# card vs CPU bounds: 0 for min/max, box, Gaussian and IEEE pointwise ops;
# libm, summation order and cuFFT elsewhere (the CPU tests' bounds)
CARD_OPS = [
    ("equalize_hist", {}, 0.0), ("normalize", {}, 0.0),
    ("rescale_intensity", {}, 0.0), ("adjust_log", {}, 1e-6),
    ("normalize_meanstd", {}, 0.0), ("guided_blur3d", {}, 0.0),
    ("median_blur3d", {}, 0.0), ("unsharp_mask3d", {}, 0.0),
    ("top_hat3d", {"kernel_size": 5}, 0.0), ("morph_gradient3d", {}, 0.0),
    ("resample3d", {"depth": 20, "height": 80, "width": 120}, 1e-6),
    ("difference_of_gaussians3d", {}, 0.0),
    ("denoise_nl_means3d", {"patch_size": 3, "patch_distance": 3}, 2e-6),
    ("denoise_tv3d", {}, 2e-6), ("wiener3d", {}, 2e-5),
    ("anisotropic_diffusion3d", {"kappa": 0.1}, 1e-6), ("srad3d", {}, 1e-6),
    ("frangi3d", {"sigmas": (1.0, 2.0)}, 2e-6),
    ("sato3d", {"sigmas": (1.0, 2.0)}, 5e-6),
    ("meijering3d", {"sigmas": (1.0, 2.0)}, 5e-6),
    ("butterworth3d", {}, 2e-5), ("homomorphic3d", {}, 2e-5),
    ("denoise_wavelet3d", {}, 2e-6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("op,kw,tol", CARD_OPS, ids=[o for o, _, _ in CARD_OPS])
def test_volume_op_on_card_matches_the_cpu(cuda_device, op, kw, tol):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    vol = torch.rand((12, 67, 93), generator=g, device=cuda_device)
    fn = TC._volume_registry()[op]
    got, want = fn(vol, **kw).cpu(), fn(vol.cpu(), **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol
