"""The port's z-sharded volume chains (mies_tpu_torch.parallel.volume_shard),
K8z (K8 at a band's z offset), the slab-sharded enhance_volume(mesh=) and
the row-band morphology.

The sharded chains run in real gloo worlds of 2 and 4 processes on the CPU:
one ``spawn`` per world size runs every case (``_worker``, which imports
only torch and the port) and writes each rank's output as ``.npy``; the
tests stitch the slabs and hold them bit for bit against the port's
unsharded ``compile_volume_pipeline`` (``compile_pipeline`` for the 2-D
morphology band and ``enhance_volume`` without a mesh), and the clahe3d
band, resample3d and the mixed uint8 chain against the JAX package's
``volume_shard_apply`` on the conftest's fake CPU devices, within the
bounds tests/test_torch_volume*.py give each unsharded op. The plain K8z
is held against the reference's ``_trilinear_zband_gather`` at z offsets,
and K8z's launch is replayed on the CPU. K8z itself runs only on the card:
its tests carry the ``cuda`` marker and skip here (the file imports jax
only inside the CPU tests that need it: ``python -m pytest
tests/test_torch_volume_shard.py --noconftest -m cuda`` on the card).
"""

from __future__ import annotations

import json
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from pytest import skip

from mies_tpu_torch.kernels import _build
from mies_tpu_torch.kernels import clahe3d as K3D
from mies_tpu_torch.ops import volume3d as TV
from mies_tpu_torch.parallel import (
    clahe3d_band,
    init_distributed,
    make_mesh,
    spatial_shard_apply,
    volume_shard_apply,
)
from mies_tpu_torch.parallel.volume_shard import (
    _resample_band_geometry,
    volume_stage_z_field,
)
from mies_tpu_torch.pipeline import runner
from mies_tpu_torch.pipeline.compiler import (
    _volume_registry,
    compile_pipeline,
    compile_volume_pipeline,
)
from mies_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 120
SHAPE = (32, 24, 24)  # 8 slices a rank at world 4
MIXED = [("adjust_gamma", {"gamma": 0.9}),
         ("clahe3d", {"clip_limit": 2.0, "grid_size": (4, 4, 4)}),
         ("unsharp_mask3d", {"radius": 1.0, "amount": 0.5}),
         ("normalize", {})]
ISOTROPIC = [("resample3d", {"depth": 32, "height": 32, "width": 32}),
             ("window_hu", {"center": 40.0, "width": 400.0}),
             ("gaussian_blur3d", {"sigma": 1.0}),
             ("clahe3d", {"clip_limit": 2.0, "grid_size": (4, 4, 4)})]
RESAMPLES = [(64, 48, 40), (16, 24, 24), (32, 24, 24), (24, 40, 56)]
# name -> (stages, input, quantize): every stage branch of _build_zslab_fn
CASES = {
    "clahe3d_opencv": ([("clahe3d", {"clip_limit": 2.0,
                                     "grid_size": (8, 4, 4)})], "clahe",
                       False),
    "clahe3d_fraction": ([("clahe3d", {"clip_limit": 0.02,
                                       "grid_size": (8, 4, 4),
                                       "convention": "fraction"})],
                         "clahe", False),
    "gaussian_blur3d": ([("gaussian_blur3d", {"sigma": 1.5})], "vol", False),
    "median_blur3d": ([("median_blur3d", {"kernel_size": 3})], "vol", False),
    "unsharp_mask3d": ([("unsharp_mask3d", {"radius": 1.0, "amount": 1.0})],
                       "vol", False),
    "difference_of_gaussians3d": ([("difference_of_gaussians3d",
                                    {"low_sigma": 1.0})], "vol", False),
    "guided_blur3d": ([("guided_blur3d", {"kernel_size": 3, "eps": 1e-2}),
                       ("guided_blur3d", {"kernel_size": 5, "eps": 1e-3,
                                          "mode": "nearest"})], "vol", False),
    "normalize": ([("normalize", {})], "range", False),
    "rescale_intensity": ([("rescale_intensity", {})], "range", False),
    "equalize_hist": ([("equalize_hist", {})], "range", False),
    "erode3d": ([("erode3d", {"kernel_size": 3})], "vol", False),
    "dilate3d": ([("dilate3d", {"kernel_size": 3, "mode": "reflect"})],
                 "vol", False),
    "morph_open3d": ([("morph_open3d", {"kernel_size": 3})], "vol", False),
    "morph_close3d": ([("morph_close3d", {"kernel_size": 3})], "vol", False),
    "top_hat3d": ([("top_hat3d", {"kernel_size": 3})], "vol", False),
    "morph_gradient3d": ([("morph_gradient3d", {"kernel_size": 5,
                                                "mode": "nearest"}),
                          ("morph_gradient3d", {"kernel_size": 3})],
                         "vol", False),
    "black_hat3d": ([("black_hat3d", {"kernel_size": 3})], "vol", False),
    **{f"resample3d_{d}x{h}x{w}": (
        [("resample3d", {"depth": d, "height": h, "width": w})], "vol", False)
       for d, h, w in RESAMPLES},
    "isotropic_chain": (ISOTROPIC, "hu", True),
    "denoise_nl_means3d": ([("denoise_nl_means3d",
                             {"patch_size": 3, "patch_distance": 2,
                              "h": 0.1})], "noisy", False),
    "srad3d": ([("srad3d", {"niter": 3})], "noisy", False),
    "anisotropic_diffusion3d": ([("anisotropic_diffusion3d",
                                  {"niter": 3, "kappa": 0.1,
                                   "voxelspacing": (2.0, 1.0, 1.0)}),
                                 ("anisotropic_diffusion3d",
                                  {"niter": 2, "kappa": 0.1, "option": 2})],
                                "noisy", False),
    "sato3d": ([("sato3d", {"sigmas": (1.0,)})], "vol", False),
    "vessel_enhance3d": ([("vessel_enhance3d", {"sigmas": (1.0,),
                                                "gamma": 0.1})],
                         "vol", False),
    "pointwise": ([("window_hu", {"center": 40.0, "width": 400.0}),
                   ("adjust_sigmoid", {}), ("invert", {}),
                   ("adjust_log", {})], "hu", False),
    "mixed": (MIXED, "clahe", True),
}
MORPH_2D = PipelineConfig.make(
    [("top_hat", {"kernel_size": 5, "shape": "ellipse"}),
     ("morph_gradient", {"kernel_size": 3}),
     ("dilate", {"kernel_size": 3, "mode": "nearest"}),
     ("morph_close", {"kernel_size": 3, "shape": "cross"}),
     ("black_hat", {"kernel_size": 3}), ("erode", {"kernel_size": 1}),
     ("morph_open", {"kernel_size": 3})], name="morph-chain")
SLABS = PipelineConfig.make([("window_hu", {"center": 40.0, "width": 400.0}),
                             ("unsharp_mask", {"radius": 1.0, "amount": 0.5})],
                            name="vol-dp")


def _inputs() -> dict:
    rng = np.random.default_rng(1717)
    vol = rng.random(SHAPE).astype(np.float32)
    return {
        "vol": vol,
        "range": vol * 0.7 + 0.1,  # a non-trivial range for the rescales
        # tiles of 2,048 voxels or more: the port's unsharded clahe3d has
        # the JAX package's levels there (tiles of 144 moved 18 of 18,432
        # voxels by a level)
        "clahe": rng.random((32, 64, 64)).astype(np.float32),
        "noisy": (0.4 + 0.1 * rng.standard_normal(SHAPE)).clip(
            0.01, 1.0).astype(np.float32),
        "hu": (rng.random((16, 32, 32)) * 3000 - 1000).astype(np.float32),
        "slice": rng.random((128, 64)).astype(np.float32),
        "ct": rng.integers(-500, 1500, (20, 32, 32)).astype(np.int16),
    }


def _slab(x: np.ndarray, i: int, n: int) -> np.ndarray:
    """Slab i of n along the first axis."""
    z = x.shape[0] // n
    return x[i * z:(i + 1) * z]


def _error_of(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _rejections(world: int, mesh, x: dict) -> dict:
    """The errors the z-sharded paths raise, as messages ('' = no error)."""
    group = mesh.get_group("space")
    slab = _slab(x["vol"], dist.get_rank(), world)

    def run(stages):
        return volume_shard_apply(PipelineConfig.make(stages), mesh,
                                  quantize=False)(slab)

    return {
        "not_volume": _error_of(lambda: run([("bilateral_blur", {})])),
        "skimage": _error_of(lambda: run([("clahe3d",
                                           {"convention": "skimage"})])),
        "grid_z": _error_of(lambda: run([("clahe3d",
                                          {"grid_size": (world + 1, 4, 4)})])),
        "misaligned": _error_of(lambda: clahe3d_band(
            torch.zeros((5, 8, 8)), grid_size=(2 * world, 4, 4), group=group)),
        "tv": _error_of(lambda: run([("denoise_tv3d", {})])),
        "fft": _error_of(lambda: run([("butterworth3d", {})])),
        "gamma": _error_of(lambda: run([("frangi3d", {"sigmas": (1.0,)})])),
        "halo": _error_of(lambda: run([("gaussian_blur3d", {"sigma": 5.0})])),
        "depth": _error_of(lambda: run([("resample3d", {
            "depth": 33, "height": 24, "width": 24})])),
        "sharpness": _error_of(lambda: spatial_shard_apply(
            PipelineConfig.make([("sharpness", {"factor": 1.5})]), mesh)),
        "slab_size": _error_of(lambda: runner.enhance_volume(
            x["ct"], SLABS, slab_size=2 * world + 1, mesh=make_mesh())),
    }


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a gloo world: run every case on this rank's slab and
    save its output as <case>_<rank>.npy (errors as error_<rank>.txt)."""
    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        init_distributed(f"file://{store}", world, rank, device="cpu")
        x = _inputs()
        line = make_mesh(data=1, space=world)
        i = line.get_local_rank("space")

        def save(name, arr):
            np.save(out_dir / f"{name}_{rank}.npy", np.asarray(arr))

        for name, (stages, inp, quantize) in CASES.items():
            fn = volume_shard_apply(PipelineConfig.make(stages, name=name),
                                    line, quantize=quantize)
            save(name, fn(_slab(x[inp], i, world)))
        save("morph_2d", spatial_shard_apply(MORPH_2D, line)(
            np.ascontiguousarray(_slab(x["slice"], i, world))))
        # slab mode: rank 0 holds the volume; slab 8 leaves a short last slab
        got = runner.enhance_volume(x["ct"] if rank == 0 else None, SLABS,
                                    slab_size=8, mesh=make_mesh())
        assert (got is None) == (rank != 0)
        if rank == 0:
            save("enhance_volume", got)
        (out_dir / f"rejections_{rank}.json").write_text(
            json.dumps(_rejections(world, line, x)))
        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _spawn(world: int, out: Path) -> Path:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(out / "store"),
                                               str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f.read_text() for f in sorted(out.glob("error_*.txt"))]
    assert not hung, f"ranks still running after {SPAWN_TIMEOUT_S} s: {hung}"
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(params=[2, 4])
def world(request, world2, world4):
    return request.param, {2: world2, 4: world4}[request.param]


def _stitched(out: Path, name: str, n: int, axis: int = 0) -> np.ndarray:
    return np.concatenate([np.load(out / f"{name}_{r}.npy") for r in range(n)],
                          axis=axis)


def _unsharded(name: str) -> np.ndarray:
    stages, inp, quantize = CASES[name]
    return compile_volume_pipeline(
        PipelineConfig.make(stages, name=name), quantize=quantize,
        device="cpu")(torch.from_numpy(_inputs()[inp])).numpy()


def _jax_sharded(stages, x: np.ndarray, n: int, quantize: bool) -> np.ndarray:
    """The JAX package's volume_shard_apply on n of the fake CPU devices."""
    import jax
    import jax.numpy as jnp

    from mies_tpu.parallel import make_mesh as jax_mesh
    from mies_tpu.parallel import volume_shard_apply as jax_shard
    from mies_tpu.pipeline.config import PipelineConfig as JaxConfig

    mesh = jax_mesh(data=1, space=n, devices=jax.devices()[:n])
    return np.asarray(jax_shard(JaxConfig.make(stages), mesh,
                                quantize=quantize)(jnp.asarray(x)))


# --- the worlds ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_z_sharded_stage_equals_the_unsharded_volume_program(world, name):
    """Every stage branch, stitched, bit-equal to compile_volume_pipeline
    on the whole volume (the resamples change the shape)."""
    n, out = world
    got, want = _stitched(out, name, n), _unsharded(name)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_row_band_morphology_equals_compile_pipeline(world):
    """The 2-D morphology band forms (each erode or dilate level extended
    by its own border, +-inf rows for 'ignore'; a one-exchange gradient):
    stitched, bit-equal to the unsharded chain (the counterpart of
    tests/test_parallel.py test_spatial_sharding_morphology_exact)."""
    n, out = world
    want = compile_pipeline(MORPH_2D, device="cpu")(
        torch.from_numpy(_inputs()["slice"])).numpy()
    np.testing.assert_array_equal(_stitched(out, "morph_2d", n), want)


def test_enhance_volume_with_a_mesh_equals_without(world):
    """Each rank runs its part of every slab (a short last slab padded and
    cropped); rank 0 gets the whole output, equal to the unsharded run."""
    n, out = world
    x = _inputs()["ct"]
    np.testing.assert_array_equal(
        np.load(out / "enhance_volume_0.npy"),
        runner.enhance_volume(x, SLABS, slab_size=8, device="cpu"))


@pytest.mark.parametrize("case,match", [
    ("not_volume", "op 'bilateral_blur' is not volume-capable"),
    ("skimage", "convention 'skimage' does not z-shard"),
    ("grid_z", "not divisible by axis size"),
    ("misaligned", "not tile-aligned for grid"),
    ("tv", "denoise_tv3d is not z-shardable"),
    ("fft", "op 'butterworth3d' is not z-shardable"),
    ("gamma", "gamma=None normalizes by the per-scale GLOBAL max"),
    ("halo", "exceeds the local band size"),
    ("depth", "divisible by the axis size"),
    ("sharpness", ""),
    ("slab_size", "must divide by the mesh's"),
])
def test_z_sharded_rejections(world, case, match):
    """The reference's errors, raised on every rank (sharpness has its row
    band form, so its 2-D chain builds)."""
    n, out = world
    for r in range(n):
        msg = json.loads((out / f"rejections_{r}.json").read_text())[case]
        assert (match in msg) if match else msg == "", msg


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["clahe3d_opencv", "clahe3d_fraction",
                                  "resample3d_24x40x56", "mixed"])
def test_z_sharded_equals_the_jax_package(world2, world4, n, name):
    """The stitched slabs against the JAX package's volume_shard_apply at
    the same world size: the opencv band's levels equal
    (test_clahe3d_opencv_levels_equal_jax), the fraction band within 1e-5
    (test_clahe3d_fraction_matches_jax), the resample within 1e-6
    (test_resample3d_within_1e6_of_the_reference_and_scipy), the uint8
    chain within 1 level on < 1e-3 of voxels (test_ct_volume_yaml_
    matches_jax: XLA:CPU contracts the Gaussian passes into FMAs)."""
    stages, inp, quantize = CASES[name]
    got = _stitched({2: world2, 4: world4}[n], name, n)
    want = _jax_sharded(stages, _inputs()[inp], n, quantize)
    assert got.shape == want.shape
    if name == "clahe3d_opencv":
        np.testing.assert_array_equal(np.rint(got * 255.0),
                                      np.rint(want * 255.0))
    elif name == "mixed":
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    else:
        np.testing.assert_allclose(
            got, want, atol=1e-5 if name == "clahe3d_fraction" else 1e-6,
            rtol=0)


# --- in this process ----------------------------------------------------------


def _registry_params(op: str) -> list[dict]:
    """A few parameter sets per op: the defaults and the values that move
    its z field or its refusal."""
    extra = {
        "gaussian_blur3d": [{"sigma": 2.5, "truncate": 3.0}],
        "unsharp_mask3d": [{"radius": 1.5}],
        "median_blur3d": [{"kernel_size": 5}],
        "guided_blur3d": [{"kernel_size": 7}],
        "denoise_nl_means3d": [{"patch_size": 4, "patch_distance": 3}],
        "srad3d": [{"niter": 4}],
        "anisotropic_diffusion3d": [{"niter": 3}],
        "difference_of_gaussians3d": [{"low_sigma": 1.5, "high_sigma": 2.0}],
        "frangi3d": [{"sigmas": (1.0, 2.5), "gamma": 0.1}],
        "vessel_enhance3d": [{"gamma": 0.2}],
        "sato3d": [{"sigmas": (3.0,)}],
        "hessian3d": [{"gamma": None}],
        "erode3d": [{"kernel_size": 5}],
        "top_hat3d": [{"kernel_size": 5}],
    }
    return [{}, *extra.get(op, [])]


def test_volume_stage_z_field_equals_the_reference():
    """The same radius, or the same refusal and message, for every op of
    the port's volume registry."""
    from mies_tpu.parallel.volume_shard import volume_stage_z_field as ref

    def outcome(fn, op, params):
        try:
            return fn(op, dict(params))
        except ValueError as e:
            return f"ValueError: {e}"

    refused = set()
    for op in sorted(_volume_registry()):
        for params in _registry_params(op):
            got = outcome(volume_stage_z_field, op, params)
            assert got == outcome(ref, op, params), (op, params)
            if isinstance(got, str):
                refused.add(op)
    assert refused == {"denoise_tv3d", "denoise_wavelet3d", "meijering3d",
                       "butterworth3d", "homomorphic3d", "wiener3d",
                       "frangi3d", "vessel_enhance3d", "hessian3d"}
    assert volume_stage_z_field("hessian3d", {}) == 16
    with pytest.raises(ValueError, match="is not z-shardable"):
        volume_stage_z_field("bilateral_blur", {})


@pytest.mark.parametrize("z0", [0, 8, 16, 24])
def test_k8z_plain_bit_equals_jax_zband_gather(rng, z0):
    """The plain K8z blend of a band at global slice z0 against the
    reference's _trilinear_zband_gather (the same x -> y -> z lerps at
    the global z weights)."""
    import jax.numpy as jnp

    from mies_tpu.parallel.volume_shard import _trilinear_zband_gather

    grid, z_total, zb = (8, 4, 4), 32, 8
    u8 = rng.integers(0, 256, (zb, 32, 32)).astype(np.int32)
    luts = rng.integers(0, 256, (*grid, 256)).astype(np.float32)
    ref = np.asarray(_trilinear_zband_gather(
        jnp.asarray(u8), jnp.asarray(luts), grid, z_total, jnp.int32(z0)))
    out = TV._apply_luts_trilinear_gather(
        torch.from_numpy(u8), torch.from_numpy(luts), grid, z_total, z0)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("finalize", ["u8norm", "clip01"])
def test_k8z_plain_bands_concatenate_to_k8(rng, finalize):
    """Bands at every tile-aligned offset, concatenated, equal the whole
    volume's K8 (plain) bit for bit, and a band that is not whole z tiles
    is refused."""
    grid, shape = (4, 3, 5), (12, 96, 160)
    vol = torch.from_numpy(rng.random(shape).astype(np.float32))
    luts = torch.from_numpy(rng.integers(0, 256, (*grid, 256)).astype(
        np.float32) / (255.0 if finalize == "clip01" else 1.0))
    whole = K3D.clahe3d_apply_lut(vol, luts, grid, finalize)
    for zb in (3, 6, 12):
        bands = [K3D.clahe3d_apply_lut_band(vol[z0:z0 + zb].contiguous(), luts,
                                            grid, 12, z0, finalize)
                 for z0 in range(0, 12, zb)]
        assert torch.equal(torch.cat(bands), whole), zb
    with pytest.raises(ValueError, match="not whole z tiles"):
        K3D.clahe3d_apply_lut_band(vol[:4].contiguous(), luts, grid, 12, 3)
    with pytest.raises(ValueError, match="not whole z tiles"):
        K3D.clahe3d_apply_lut_band(vol[:6].contiguous(), luts, grid, 12, 9)


def _cell_start(c: int, t: int, inv: np.float32, lo: int, hi: int) -> int:
    """csrc/cells.cuh cell_start in numpy float32."""
    def cell(p):
        return int(np.floor(np.float32(p) * inv - np.float32(0.5)))
    p = min(max(c * t + (t + 1) // 2, lo), hi)
    while p > lo and cell(p - 1) >= c:
        p -= 1
    while p < hi and cell(p) < c:
        p += 1
    return p


@pytest.mark.parametrize("z_total,gz,zb", [(256, 4, 64), (256, 4, 128),
                                           (32, 8, 4), (12, 3, 4), (7, 7, 1),
                                           (9, 3, 9)])
def test_k8z_launch_covers_each_voxel_of_a_band_once(z_total, gz, zb):
    """K8z's z cells (kernels/clahe3d.py band_launch), with each cell's
    slices by the kernel's own f32 formula cut to the band, cover every
    slice of every band exactly once, at the tiles ops.volume3d.
    _axis_weights gives the whole volume; the rest of the launch is K8's."""
    tz = z_total // gz
    inv = np.float32(1.0) / np.float32(tz)
    lo, hi, _ = TV._axis_weights(z_total, tz, gz, "cpu")
    for z0 in range(0, z_total, zb):
        cz0, ncz, *rest = K3D.band_launch(z_total, z0, zb, (24, 64),
                                          (gz, 3, 4), True)
        assert rest == list(K3D.apply_launch((z_total, 24, 64), (gz, 3, 4),
                                             True))
        assert -1 <= cz0 and cz0 + ncz <= gz and ncz >= 1
        seen = np.zeros(zb, np.int64)
        for c in range(cz0, cz0 + ncz):
            p0 = _cell_start(c, tz, inv, z0, z0 + zb)
            p1 = _cell_start(c + 1, tz, inv, z0, z0 + zb)
            assert p0 < p1, (z0, c)  # no launched cell is empty
            seen[p0 - z0:p1 - z0] += 1
            assert (lo[p0:p1] == max(c, 0)).all()
            assert (hi[p0:p1] == min(c + 1, gz - 1)).all()
        assert (seen == 1).all(), (z0, seen)


def test_resample_taps_are_the_matrix_and_the_band_geometry():
    """Each output row's two taps hold every nonzero of the reference's
    matrix row; the z-sharded geometry's refusals and halos."""
    for n_in, n_out in ((32, 64), (32, 16), (7, 11), (5, 1), (1, 4), (4, 4)):
        m = TV._linear_resize_matrix(n_in, n_out)
        lo, hi, w_lo, w_hi = (t.numpy() for t in TV._resize_taps(
            n_in, n_out, torch.device("cpu")))
        back = np.zeros_like(m)
        np.add.at(back, (np.arange(n_out), lo), w_lo)
        np.add.at(back, (np.arange(n_out), hi), w_hi)
        np.testing.assert_array_equal(back, m)
    from mies_tpu.parallel.volume_shard import _resample_band_geometry as ref

    with pytest.raises(ValueError, match="divisible"):
        _resample_band_geometry(32, 30, 4)
    # the two taps keep halos tiny: an 8x downsample onto one-slice bands
    _, halo = _resample_band_geometry(64, 8, 8)
    assert halo <= 1
    for z, depth, n in ((32, 64, 4), (32, 16, 2), (16, 32, 4), (8, 64, 8),
                        (160, 320, 4), (64, 8, 8)):
        starts, halo = _resample_band_geometry(z, depth, n)
        assert halo == ref(z, depth, n)[1], (z, depth, n)
        assert starts == [(k * depth // n, k * z // n - halo) for k in range(n)]


# --- on the card ----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid,n", [((256, 512, 512), (4, 8, 8), 4),
                                          ((256, 512, 512), (4, 8, 8), 2),
                                          ((12, 96, 165), (6, 3, 5), 3),
                                          ((7, 33, 42), (7, 3, 6), 7)])
@pytest.mark.parametrize("finalize", ["u8norm", "clip01"])
def test_k8z_on_card_equals_plain_and_k8_at_every_band(cuda_device, shape,
                                                       grid, n, finalize):
    """K8z on each band of an n-way z split: bit-equal to the plain K8z,
    one launch each, the bands concatenated bit-equal to K8 on the whole
    volume (a width that is no multiple of 4 runs the scalar columns)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    vol = torch.rand(shape, generator=g, device=cuda_device)
    luts = torch.rand((*grid, 256), generator=g, device=cuda_device)
    luts = torch.round(luts * 255.0) if finalize == "u8norm" else luts * 1.2 - 0.1
    zb = shape[0] // n
    bands = []
    for i in range(n):
        band = vol[i * zb:(i + 1) * zb].contiguous()
        _build.reset_launches()
        got = K3D.clahe3d_apply_lut_band(band, luts, grid, shape[0], i * zb,
                                         finalize)
        assert _build.LAUNCHES["clahe3d_apply_band"] == 1
        assert torch.equal(got, K3D.clahe3d_apply_lut_band_plain(
            band, luts, grid, shape[0], i * zb, finalize)), i
        bands.append(got)
    assert torch.equal(torch.cat(bands), K3D.clahe3d_apply_lut(vol, luts, grid,
                                                               finalize))


@pytest.mark.cuda
def test_clahe3d_band_on_card_equals_clahe3d_at_world_1(cuda_device,
                                                       tmp_path):
    """clahe3d_band on an NCCL world of one (K1, the LUT all_gather, K8z)
    equals the unsharded K1 -> K8 clahe3d bit for bit."""
    from mies_tpu_torch.kernels.clahe3d import clahe3d_volume

    vol = torch.rand((64, 128, 128), device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(3))
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cuda")
    try:
        _build.reset_launches()
        got = clahe3d_band(vol, 2.0, (4, 8, 8))
        assert _build.LAUNCHES["clahe3d_apply_band"] == 1
        assert _build.LAUNCHES["clahe3d_apply"] == 0
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, clahe3d_volume(vol, 2.0, (4, 8, 8)))
