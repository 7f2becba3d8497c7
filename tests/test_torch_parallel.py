"""The port's row- and batch-sharded chains (mies_tpu_torch.parallel) and
K5, the band LUT apply.

The sharded chains run in real gloo worlds of 2 and 4 processes on the CPU:
one ``spawn`` per world size runs every case (``_worker``, which imports
only torch and the port) and writes each rank's output as ``.npy``; the
tests stitch the bands and hold them against the unsharded chain (CLAHE
and the halo rows bit for bit, the uint8 chains by tests/test_parallel.py's
rule), and against the JAX package where it has the same function (the
sharded JAX program on the conftest's fake CPU devices, or its unsharded
chain). The plain K5 is held against JAX's ``_bilinear_lut_apply`` at a
row offset and against the Pallas body ``blocks4_fracs_apply`` in
interpret mode. K5 itself runs only on the card: its test carries the
``cuda`` marker and skips here.
"""

import json
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from pytest import skip

from mies_tpu_torch.kernels import clahe as KC
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.parallel import (
    batch_spatial_shard_apply,
    clahe_spatial_shard,
    halo_extend_rows,
    init_distributed,
    make_mesh,
    shard_pipeline,
    spatial_shard_apply,
)
from mies_tpu_torch.parallel import mesh as PM
from mies_tpu_torch.parallel.clahe_shard import clahe_band
from mies_tpu_torch.parallel.halo import (
    chain_receptive_field,
    halo_extend_rows_multi,
    stage_receptive_field,
)
from mies_tpu_torch.parallel.sharding import shard_index
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig
from mies_tpu_torch.pipeline.presets import flagship_config

FLAGSHIP = flagship_config()
DIFFUSION = PipelineConfig.make(
    [("srad", {"niter": 3, "dt": 0.2}),
     ("anisotropic_diffusion", {"niter": 3, "kappa": 0.05, "gamma": 0.2}),
     ("lee_filter", {"kernel_size": 3, "sigma": 0.05}),
     ("gaussian_blur", {"sigma": 1.0})],
    name="diffusion-chain",
)
# BASELINE w4 (benchmarks/workloads.py) and a guided_blur chain in two
# border modes
W4 = PipelineConfig.make(
    [("window_hu", {"center": 40.0, "width": 400.0}),
     ("median_blur", {"kernel_size": 3}),
     ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                         "sigma_space": 1.5})], name="w4")
GUIDED = PipelineConfig.make(
    [("guided_blur", {"kernel_size": 5, "eps": 1e-3}),
     ("guided_blur", {"kernel_size": 3, "eps": 1e-2, "mode": "nearest"})],
    name="guided-chain")
CLAHE_CASES = (("opencv", 2.0), ("fraction", 0.02))
SPAWN_TIMEOUT_S = 120


def _inputs() -> dict:
    rng = np.random.default_rng(515)
    return {
        "clahe": rng.random((256, 128)).astype(np.float32),
        "flagship": rng.random((512, 256)).astype(np.float32),
        "diffusion": (0.2 + 0.6 * rng.random((256, 128))).astype(np.float32),
        "batch": rng.random((4, 256, 128)).astype(np.float32),
        "data": rng.random((8, 64, 64)).astype(np.float32),
        "w4": rng.integers(-200, 300, (256, 128)).astype(np.int16),
        "guided": rng.random((256, 128)).astype(np.float32),
    }


def _rows(x: np.ndarray, i: int, n: int) -> np.ndarray:
    """Band i of n of the row axis (-2)."""
    h = x.shape[-2] // n
    return x[..., i * h:(i + 1) * h, :]


def _error_of(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _rejections(world: int, mesh) -> dict:
    """The errors the sharded paths raise, as messages ('' = no error)."""
    group = mesh.get_group("space")
    skimage = PipelineConfig.make(
        [("clahe", {"clip_limit": 0.01, "convention": "skimage"})])
    kornia = PipelineConfig.make(
        [("clahe", {"clip_limit": 40.0, "convention": "kornia"})])
    lee = PipelineConfig.make([("lee_filter", {"kernel_size": 3})])
    tv = PipelineConfig.make([("denoise_tv", {"weight": 0.1})])
    band = torch.zeros((1, 2, 8))
    top_hat = PipelineConfig.make([("top_hat", {"kernel_size": 7})])
    sharp = PipelineConfig.make([("sharpness", {"factor": 1.5})])
    return {
        "grid_rows": _error_of(
            lambda: clahe_spatial_shard(mesh, grid_size=(world - 1, 4))),
        "misaligned": _error_of(
            lambda: clahe_band(torch.zeros((1, 31, 64)), grid_size=(2 * world, 4),
                               group=group)),
        "skimage": _error_of(lambda: spatial_shard_apply(skimage, mesh)),
        "kornia": _error_of(lambda: spatial_shard_apply(kornia, mesh)),
        "lee_no_sigma": _error_of(lambda: spatial_shard_apply(lee, mesh)),
        "global": _error_of(lambda: spatial_shard_apply(tv, mesh)),
        "halo": _error_of(lambda: halo_extend_rows(band, 3, group)),
        "halo_fits": _error_of(lambda: halo_extend_rows(band, 2, group)),
        "top_hat": _error_of(lambda: spatial_shard_apply(top_hat, mesh)),
        "sharpness": _error_of(lambda: spatial_shard_apply(sharp, mesh)),
    }


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a gloo world: run every case on this rank's shard and
    save its output as <case>_<rank>.npy (errors as <case>_<rank>.json)."""
    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        dev = init_distributed(f"file://{store}", world, rank, device="cpu")
        again = init_distributed(f"file://{store}", world, rank, device="cpu")
        assert dev == again == torch.device("cpu")
        x = _inputs()
        line = make_mesh(data=1, space=world)
        i = line.get_local_rank("space")

        def save(name, arr):
            np.save(out_dir / f"{name}_{rank}.npy", np.asarray(arr))

        for conv, clip in CLAHE_CASES:
            fn = clahe_spatial_shard(line, clip, (8, 4), conv)
            save(f"clahe_{conv}", fn(_rows(x["clahe"], i, world)))
        save("flagship", spatial_shard_apply(FLAGSHIP, line)(
            _rows(x["flagship"], i, world)))
        save("diffusion", spatial_shard_apply(DIFFUSION, line)(
            _rows(x["diffusion"], i, world)))
        save("w4", spatial_shard_apply(W4, line)(_rows(x["w4"], i, world)))
        save("guided", spatial_shard_apply(GUIDED, line, quantize=False)(
            _rows(x["guided"], i, world)))
        band = torch.from_numpy(_rows(x["clahe"], i, world).copy())
        save("halo", halo_extend_rows(band, 3, line.get_group("space"), "reflect"))
        for mode, ext in zip(("mirror", -1.0), halo_extend_rows_multi(
                band, 2, line.get_group("space"), ("mirror", -1.0))):
            save(f"halo_{mode}", ext)
        if world == 4:
            grid = make_mesh(data=2, space=2)
            j, k = grid.get_local_rank("data"), grid.get_local_rank("space")
            block = _rows(x["batch"][2 * j:2 * j + 2], k, 2)
            save("batch_flagship", batch_spatial_shard_apply(FLAGSHIP, grid)(block))
            s = shard_index(grid)
            save("shard_index", s)
            save("shard_pipeline",
                 shard_pipeline(FLAGSHIP, grid)(x["data"][2 * s:2 * s + 2]))
        (out_dir / f"rejections_{rank}.json").write_text(
            json.dumps(_rejections(world, line)))
        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _spawn(world: int, out: Path) -> Path:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(out / "store"), str(out)))
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


def _stitched(out: Path, name: str, n: int) -> np.ndarray:
    return np.concatenate([np.load(out / f"{name}_{r}.npy") for r in range(n)],
                          axis=-2)


def _unsharded(cfg, x) -> np.ndarray:
    batched = x.ndim == 3
    return compile_pipeline(cfg, batched=batched, device="cpu")(
        torch.from_numpy(x)).numpy()


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """tests/test_parallel.py's _assert_shard_matches rule on the CPU: <= 1
    level on < 0.1% of pixels (rare .5 ties of two CPU programs; one run
    saw 3 of 131,072 flagship pixels differ). A halo fault moves whole
    boundary rows, far past it."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


# --- plain K5 against the JAX package ---------------------------------------


def _count_luts(rng, b, grid, tile, convention):
    """LUTs built from the counts of a random image, as the chain builds
    them (fraction LUTs from counts keep the Pallas hi/lo bf16 selection
    exact)."""
    gy, gx = grid
    img = torch.from_numpy(rng.random((b, gy * tile[0], gx * tile[1]))
                           .astype(np.float32))
    hists = KC.tile_hists(img, grid).reshape(b, gy * gx, 256).to(torch.float32)
    build = TH._luts_opencv if convention == "opencv" else TH._luts_fraction
    clip = 2.0 if convention == "opencv" else 0.02
    return build(hists, clip, tile[0] * tile[1]).reshape(b, gy, gx, 256)


@pytest.mark.parametrize("grid,tile,n", [((8, 4), (16, 32), 4),
                                         ((6, 5), (11, 13), 3)])
def test_k5_plain_equals_jax_bilinear_at_offset(rng, grid, tile, n):
    """Every band of an n-way split: the port's plain K5 blend at the band's
    global rows == JAX _bilinear_lut_apply(..., y_offset), in levels."""
    import jax.numpy as jnp
    from mies_tpu.ops.histogram import _bilinear_lut_apply

    gy, gx = grid
    luts = _count_luts(rng, 1, grid, tile, "opencv")
    u8 = rng.integers(0, 256, (gy * tile[0], gx * tile[1])).astype(np.int32)
    hb = u8.shape[0] // n
    for i in range(n):
        band = u8[i * hb:(i + 1) * hb]
        ref = np.asarray(_bilinear_lut_apply(
            jnp.asarray(band), jnp.asarray(luts[0].numpy()), grid, tile,
            y_offset=i * hb))
        out = TH._bilinear_lut_apply(torch.from_numpy(band), luts[0], grid,
                                     tile, y_offset=i * hb).numpy()
        np.testing.assert_array_equal(np.rint(out), np.rint(ref))


def _blocks4_pallas(u8, luts, grid, tile, y_offset, integer_luts):
    """_bilinear_lut_apply_selection's blocks, corner maps and fraction
    blocks (the TPU branch, which the CPU never takes), run through the
    Pallas body blocks4_fracs_apply in interpret mode and cropped back."""
    import jax.numpy as jnp
    from mies_tpu.kernels.clahe import blocks4_fracs_apply

    gy, gx = grid
    h, w = u8.shape
    th, tw = tile
    py, px = th // 2, tw // 2
    ny1, nx1 = h // th + 1, w // tw + 1
    nb, shape_p = ny1 * nx1, (h + th, w + tw)

    def to_blocks(x):
        return x.reshape(ny1, th, nx1, tw).transpose(0, 2, 1, 3).reshape(nb, th * tw)

    up = np.pad(u8, ((py, th - py), (px, tw - px)), mode="edge")
    lp = np.pad(luts, ((1, 1), (1, 1), (0, 0)), mode="edge")
    m_row = y_offset // th
    m4 = np.stack([lp[m_row + ey:m_row + ey + ny1, ex:ex + nx1]
                   for ey in range(2) for ex in range(2)], axis=2)
    inv_th = np.float32(1.0) / np.float32(th)
    inv_tw = np.float32(1.0) / np.float32(tw)
    yfp = (np.arange(-py, h + th - py, dtype=np.float32)
           + np.float32(y_offset)) * inv_th - np.float32(0.5)
    xfp = np.arange(-px, w + tw - px, dtype=np.float32) * inv_tw - np.float32(0.5)
    yab = to_blocks(np.broadcast_to((yfp - np.floor(yfp))[:, None], shape_p))
    xab = to_blocks(np.broadcast_to((xfp - np.floor(xfp))[None, :], shape_p))
    res = np.asarray(blocks4_fracs_apply(
        jnp.asarray(to_blocks(up)), jnp.asarray(m4.reshape(nb, 4, 256)),
        jnp.asarray(yab), jnp.asarray(xab), integer_luts, interpret=True))
    resp = res.reshape(ny1, nx1, th, tw).transpose(0, 2, 1, 3).reshape(shape_p)
    return resp[py:py + h, px:px + w]


@pytest.mark.parametrize("convention", ["opencv", "fraction"])
def test_k5_plain_equals_pallas_blocks4(rng, convention):
    """The row-10 TPU kernel (_blocks4_fracs_kernel) in interpret mode, fed
    the blocks _bilinear_lut_apply_selection builds for band 1 of 2 of an
    8 x 4 grid of 16 x 32 tiles: integer LUTs and count-built fraction
    LUTs give the port's plain K5 blend bit for bit."""
    grid, tile, hb = (8, 4), (16, 32), 64
    luts = _count_luts(rng, 1, grid, tile, convention)[0].numpy()
    u8 = rng.integers(0, 256, (hb, grid[1] * tile[1])).astype(np.int32)
    ref = _blocks4_pallas(u8, luts, grid, tile, hb, convention == "opencv")
    out = TH._bilinear_lut_apply(torch.from_numpy(u8), torch.from_numpy(luts),
                                 grid, tile, y_offset=hb).numpy()
    np.testing.assert_array_equal(out, ref)


def test_k5_wrapper_rejects_misaligned_bands():
    band, luts = torch.zeros((1, 32, 64)), torch.zeros((1, 8, 4, 256))
    ok = KC.clahe_apply_lut_band(band, luts, (8, 4), (16, 16), 32)
    assert ok.shape == band.shape
    for tile, y_off in (((16, 16), 8), ((12, 16), 0), ((16, 15), 0),
                        ((16, 16), 112)):
        with pytest.raises(ValueError, match="not tile-aligned"):
            KC.clahe_apply_lut_band(band, luts, (8, 4), tile, y_off)


# --- the sharded chains in gloo worlds of 2 and 4 ---------------------------


@pytest.mark.parametrize("convention,clip", CLAHE_CASES)
def test_clahe_spatial_shard_exact(world, convention, clip):
    """Row-sharded CLAHE == the port's unsharded clahe bit for bit, and ==
    the JAX clahe_spatial_shard on the fake CPU devices."""
    import jax.numpy as jnp
    from mies_tpu.parallel import make_mesh as jax_mesh
    from mies_tpu.parallel.clahe_shard import clahe_spatial_shard as jax_shard

    n, out = world
    img = _inputs()["clahe"]
    got = _stitched(out, f"clahe_{convention}", n)
    cfg = PipelineConfig.make([("clahe", {"clip_limit": clip, "grid_size": (8, 4),
                                          "convention": convention})])
    np.testing.assert_array_equal(got, _unsharded(cfg, img))
    ref = np.asarray(jax_shard(jax_mesh(data=1, space=n), clip, (8, 4),
                               convention)(jnp.asarray(img)))
    np.testing.assert_array_equal(got, ref)


def test_spatial_shard_flagship_exact(world):
    """The flagship chain on a 512 x 256 slice in n row bands == the
    unsharded port chain and the JAX chain by tests/test_parallel.py's rule
    (bit-equal on the card: chip_smoke.py)."""
    import jax.numpy as jnp
    from mies_tpu.pipeline.compiler import compile_pipeline as jax_compile
    from mies_tpu.pipeline.config import from_dict

    n, out = world
    img = _inputs()["flagship"]
    got = _stitched(out, "flagship", n)
    assert got.dtype == np.uint8 and got.shape == img.shape
    _levels_close(got, _unsharded(FLAGSHIP, img))
    jax_cfg = from_dict(FLAGSHIP.to_dict())
    _levels_close(got, np.asarray(jax_compile(jax_cfg, donate=False)(jnp.asarray(img))))


def test_spatial_shard_diffusion_chain_exact(world):
    """srad and anisotropic_diffusion refresh their 2- and 1-row halos every
    iteration; with Lee and Gaussian after them the chain == unsharded."""
    n, out = world
    img = _inputs()["diffusion"]
    _levels_close(_stitched(out, "diffusion", n), _unsharded(DIFFUSION, img))


def test_spatial_shard_w4_exact(world):
    """BASELINE w4 on int16 HU in n row bands (window_hu pointwise, the
    median and the bilateral each extended by their own radius and border)
    == the unsharded chain: tests/test_parallel.py's rule, and bit-equal."""
    n, out = world
    img = _inputs()["w4"]
    got = _stitched(out, "w4", n)
    assert got.dtype == np.uint8 and got.shape == img.shape
    want = _unsharded(W4, img)
    _levels_close(got, want)
    np.testing.assert_array_equal(got, want)


def test_spatial_shard_guided_exact(world):
    """guided_blur in n row bands, every box mean halo-wrapped on its own,
    == the unsharded op bit for bit (float output), in 'reflect' and
    'nearest'."""
    n, out = world
    img = _inputs()["guided"]
    got = _stitched(out, "guided", n)
    want = compile_pipeline(GUIDED, batched=False, quantize=False,
                            device="cpu")(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_halo_extend_rows_gives_neighbour_rows(world):
    """Each band extended: its neighbours' real rows inside the slice, the
    border mode's rows at the global edges (scipy 'reflect', 'mirror', and
    a constant value)."""
    n, out = world
    img = _inputs()["clahe"]
    hb = img.shape[0] // n
    full = np.pad(img, ((3, 3), (0, 0)), mode="symmetric")
    mirror = np.pad(img, ((2, 2), (0, 0)), mode="reflect")
    const = np.pad(img, ((2, 2), (0, 0)), constant_values=-1.0)
    for r in range(n):
        np.testing.assert_array_equal(np.load(out / f"halo_{r}.npy"),
                                      full[r * hb:(r + 1) * hb + 6])
        # one exchange, two border modes (halo_extend_rows_multi)
        np.testing.assert_array_equal(np.load(out / f"halo_mirror_{r}.npy"),
                                      mirror[r * hb:(r + 1) * hb + 4])
        np.testing.assert_array_equal(np.load(out / f"halo_-1.0_{r}.npy"),
                                      const[r * hb:(r + 1) * hb + 4])


def test_batch_spatial_shard_on_2x2_mesh(world4):
    """[4, 256, 128] over a 2 x 2 mesh: 2 slices x 2 row bands per rank."""
    blocks = [np.load(world4 / f"batch_flagship_{r}.npy") for r in range(4)]
    got = np.concatenate([np.concatenate(blocks[2 * j:2 * j + 2], axis=-2)
                          for j in range(2)], axis=0)
    _levels_close(got, _unsharded(FLAGSHIP, _inputs()["batch"]))


def test_shard_pipeline_splits_over_both_dims(world4):
    """shard_pipeline on a 2 x 2 mesh: 4 distinct shards of 2 slices."""
    idx = [int(np.load(world4 / f"shard_index_{r}.npy")) for r in range(4)]
    assert sorted(idx) == [0, 1, 2, 3]
    got = np.concatenate([np.load(world4 / f"shard_pipeline_{r}.npy")
                          for r in np.argsort(idx)])
    _levels_close(got, _unsharded(FLAGSHIP, _inputs()["data"]))


@pytest.mark.parametrize("case,match", [
    ("grid_rows", "not divisible"), ("misaligned", "not tile-aligned"),
    ("skimage", "skimage"), ("kornia", "kornia"), ("lee_no_sigma", "sigma"),
    ("global", "global/tile extent"), ("halo", "exceeds the local band"),
    ("halo_fits", ""), ("top_hat", ""), ("sharpness", "")])
def test_sharded_rejections(world, case, match):
    """The reference's errors, raised on every rank (a halo of 3 over a
    band of 2 rows; a halo of 2 fits; morphology and sharpness have their
    band forms, so top_hat and sharpness build)."""
    n, out = world
    for r in range(n):
        msg = json.loads((out / f"rejections_{r}.json").read_text())[case]
        assert (match in msg) if match else msg == "", msg


# --- in this process ----------------------------------------------------------


def test_receptive_fields():
    """The reference's values and errors for the ported ops."""
    assert stage_receptive_field("gaussian_blur", {"sigma": 1.5}) == 6
    assert stage_receptive_field("unsharp_mask", {"radius": 1.5}) == 6
    assert stage_receptive_field("bilateral_blur", {}) == 2
    assert stage_receptive_field("denoise_nl_means",
                                 {"patch_size": 6, "patch_distance": 5}) == 8
    assert stage_receptive_field("lee_filter", {"sigma": 0.1}) == 2
    assert stage_receptive_field("srad", {"niter": 4}) == 8
    assert stage_receptive_field("anisotropic_diffusion", {}) == 10
    assert stage_receptive_field("window_hu", {}) == 0
    assert chain_receptive_field(PipelineConfig.make(
        [("bilateral_blur", {}), ("unsharp_mask", {"radius": 1.5})])) == 2 + 6
    for op, match in (("clahe", "global/tile"), ("denoise_tv", "global/tile"),
                      ("musica", "global/tile"), ("clahe3d", "unknown op"),
                      ("homomorphic", "global/tile"),
                      ("learned_denoise", "model-dependent")):
        with pytest.raises(ValueError, match=match):
            stage_receptive_field(op, {})
    with pytest.raises(ValueError, match="sigma"):
        stage_receptive_field("lee_filter", {})


def test_init_distributed_swallows_only_double_init(monkeypatch):
    """The benign double initialisation returns; a real failure raises."""
    def twice(*a, **kw):
        raise ValueError("trying to initialize the default process group twice!")

    def refused(*a, **kw):
        raise RuntimeError("connection to the store refused")

    monkeypatch.setattr(PM.dist, "init_process_group", twice)
    assert init_distributed(device="cpu") == torch.device("cpu")
    monkeypatch.setattr(PM.dist, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="refused"):
        init_distributed(device="cpu")


# --- on the card ----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid,n", [((2, 512, 512), (8, 8), 4),
                                          ((2, 258, 335), (6, 5), 3)])
@pytest.mark.parametrize("finalize", ["u8norm", "clip01"])
def test_k5_on_card_equals_plain_at_every_band(cuda_device, shape, grid, n,
                                              finalize):
    rng = np.random.default_rng(55)
    x = torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda_device)
    th, tw = shape[1] // grid[0], shape[2] // grid[1]
    hists = KC.tile_hists(x, grid).reshape(shape[0], -1, 256).to(torch.float32)
    build = TH._luts_opencv if finalize == "u8norm" else TH._luts_fraction
    luts = build(hists, 2.0 if finalize == "u8norm" else 0.02, th * tw)
    luts = luts.reshape(shape[0], *grid, 256).contiguous()
    hb = shape[1] // n
    bands = []
    for i in range(n):
        band = x[:, i * hb:(i + 1) * hb].contiguous()
        got = KC.clahe_apply_lut_band(band, luts, grid, (th, tw), i * hb, finalize)
        want = KC.clahe_apply_lut_band_plain(band, luts, grid, (th, tw), i * hb,
                                             finalize)
        assert torch.equal(got, want), (i, (got - want).abs().max().item())
        bands.append(got)
    assert torch.equal(torch.cat(bands, dim=1),
                       KC.clahe_apply_lut(x, luts, grid, finalize))
