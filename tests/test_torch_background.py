"""The port's Richardson-Lucy, rolling ball / subtract_background and
histogram_match against the JAX package on the CPU, the registry and
value rules of the 26 ops this slice adds, and their row-band forms.

* richardson_lucy (``ops/restoration.py``): within 2e-6 of the reference,
  whose ``fori_loop`` body is compiled (XLA:CPU contracts the shifted
  adds into FMAs over 30 iterations); 1-iteration runs bit-equal to the
  eager op's first step.
* rolling_ball / subtract_background (``ops/morphology.py``): bit-equal at
  downscale 1 (min and max are exact, jitted or not), bit-equal to the
  eager op at downscale 2 and within 3e-7 of the jitted one (the
  pyramid's FMAs) at 2, 4 and "auto".
* histogram_match through a config (the reference image a PNG both
  packages load): bit-equal to ``match_histograms`` per slice (its
  jitted interp's FMA rounded once), the uint8 chain output within 1
  level on < 1e-3 of pixels of the reference compiler's.
* Against tests/goldens/golden_ops.py at the reference's own bounds.
* The registry holds the reference's 99 ops (learned_denoise since the
  models were ported; until then it was refused by name with its ROADMAP
  item); a bad value of each new op's
  parameters is refused at load with the reference's own message.
* The row bands of the new stencil ops in gloo worlds of 2 and 4 (one
  spawn each): bit-equal to the unsharded op (shifted adds, min/max),
  the conv2d ops within 1e-6; the global ops refused with their reason.
"""

import functools
import json
import time
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import mies_tpu
import tests.goldens.golden_ops as G
from mies_tpu.ops import histogram as JH
from mies_tpu.ops import morphology as JM
from mies_tpu.ops import restoration as JR
from mies_tpu.pipeline.compiler import OP_REGISTRY as J_OPS
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.ops import morphology as TM
from mies_tpu_torch.ops import restoration as TR
from mies_tpu_torch.parallel import init_distributed, make_mesh, spatial_shard_apply
from mies_tpu_torch.parallel.halo import stage_receptive_field
from mies_tpu_torch.pipeline.compiler import OP_REGISTRY as T_OPS
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config

torch.set_num_threads(2)

SHAPES = [(2, 64, 96), (2, 67, 93)]
SPAWN_TIMEOUT_S = 120


def _batch(shape, seed=25) -> np.ndarray:
    """Seeded slices: a slow shading field under small bright blobs and
    noise, each slice of its own range."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    imgs = []
    for i in range(b):
        shade = 0.2 + 0.3 * (x / w) + 0.1 * i * (y / h)
        blobs = 0.3 * ((np.sin(x / 3.0 + i) * np.cos(y / 4.0)) > 0.8)
        imgs.append(shade + blobs + 0.03 * rng.standard_normal((h, w)))
    return np.clip(np.stack(imgs), 0, 1).astype(np.float32)


def _eager(fn, x, **kw) -> np.ndarray:
    return np.asarray(jax.vmap(functools.partial(fn, **kw))(jnp.asarray(x)))


def _jit(fn, x, **kw) -> np.ndarray:
    return np.asarray(jax.jit(jax.vmap(functools.partial(fn, **kw)))(
        jnp.asarray(x)))


# --- Richardson-Lucy --------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {}, {"psf_sigma": 2.0, "psf_size": 9, "num_iter": 10, "clip": False},
    {"num_iter": 12, "filter_epsilon": 0.05}])
def test_richardson_lucy_within_2e6(shape, kw):
    x = _batch(shape)
    got = TR.richardson_lucy(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, _jit(JR.richardson_lucy, x, **kw),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_richardson_lucy_one_step_bit_equal(shape):
    """One iteration outside the loop, op by op: the port's step is the
    reference's bits (shifted adds, a true division, a product)."""
    x = _batch(shape)
    taps = TR.gaussian_kernel1d(1.5, 3)
    j = jnp.asarray(x)
    im = jnp.full(j.shape, 0.5, jnp.float32)
    conv = jax.vmap(lambda a: JR._gauss_same(a, taps))(im) + np.float32(1e-12)
    want = im * jax.vmap(lambda a: JR._gauss_same(a, taps))(j / conv)
    got = TR.richardson_lucy(torch.from_numpy(x), num_iter=1, clip=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_richardson_lucy_against_the_golden():
    img = _batch((1, 64, 96))[0]
    got = TR.richardson_lucy(torch.from_numpy(img), num_iter=15).numpy()
    gold = G.richardson_lucy(img, TR._rl_psf(1.5, 7), num_iter=15)
    np.testing.assert_allclose(got, gold, atol=2e-5)


# --- the rolling ball ---------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {"radius": 5.0, "downscale": 1},
    {"radius": 8.0, "intensity": 0.05, "downscale": 1},
    {"radius": 6.0, "light_background": True, "downscale": 1}])
def test_subtract_background_downscale_1_bit_equal(shape, kw):
    x = _batch(shape)
    got = TM.subtract_background(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, _jit(JM.subtract_background, x, **kw))


@pytest.mark.parametrize("shape", SHAPES)
def test_rolling_ball_downscale_2_bit_equal_to_the_eager_op(shape):
    x = _batch(shape)
    kw = {"radius": 12.0, "intensity": 0.1, "downscale": 2}
    got = TM.rolling_ball(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, _eager(JM.rolling_ball, x, **kw))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {}, {"radius": 12.0, "downscale": 2}, {"radius": 40.0},
    {"radius": 20.0, "downscale": 4, "light_background": True}])
def test_subtract_background_pyramid_within_3e7(shape, kw):
    x = _batch(shape)
    got = TM.subtract_background(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, _jit(JM.subtract_background, x, **kw),
                               rtol=0, atol=3e-7)


def test_rolling_ball_against_the_goldens():
    img = _batch((1, 64, 96))[0]
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(TM.rolling_ball(t, 6.0).numpy(),
                                  G.rolling_ball(img, 6.0))
    np.testing.assert_array_equal(
        TM.rolling_ball(t, 8.0, intensity=0.05).numpy(),
        G.rolling_ball(img, 8.0, intensity=0.05))
    np.testing.assert_allclose(
        TM.subtract_background(t, 16.0, downscale=2).numpy(),
        G.subtract_background(img, 16.0, downscale=2), atol=1e-6)


def test_ball_table_and_shrink_schedule_equal_the_reference():
    for args in [(5.0, 5.0), (12.5, 0.05), (6.0, 6.0 / 255.0)]:
        np.testing.assert_array_equal(TM._ball_table(*args),
                                      JM._ball_table(*args))
    for r in (1.0, 10.0, 10.5, 30.0, 31.0, 100.0, 101.0):
        assert TM._imagej_shrink(r) == JM._imagej_shrink(r)
    with pytest.raises(ValueError, match="power-of-two"):
        TM._resolve_downscale(3, 5.0)


# --- histogram_match ----------------------------------------------------------

@pytest.fixture(scope="module")
def reference_png(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(6)
    ref = np.clip(rng.normal(140, 40, (48, 64)), 0, 255).astype(np.uint8)
    path = tmp_path_factory.mktemp("hm") / "ref.png"
    Image.fromarray(ref).save(path)
    return path


@pytest.mark.parametrize("shape", SHAPES)
def test_match_histograms_bit_equal_to_the_eager_op(reference_png, shape):
    from mies_tpu.io.image import load_image

    x = _batch(shape)
    values, quantiles = JH.reference_cdf(np.asarray(load_image(reference_png)))
    tv, tq = TH.reference_cdf(np.asarray(load_image(reference_png)))
    np.testing.assert_array_equal(tv, values)
    np.testing.assert_array_equal(tq, quantiles)
    got = TH.match_histograms(torch.from_numpy(x), torch.from_numpy(tv),
                              torch.from_numpy(tq)).numpy()
    want = np.stack([np.asarray(JH.match_histograms(
        jnp.asarray(s), jnp.asarray(values), jnp.asarray(quantiles)))
        for s in x])
    np.testing.assert_array_equal(got, want)


def test_histogram_match_through_a_config(reference_png, tmp_path):
    cfg_path = tmp_path / "hm.json"
    cfg_path.write_text(json.dumps({"name": "hm", "pipeline": [
        {"op": "histogram_match", "reference": str(reference_png)},
        {"op": "adjust_gamma", "gamma": 0.9}]}))
    x = _batch((2, 67, 93))
    got = compile_pipeline(load_config(cfg_path), batched=True,
                           device="cpu")(x).numpy()
    want = np.asarray(mies_tpu.compile_pipeline(
        mies_tpu.load_config(cfg_path), batched=True, donate=False)(
            jnp.asarray(x)))
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.dtype == np.uint8 and d.max() <= 1 and (d > 0).mean() < 1e-3
    gold = G.match_histograms(np.rint(x[0] * 255) / 255,
                              np.asarray(mies_tpu.io.image.load_image(
                                  reference_png)))
    assert np.abs(TH.match_histograms(
        torch.from_numpy(x[:1]), *map(torch.from_numpy, TH.reference_cdf(
            np.asarray(mies_tpu.io.image.load_image(reference_png)))))[0]
        .numpy() - gold).max() < 1e-6
    with pytest.raises(FileNotFoundError, match="reference image"):
        compile_pipeline(PipelineConfig.make(
            [("histogram_match", {"reference": str(tmp_path / "no.png")})]),
            device="cpu")


# --- the registry and the value rules ------------------------------------

NEW_OPS = [
    "affine_warp", "box_blur", "canny", "center_crop", "denoise_bilateral",
    "difference_of_gaussians", "farid_edges", "flip", "gabor", "gabor_bank",
    "histogram_match", "kuwahara", "laplace", "laplacian_sharpen",
    "motion_blur", "perspective_warp", "prewitt_edges", "resize", "retinex",
    "richardson_lucy", "roberts_edges", "rot90", "rotate", "scharr_edges",
    "sobel_edges", "subtract_background"]


def test_registry_is_the_references_less_learned_denoise(tmp_path):
    """Named when the registry was the reference's less learned_denoise;
    since the models are ported (queue 1 item 6) it is the reference's 99,
    and a learned_denoise config loads in both packages alike."""
    assert len(NEW_OPS) == 26 and set(NEW_OPS) <= set(T_OPS)
    assert set(J_OPS) == set(T_OPS) and len(T_OPS) == 99
    p = tmp_path / "ld.json"
    p.write_text(json.dumps({"pipeline": [
        {"op": "learned_denoise", "checkpoint": "ckpt"}]}))
    assert load_config(p).to_dict() == mies_tpu.load_config(p).to_dict()


BAD = [
    ("box_blur", {"kernel_size": 4}), ("box_blur", {"mode": "bogus"}),
    ("denoise_bilateral", {"sigma_spatial": 0}),
    ("denoise_bilateral", {"sigma_color": -1.0}),
    ("difference_of_gaussians", {"low_sigma": 0}),
    ("sobel_edges", {"mode": "bogus"}), ("scharr_edges", {"mode": 3}),
    ("prewitt_edges", {"mode": "x"}), ("farid_edges", {"mode": None}),
    ("roberts_edges", {"mode": "y"}), ("laplace", {"mode": "z"}),
    ("laplacian_sharpen", {"alpha": -0.5}),
    ("gabor", {"frequency": 0}), ("gabor", {"output": "phase"}),
    ("gabor", {"n_stds": 0}), ("gabor_bank", {"n_orientations": 0}),
    ("gabor_bank", {"output": "magnitude"}),
    ("motion_blur", {"kernel_size": 4}), ("motion_blur", {"direction": 2.0}),
    ("retinex", {"sigmas": []}), ("retinex", {"rescale": "log"}),
    ("retinex", {"eps": 0}), ("kuwahara", {"kernel_size": 1}),
    ("canny", {"sigma": 0}), ("canny", {"use_quantiles": 1}),
    ("canny", {"low_threshold": -1.0}),
    ("richardson_lucy", {"psf_size": 6}), ("richardson_lucy", {"num_iter": 0}),
    ("richardson_lucy", {"filter_epsilon": 0}),
    ("subtract_background", {"radius": 0}),
    ("subtract_background", {"downscale": 3}),
    ("subtract_background", {"light_background": "yes"}),
    ("resize", {"height": 0, "width": 8}),
    ("resize", {"height": 8, "width": 8, "method": "area"}),
    ("center_crop", {"height": 8, "width": -1}), ("rot90", {"k": 1.5}),
    ("rotate", {"angle": 5, "mode": "reflect"}), ("rotate", {"angle": "x"}),
    ("affine_warp", {"matrix": [[1, 0]], "offset": [0, 0]}),
    ("affine_warp", {"matrix": [[1, 0], [0, 1]], "offset": [0]}),
    ("perspective_warp", {"matrix": [[1, 0, 0], [0, 1, 0]]}),
    ("perspective_warp", {"matrix": [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                          "cval": "0"}),
    ("histogram_match", {"reference": ""}),
]


@pytest.mark.parametrize("op,params", BAD)
def test_bad_value_refused_with_the_references_message(tmp_path, op, params):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"pipeline": [{"op": op, **params}]}))
    with pytest.raises(ValueError) as want:
        mies_tpu.load_config(p)
    with pytest.raises(ValueError) as got:
        load_config(p)
    assert str(got.value) == str(want.value) and f"({op!r})" in str(got.value)


# --- row bands in gloo worlds ------------------------------------------------

BAND_H, BAND_W = 64, 96
BAND_CASES = {
    "box_blur": [("box_blur", {"kernel_size": 5})],
    "denoise_bilateral": [("denoise_bilateral", {})],
    "denoise_bilateral_wide": [("denoise_bilateral", {"sigma_spatial": 1.5,
                                                      "mode": "reflect"})],
    "edges": [("sobel_edges", {}), ("scharr_edges", {"mode": "nearest"}),
              ("prewitt_edges", {}), ("farid_edges", {}),
              ("roberts_edges", {}), ("laplace", {}),
              ("laplacian_sharpen", {"alpha": 0.3})],
    "dog": [("difference_of_gaussians", {"low_sigma": 1.0})],
    "retinex": [("retinex", {"sigmas": [1.0, 3.0]})],
    "kuwahara": [("kuwahara", {"kernel_size": 7})],
    "background": [("subtract_background", {"radius": 5.0, "downscale": 1})],
    "background_light": [("subtract_background", {
        "radius": 4.0, "intensity": 0.1, "light_background": True,
        "downscale": 1})],
    "chain": [("sobel_edges", {}), ("kuwahara", {}),
              ("subtract_background", {"radius": 3.0})],
    "gabor": [("gabor", {"frequency": 0.25, "theta": 0.5})],
    "gabor_bank": [("gabor_bank", {"frequency": 0.3, "n_orientations": 4})],
    "motion_blur": [("motion_blur", {"kernel_size": 7, "angle": 20.0})],
}
CONV_CASES = ("gabor", "gabor_bank", "motion_blur")


def _band_input() -> np.ndarray:
    return _batch((1, BAND_H, BAND_W), seed=31)[0]


def _band_worker(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        init_distributed(f"file://{store}", world, rank, device="cpu")
        mesh = make_mesh(data=1, space=world)
        i = mesh.get_local_rank("space")
        h = BAND_H // world
        band = _band_input()[i * h:(i + 1) * h]
        for name, stages in BAND_CASES.items():
            fn = spatial_shard_apply(PipelineConfig.make(stages), mesh,
                                     quantize=False)
            np.save(out_dir / f"{name}_{rank}.npy", fn(band).numpy())
        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _spawn(world: int, out: Path) -> Path:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_band_worker,
                         args=(r, world, str(out / "store"), str(out)))
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
def band_world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("bands2"))


@pytest.fixture(scope="module")
def band_world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("bands4"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(BAND_CASES))
def test_new_band_forms_equal_the_unsharded_op(request, world, name):
    out = request.getfixturevalue(f"band_world{world}")
    got = np.concatenate([np.load(out / f"{name}_{r}.npy")
                          for r in range(world)], axis=0)
    want = compile_pipeline(PipelineConfig.make(BAND_CASES[name]),
                            quantize=False, device="cpu")(
        torch.from_numpy(_band_input())).numpy()
    assert got.shape == want.shape
    if name in CONV_CASES:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,params,reason", [
    ("retinex", {"rescale": "minmax"}, "IMAGE-WIDE min/max"),
    ("subtract_background", {}, "decimated pyramid grids"),
    ("subtract_background", {"radius": 5.0, "downscale": 2},
     "decimated pyramid grids"),
    ("resize", {"height": 8, "width": 8}, "can read from anywhere"),
    ("rotate", {"angle": 3.0}, "can read from anywhere"),
    ("center_crop", {"height": 8, "width": 8}, "can read from anywhere"),
    ("histogram_match", {"reference": "x.png"}, "per-image CDF"),
    ("richardson_lucy", {}, "zero-pad border"),
    ("canny", {}, "global connectivity"),
    ("wiener", {}, "circulant FFT"),
])
def test_global_ops_refuse_the_row_bands(op, params, reason):
    with pytest.raises(ValueError, match=reason):
        stage_receptive_field(op, params)


@pytest.mark.parametrize("op,params,r", [
    ("box_blur", {}, 1), ("denoise_bilateral", {}, 3),
    ("denoise_bilateral", {"sigma_spatial": 2.0}, 6), ("farid_edges", {}, 2),
    ("roberts_edges", {}, 1), ("difference_of_gaussians", {}, 6),
    ("gabor", {}, 17), ("gabor_bank", {"n_orientations": 4}, 17),
    ("kuwahara", {"kernel_size": 7}, 3), ("retinex", {}, 120),
    ("motion_blur", {}, 4), ("subtract_background", {"radius": 5.0}, 10),
    ("normalize_meanstd", {}, 0)])
def test_receptive_fields_equal_the_reference(op, params, r):
    from mies_tpu.parallel.halo import stage_receptive_field as jfield

    assert stage_receptive_field(op, params) == jfield(op, params) == r
