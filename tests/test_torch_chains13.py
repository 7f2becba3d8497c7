"""The chains that the intensity, equalization, median, guided and
morphology ops open to the port, against the JAX package on CPU, and the
port's coverage of the shipped configs.

* Every shipped config: all 14 load in ``mies_tpu_torch`` (11 since PR
  13's ops, the last three since the frequency, wavelet and ridge ops) and
  equal the reference's, as does a config with a learned_denoise stage.
* ``configs/histeq_baseline.yaml``, BASELINE w1 (equalize_hist ->
  adjust_gamma, batch 1), ``configs/mammo_microcalc_tophat.yaml`` and
  BASELINE w7 (median -> top_hat -> rescale_intensity) through
  ``compile_pipeline(..., batched=True, device="cpu")`` against
  ``mies_tpu.compile_pipeline(..., batched=True)`` on float input: uint8
  within 1 level on < 1e-3 of pixels (PERF.md section 2); histeq_baseline
  also against its golden chain.
* ``configs/ct_soft_tissue.yaml``, ``configs/ct_guided_denoise.yaml`` and
  BASELINE w4 (int16 HU) by stage checks, never the whole chain against
  the XLA:CPU chain, whose jitted window_hu multiplies by the reciprocal
  of the width (tests/test_torch_restoration.py holds the port's window
  levels to float64): the stages after window_hu against the JAX ops on
  identical float input (median bit-equal, guided_blur 1e-6, the
  bilateral 2e-6), CLAHE levels against cv2, and the unsharp + uint8 tail
  against the reference's own tail given the same input; the port's chain
  equals the composition of the stages checked.
* The row-sharding table (``stage_receptive_field``) equals the
  reference's for every new op, radius or refusal; the band form refuses
  morphology and sharpness by name.
"""

import functools
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
from mies_tpu.ops import filters as JF
from mies_tpu.parallel import halo as JHALO
from mies_tpu_torch.ops import filters as TF
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.ops import intensity as TI
from mies_tpu_torch.parallel import halo as THALO
from mies_tpu_torch.pipeline.compiler import _quantize_u8
from mies_tpu_torch.pipeline.config import PipelineConfig, StageConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
# BASELINE w1, w4 and w7 (benchmarks/workloads.py)
W1 = [("equalize_hist", {}), ("adjust_gamma", {"gamma": 0.8})]
W4 = [("window_hu", {"center": 40.0, "width": 400.0}),
      ("median_blur", {"kernel_size": 3}),
      ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                          "sigma_space": 1.5})]
W7 = [("median_blur", {"kernel_size": 3}),
      ("top_hat", {"kernel_size": 7, "shape": "ellipse"}),
      ("rescale_intensity", {"out_range": (0.0, 1.0)})]


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """<= 1 uint8 level on < 0.1% of pixels (XLA:CPU FMA rounding ties)."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_eleven_of_the_fourteen_shipped_configs_load(tmp_path):
    """Named when 11 loaded; since the frequency, wavelet and ridge ops all
    14 do. A config whose second stage is learned_denoise, refused until
    the models were ported, loads in both packages alike."""
    paths = sorted(CONFIGS.glob("*.yaml"))
    assert len(paths) == 14
    loaded = []
    for p in paths:
        cfg = mies_tpu_torch.load_config(p)
        assert cfg.to_dict() == mies_tpu.load_config(p).to_dict()
        loaded.append(p.stem)
    assert len(loaded) == 14, loaded
    unported = tmp_path / "learned.yaml"
    unported.write_text("name: dn\npipeline:\n  - {op: median_blur}\n"
                        "  - {op: learned_denoise, checkpoint: dn.ckpt}\n")
    assert mies_tpu_torch.load_config(unported).to_dict() == \
        mies_tpu.load_config(unported).to_dict()


def _xray_batch(xray, shape, dtype, seed) -> np.ndarray:
    """Crops of the conftest X-ray beside seeded noise of another range,
    as float32 or uint8 levels."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    imgs = [xray[37:37 + h, 51:51 + w]]
    imgs += [(0.2 + 0.5 * rng.random((h, w))).astype(np.float32)] * (b - 1)
    x = np.stack(imgs[:b]).astype(np.float32)
    if dtype == "uint8":
        return np.clip(np.rint(x * 255), 0, 255).astype(np.uint8)
    return x


def _both(stages_or_path):
    if isinstance(stages_or_path, Path):
        return (mies_tpu_torch.load_config(stages_or_path),
                mies_tpu.load_config(stages_or_path))
    return (mies_tpu_torch.PipelineConfig.make(stages_or_path),
            mies_tpu.PipelineConfig.make(stages_or_path))


@pytest.mark.parametrize("chain,dtype,shape", [
    ("histeq_baseline", "uint8", (2, 64, 96)),
    ("histeq_baseline", "uint8", (1, 67, 93)),
    ("w1", "float32", (1, 96, 160)),
    ("mammo_microcalc_tophat", "uint8", (2, 96, 160)),
    ("mammo_microcalc_tophat", "uint8", (1, 67, 93)),
    ("w7", "float32", (2, 64, 96)),
    ("w7", "float32", (1, 67, 93)),
])
def test_chain_matches_jax_compile_pipeline(xray, chain, dtype, shape):
    """uint8 input: the port ingests by true division (level / 255, the
    float64 quotient rounded once); the reference's jitted ingest
    multiplies by the reciprocal, which moves pixels of the uint8 lattice
    across equalize_hist's bin edges (up to 4 levels on 4.6% of the
    67 x 93 crop against the reference's own golden). So the JAX chain
    takes the ingested float, and the port's uint8 chain must equal its
    float chain on that float."""
    spec = {"w1": W1, "w7": W7}.get(chain, CONFIGS / f"{chain}.yaml")
    tcfg, jcfg = _both(spec)
    x = _xray_batch(xray, shape, dtype, seed=len(chain))
    fn = mies_tpu_torch.compile_pipeline(tcfg, batched=True, device="cpu")
    out = fn(x).numpy()
    xf = x if dtype == "float32" else (
        x.astype(np.float64) / 255.0).astype(np.float32)
    np.testing.assert_array_equal(out, fn(xf).numpy())
    ref = np.asarray(mies_tpu.compile_pipeline(
        jcfg, batched=True, donate=False)(jnp.asarray(xf)))
    assert out.dtype == np.uint8 and out.shape == x.shape
    _levels_close(out, ref)
    single = mies_tpu_torch.compile_pipeline(tcfg, device="cpu")(x[0]).numpy()
    np.testing.assert_array_equal(single, out[0])


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 67, 93)])
def test_histeq_baseline_matches_golden_chain(xray, shape):
    """configs/histeq_baseline.yaml on uint8 against the golden numpy
    transcription of skimage's equalize_hist (float64), then gamma 0.8."""
    cfg = mies_tpu_torch.load_config(CONFIGS / "histeq_baseline.yaml")
    x = _xray_batch(xray, shape, "uint8", seed=11)
    out = mies_tpu_torch.compile_pipeline(cfg, batched=True,
                                          device="cpu")(x).numpy()
    gold = np.stack([
        _u8(G.equalize_hist(im.astype(np.float64) / 255.0) ** 0.8)
        for im in x])
    _levels_close(out, gold)


def _hu(shape, seed) -> np.ndarray:
    """An int16 phantom mostly inside the soft-tissue window, smooth
    anatomy plus noise (the median and guided filters see edges and
    flats)."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    organ = np.where((y - h / 2) ** 2 + (x - w / 2) ** 2 < (h / 3) ** 2,
                     60.0, -80.0)
    noise = 40.0 * rng.standard_normal(shape)
    return np.clip(organ + noise, -1000, 1500).astype(np.int16)


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("config", ["ct_soft_tissue", "ct_guided_denoise"])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 67, 93)])
def test_ct_config_stage_checks(config, shape):
    tcfg = mies_tpu_torch.load_config(CONFIGS / f"{config}.yaml")
    window, denoise, clahe, tail = tcfg.stages
    hu = _hu(shape, seed=shape[1])
    t = TI.window_hu(torch.from_numpy(hu), **window.kwargs())
    x = t.numpy()
    # 1. the denoiser on identical float input
    kw = denoise.kwargs()
    den = TF.median_blur(t, **kw) if denoise.op == "median_blur" else \
        TF.guided_blur(t, **kw)
    jop = functools.partial(getattr(JF, denoise.op), **kw)
    eager = np.asarray(jop(jnp.asarray(x[-1])))
    np.testing.assert_array_equal(den[-1].numpy(), eager)
    bound = np.asarray(jax.jit(jax.vmap(jop))(jnp.asarray(x)))
    if denoise.op == "median_blur":
        np.testing.assert_array_equal(den.numpy(), bound)
    else:
        np.testing.assert_allclose(den.numpy(), bound, rtol=0, atol=1e-6)
    # 2. CLAHE levels against cv2
    ckw = clahe.kwargs()
    eq = TH.clahe(den, **ckw)
    cv = cv2.createCLAHE(ckw["clip_limit"], tuple(ckw["grid_size"]))
    for i in range(shape[0]):
        np.testing.assert_array_equal(
            _u8(eq[i].numpy()), cv.apply(_u8(den[i].numpy())))
    # 3. the unsharp + uint8 tail against the reference's, same input
    tail_cfg = [(tail.op, tail.kwargs())]
    got_tail = mies_tpu_torch.compile_pipeline(
        PipelineConfig.make(tail_cfg), batched=True, device="cpu")(eq).numpy()
    ref_tail = np.asarray(mies_tpu.compile_pipeline(
        mies_tpu.PipelineConfig.make(tail_cfg), batched=True,
        donate=False)(jnp.asarray(eq.numpy())))
    np.testing.assert_array_equal(got_tail, ref_tail)
    # the port's chain is the composition of the stages checked
    chain = mies_tpu_torch.compile_pipeline(tcfg, batched=True, device="cpu")
    np.testing.assert_array_equal(chain(hu).numpy(), got_tail)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 67, 93)])
def test_w4_stage_checks(shape):
    tcfg = mies_tpu_torch.PipelineConfig.make(W4, name="w4")
    window, median, bilateral = tcfg.stages
    hu = _hu(shape, seed=7 + shape[1])
    t = TI.window_hu(torch.from_numpy(hu), **window.kwargs())
    med = TF.median_blur(t, **median.kwargs())
    jmed = jax.vmap(functools.partial(JF.median_blur, **median.kwargs()))
    np.testing.assert_array_equal(
        med.numpy(), np.asarray(jmed(jnp.asarray(t.numpy()))))
    bil = TF.bilateral_blur(med, **bilateral.kwargs())
    jbil = np.asarray(jax.jit(jax.vmap(functools.partial(
        JF.bilateral_blur, **bilateral.kwargs())))(jnp.asarray(med.numpy())))
    np.testing.assert_allclose(bil.numpy(), jbil, rtol=0, atol=2e-6)
    _levels_close(_quantize_u8(bil).numpy(), _u8(jbil))
    out = mies_tpu_torch.compile_pipeline(tcfg, batched=True, device="cpu")(hu)
    np.testing.assert_array_equal(out.numpy(), _quantize_u8(bil).numpy())


# --- row sharding -------------------------------------------------------------

RF_CASES = [
    ("median_blur", {}), ("median_blur", {"kernel_size": 7}),
    ("guided_blur", {}), ("guided_blur", {"kernel_size": 5, "eps": 1e-3}),
    ("sharpness", {"factor": 2.0}),
    *[(op, kw) for op in ("erode", "dilate", "morph_gradient", "morph_open",
                          "morph_close", "top_hat", "black_hat")
      for kw in ({}, {"kernel_size": 7, "shape": "ellipse"})],
    *[(op, {}) for op in ("adjust_gamma", "adjust_log", "adjust_sigmoid",
                          "invert", "adjust_brightness", "adjust_contrast",
                          "solarize", "posterize")],
    *[(op, {}) for op in ("equalize_hist", "equalize", "normalize",
                          "rescale_intensity")],
    ("rescale_intensity", {"in_range": (0.1, 0.9)}),
]


def _receptive_field(fn, op, kw):
    try:
        return fn(op, kw)
    except ValueError as e:
        return "global/tile" if "global/tile" in str(e) else str(e)


@pytest.mark.parametrize("op,kw", RF_CASES,
                         ids=[f"{op}-{i}" for i, (op, _) in enumerate(RF_CASES)])
def test_receptive_field_matches_reference(op, kw):
    got = _receptive_field(THALO.stage_receptive_field, op, kw)
    assert got == _receptive_field(JHALO.stage_receptive_field, op, kw)
    assert got == "global/tile" or isinstance(got, int)


@pytest.mark.parametrize("op,kw", [
    ("top_hat", {"kernel_size": 7, "shape": "ellipse"}), ("sharpness", {}),
    ("erode", {}), ("dilate", {}), ("morph_open", {}), ("morph_close", {}),
    ("morph_gradient", {}), ("black_hat", {})])
def test_band_stage_refuses_ops_without_a_band_form(op, kw, tmp_path):
    """The generic band path would pad sharpness's interior mask wrong, so
    sharpness has its own band form (the global first and last rows pass
    through on the edge ranks); so has morphology (each erode or dilate
    level extended by its own border, +-inf rows for 'ignore'). On a gloo
    world of one, where both edges are global, each is the unsharded op
    bit for bit (worlds of 2 and 4: tests/test_torch_volume_shard.py and
    tests/test_torch_dp_files.py)."""
    from mies_tpu_torch.parallel import init_distributed
    from mies_tpu_torch.pipeline.compiler import OP_REGISTRY

    stage = StageConfig.make(op, **kw)
    x = torch.from_numpy(np.random.default_rng(13).random(
        (2, 40, 36)).astype(np.float32))
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        got = THALO._band_stage(stage, None)(x)
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(got, OP_REGISTRY[op](x, **kw))


def test_band_stage_takes_median_with_its_own_border():
    """median_blur's default border in the band path is the op's own."""
    assert THALO._DEFAULT_MODE["median_blur"] == JHALO._DEFAULT_MODE[
        "median_blur"] == "nearest"
