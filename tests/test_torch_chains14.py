"""The three chains that the frequency, wavelet and ridge ops open to the
port, against the JAX package on the CPU, and their row sharding.

By ``tests/test_torch_chains13.py``'s rules:
* ``configs/xray_homomorphic.yaml`` (uint8: homomorphic -> unsharp +
  uint8) and ``configs/angio_vessel_enhance.yaml`` (uint8: median ->
  vessel_enhance -> rescale_intensity) through ``compile_pipeline(...,
  batched=True, device="cpu")`` against ``mies_tpu.compile_pipeline(...,
  batched=True)`` on the ingested float (the reference's jitted uint8
  ingest multiplies by 1/255): uint8 within 1 level on < 1e-3 of pixels;
  the port's uint8 chain equals its float chain on that float; a slice
  alone equals its row.
* ``configs/xray_wavelet_denoise.yaml`` (float32: denoise_wavelet ->
  opencv CLAHE -> uint8) by stage checks, never the whole chain against
  the XLA:CPU chain (ROADMAP.md queue 3: opencv CLAHE is held to cv2):
  ``denoise_wavelet`` against the JAX op on identical input within 2e-6
  (jitted on even extents, op by op on odd ones, where the jitted
  reference's fused adds move the noise estimate: tests/test_torch_
  wavelet.py), the CLAHE levels against cv2 on the port's denoised output,
  and the chain equal to that composition.
* The row-sharding table (``stage_receptive_field``) equals the
  reference's for every new op: the radius, ``hessian``'s default gamma 15,
  the ``gamma=None`` refusals, the global ops.
* ``vessel_enhance`` (gamma 0.1) and ``sato`` band chains in a gloo world
  of 2 on the CPU equal ``compile_pipeline`` bit for bit.
"""

import functools
import json
import time
import traceback
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import mies_tpu
import mies_tpu_torch
from mies_tpu.ops import wavelet as JW
from mies_tpu.parallel import halo as JHALO
from mies_tpu_torch.ops import histogram as TH
from mies_tpu_torch.ops import wavelet as TW
from mies_tpu_torch.parallel import (
    init_distributed,
    make_mesh,
    spatial_shard_apply,
)
from mies_tpu_torch.parallel import halo as THALO
from mies_tpu_torch.pipeline.config import PipelineConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
VESSELS = PipelineConfig.make(
    [("vessel_enhance", {"sigmas": (1.0, 2.0, 4.0), "gamma": 0.1,
                         "amount": 0.8})], name="vessels")
SATO = PipelineConfig.make(
    [("median_blur", {"kernel_size": 3}),
     ("sato", {"sigmas": (1.0, 2.5)})], name="sato")
SPAWN_TIMEOUT_S = 120


def _levels_close(a: np.ndarray, b: np.ndarray) -> None:
    """<= 1 uint8 level on < 0.1% of pixels."""
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def _xray_batch(xray, shape, seed) -> np.ndarray:
    """A crop of the conftest X-ray, then seeded slices of other contrast:
    dark vessels (lines) on a bright, noisy, unevenly lit field."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    imgs = [xray[37:37 + h, 51:51 + w]]
    for i in range(1, b):
        img = 0.55 + 0.25 * (x / w) - 0.15 * (y / h)
        for k, width in enumerate((1.0, 2.5)):
            c = (k + 1) * w / 3 + 4 * np.sin(y / (6.0 + i))
            img -= 0.25 * np.exp(-((x - c) / width) ** 2)
        img += 0.04 * i * rng.standard_normal((h, w))
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs).astype(np.float32)


def test_shipped_configs_pass_through_load_config():
    """The three configs load and equal the reference's, with the stages
    the chains below assume."""
    ops = {}
    for name in ("xray_homomorphic", "xray_wavelet_denoise",
                 "angio_vessel_enhance"):
        cfg = mies_tpu_torch.load_config(CONFIGS / f"{name}.yaml")
        assert cfg.to_dict() == mies_tpu.load_config(
            CONFIGS / f"{name}.yaml").to_dict()
        ops[name] = [s.op for s in cfg.stages]
    assert ops == {
        "xray_homomorphic": ["homomorphic", "unsharp_mask"],
        "xray_wavelet_denoise": ["denoise_wavelet", "clahe"],
        "angio_vessel_enhance": ["median_blur", "vessel_enhance",
                                 "rescale_intensity"],
    }


@pytest.mark.parametrize("config", ["xray_homomorphic",
                                    "angio_vessel_enhance"])
@pytest.mark.parametrize("shape", [(3, 64, 96), (1, 67, 93)])
def test_uint8_chain_matches_jax_compile_pipeline(xray, config, shape):
    path = CONFIGS / f"{config}.yaml"
    tcfg, jcfg = mies_tpu_torch.load_config(path), mies_tpu.load_config(path)
    x = _u8(_xray_batch(xray, shape, seed=shape[1]))
    fn = mies_tpu_torch.compile_pipeline(tcfg, batched=True, device="cpu")
    out = fn(x).numpy()
    xf = (x.astype(np.float64) / 255.0).astype(np.float32)
    np.testing.assert_array_equal(out, fn(xf).numpy())
    ref = np.asarray(mies_tpu.compile_pipeline(
        jcfg, batched=True, donate=False)(jnp.asarray(xf)))
    assert out.dtype == np.uint8 and out.shape == x.shape
    _levels_close(out, ref)
    single = mies_tpu_torch.compile_pipeline(tcfg, device="cpu")(x[-1]).numpy()
    np.testing.assert_array_equal(single, out[-1])


@pytest.mark.parametrize("shape", [(3, 64, 96), (1, 67, 93)])
def test_wavelet_config_stage_checks(xray, shape):
    tcfg = mies_tpu_torch.load_config(CONFIGS / "xray_wavelet_denoise.yaml")
    denoise, clahe = tcfg.stages
    x = _xray_batch(xray, shape, seed=5 + shape[1])
    x = (x + 0.03 * np.random.default_rng(1).standard_normal(x.shape)
         ).astype(np.float32)
    kw = denoise.kwargs()
    # 1. the denoiser on identical input (db2: 3 levels at 64 x 96 and
    #    67 x 93, each slice its own noise estimate)
    den = TW.denoise_wavelet(torch.from_numpy(x), **kw)
    jop = jax.vmap(functools.partial(JW.denoise_wavelet, **kw))
    if shape[1] % 2 == 0:
        jop = jax.jit(jop)
    np.testing.assert_allclose(den.numpy(), np.asarray(jop(jnp.asarray(x))),
                               rtol=0, atol=2e-6)
    # 2. CLAHE levels against cv2 on the port's denoised output
    ckw = clahe.kwargs()
    eq = TH.clahe(den, **ckw)
    cv = cv2.createCLAHE(ckw["clip_limit"], tuple(ckw["grid_size"]))
    for i in range(shape[0]):
        np.testing.assert_array_equal(
            _u8(eq[i].numpy()), cv.apply(_u8(den[i].numpy())))
    # the port's chain is that composition
    chain = mies_tpu_torch.compile_pipeline(tcfg, batched=True, device="cpu")
    np.testing.assert_array_equal(chain(x).numpy(), _u8(eq.numpy()))


@pytest.mark.parametrize("op", ["butterworth", "homomorphic",
                                "denoise_wavelet", "cycle_spin", "frangi",
                                "vessel_enhance", "sato", "meijering",
                                "hessian"])
def test_batched_outputs_are_contiguous(op):
    """A kernel stage after the op (K1 to the LUTs in the wavelet config,
    K4 after homomorphic) takes only contiguous tensors on the card; the
    butterworth crop and the inverse DWT's last crop are views."""
    x = torch.from_numpy(_xray_batch(
        np.full((128, 128), 0.5, np.float32), (3, 48, 64), seed=2))
    kw = {"npad": 8} if op == "butterworth" else {}
    out = mies_tpu_torch.pipeline.compiler.OP_REGISTRY[op](x, **kw)
    assert out.shape == x.shape and out.is_contiguous()


# --- row sharding -------------------------------------------------------------

RF_CASES = [
    *[(op, kw) for op in ("frangi", "vessel_enhance", "sato", "hessian")
      for kw in ({}, {"sigmas": (1.0, 2.5), "gamma": 0.1},
                 {"sigmas": (0.4,), "gamma": 2.0}, {"gamma": None})],
    ("hessian", {"sigmas": (1.0, 3.0)}),
    ("vessel_enhance", {"sigmas": (1.0, 2.0, 4.0), "gamma": 0.1,
                        "amount": 0.8}),
    *[(op, {}) for op in ("denoise_wavelet", "meijering", "butterworth",
                          "homomorphic", "cycle_spin")],
    ("meijering", {"sigmas": (1.0,), "alpha": 0.3}),
    ("cycle_spin", {"max_shifts": 0}),
]


def _receptive_field(fn, op, kw):
    try:
        return fn(op, kw)
    except ValueError as e:
        msg = str(e)
        return "global/tile" if "global/tile" in msg else msg


@pytest.mark.parametrize("op,kw", RF_CASES,
                         ids=[f"{op}-{i}" for i, (op, _) in enumerate(RF_CASES)])
def test_receptive_field_matches_reference(op, kw):
    got = _receptive_field(THALO.stage_receptive_field, op, kw)
    assert got == _receptive_field(JHALO.stage_receptive_field, op, kw)
    if op not in ("frangi", "vessel_enhance", "sato", "hessian"):
        assert got == "global/tile"
    elif "gamma" in kw and kw["gamma"] is None or (
            op in ("frangi", "vessel_enhance") and "gamma" not in kw):
        assert op != "sato" or isinstance(got, int)
        assert op == "sato" or "GLOBAL max Frobenius norm" in got
    else:
        assert isinstance(got, int) and got >= 2


def test_band_stage_takes_the_ridge_ops_own_border():
    for op in ("frangi", "vessel_enhance", "sato", "hessian"):
        assert THALO._DEFAULT_MODE[op] == JHALO._DEFAULT_MODE[op] == "reflect"


def _band_input() -> np.ndarray:
    rng = np.random.default_rng(14)
    y, x = np.mgrid[0:128, 0:96]
    img = 0.7 - 0.3 * np.exp(-((x - 40 - 6 * np.sin(y / 9.0)) / 2.0) ** 2)
    return (img + 0.03 * rng.standard_normal(img.shape)).astype(np.float32)


def _band_worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a gloo world: each chain on this rank's rows, saved as
    <chain>_<rank>.npy (an error as error_<rank>.txt)."""
    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        init_distributed(f"file://{store}", world, rank, device="cpu")
        mesh = make_mesh(data=1, space=world)
        i = mesh.get_local_rank("space")
        x = _band_input()
        h = x.shape[0] // world
        band = x[i * h:(i + 1) * h]
        for name, cfg in (("vessels", VESSELS), ("sato", SATO)):
            y = spatial_shard_apply(cfg, mesh, quantize=False)(band)
            np.save(out_dir / f"{name}_{rank}.npy", y.numpy())
        (out_dir / f"rf_{rank}.json").write_text(json.dumps(
            [THALO.chain_receptive_field(VESSELS),
             THALO.chain_receptive_field(SATO)]))
        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("world2")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_band_worker,
                         args=(r, 2, str(out / "store"), str(out)))
             for r in range(2)]
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


@pytest.mark.parametrize("name,cfg", [("vessels", VESSELS), ("sato", SATO)])
def test_band_chain_equals_compile_pipeline(world2, name, cfg):
    """The 128 x 96 slice split into two bands of 64 rows (halos of 16
    and 1 + 10 rows): the stitched bands equal the unsharded chain."""
    got = np.concatenate([np.load(world2 / f"{name}_{r}.npy")
                          for r in range(2)], axis=0)
    want = mies_tpu_torch.compile_pipeline(cfg, quantize=False, device="cpu")(
        torch.from_numpy(_band_input())).numpy()
    np.testing.assert_array_equal(got, want)
    assert json.loads((world2 / "rf_0.json").read_text()) == [16, 11]
