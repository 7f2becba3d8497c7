"""The port's flagship slice end to end, against the JAX package on CPU.

compile_pipeline(flagship_config(), batched=True) of both packages on the
same seeded inputs: CLAHE -> bilateral -> unsharp -> uint8. The JAX chain
on XLA:CPU FMA-contracts, so the uint8 outputs may differ by one level on
rounding ties (<= 1 level on < 1e-3 of pixels, the cv2 CPU rule).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mies_tpu
import mies_tpu_torch
from mies_tpu.pipeline.presets import flagship_config as jax_flagship
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.pipeline.compiler import build_chain
from mies_tpu_torch.pipeline.presets import flagship_config, latency_config
from mies_tpu_torch.pipeline.runner import main as runner_main
from mies_tpu_torch.pipeline.runner import (
    profile_pipeline,
    time_latency,
    time_pipeline,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _batch(xray, rng, dtype) -> np.ndarray:
    x = np.stack([xray, rng.random(xray.shape).astype(np.float32)])
    if dtype == "uint8":
        return np.clip(np.rint(x * 255), 0, 255).astype(np.uint8)
    return x


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_flagship_batched_matches_jax(xray, rng, dtype):
    x = _batch(xray, rng, dtype)
    ref = np.asarray(mies_tpu.compile_pipeline(
        jax_flagship(), batched=True, donate=False)(jnp.asarray(x)))
    out = mies_tpu_torch.compile_pipeline(
        flagship_config(), batched=True, device="cpu")(x).numpy()
    assert out.dtype == np.uint8 and out.shape == x.shape
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1, f"max level diff {d.max()}"
    assert (d > 0).mean() < 1e-3, f"mismatch frac {(d > 0).mean()}"


def test_single_slice_equals_batched(rng):
    x = torch.from_numpy(rng.random((2, 96, 128)).astype(np.float32))
    cfg = flagship_config()
    batched = mies_tpu_torch.compile_pipeline(cfg, batched=True,
                                              device="cpu")(x)
    single = mies_tpu_torch.compile_pipeline(cfg, device="cpu")(x[1])
    assert torch.equal(single, batched[1])


def test_per_channel_fold_equals_batched(rng):
    x = torch.from_numpy(rng.random((2, 3, 48, 64)).astype(np.float32))
    fn = mies_tpu_torch.compile_pipeline(latency_config(), batched=True,
                                         device="cpu")
    out = fn(x)
    assert out.shape == x.shape
    assert torch.equal(out, fn(x.reshape(6, 48, 64)).reshape(x.shape))


def test_quantize_false_returns_float(rng):
    x = torch.from_numpy(rng.random((1, 64, 64)).astype(np.float32))
    fn = mies_tpu_torch.compile_pipeline(flagship_config(), batched=True,
                                         quantize=False, device="cpu")
    out = fn(x)
    assert out.dtype == torch.float32
    q = mies_tpu_torch.compile_pipeline(flagship_config(), batched=True,
                                        device="cpu")(x)
    assert torch.equal(torch.round(out * 255.0).to(torch.uint8), q)
    assert torch.equal(build_chain(flagship_config(), device="cpu")(x[0]),
                       out[0])


def test_load_config_same_in_both_packages():
    path = REPO / "configs" / "xray_clahe.yaml"
    got = mies_tpu_torch.load_config(path)
    assert got.to_dict() == mies_tpu.load_config(path).to_dict()
    assert got == mies_tpu_torch.PipelineConfig.make(
        [(s.op, s.kwargs()) for s in got.stages], name=got.name,
        io=got.io_dict(), eval=got.eval_dict())


def _write_config(tmp_path, stages) -> Path:
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"name": "t", "pipeline": stages}))
    return p


@pytest.mark.parametrize("stage,match", [
    ({"op": "bilateral_blur", "kernel_size": 4}, "kernel_size=4"),
    ({"op": "clahe", "clip_limit": -1.0}, "clip_limit"),
    ({"op": "unsharp_mask", "sigma": 1.0}, "does not accept param 'sigma'"),
    ({"op": "homomorphic", "order": -2.0}, "order=-2.0"),
    ({"op": "learned_denoise", "checkpoint": ""},
     "param checkpoint='' is invalid"),
])
def test_bad_config_raises_at_load(tmp_path, stage, match):
    with pytest.raises(ValueError, match=match):
        mies_tpu_torch.load_config(_write_config(tmp_path, [stage]))


@pytest.mark.parametrize("convention,clip", [
    ("opencv", 2.0), ("fraction", 0.01), ("skimage", 0.01), ("kornia", 40.0)])
def test_every_clahe_convention_runs_through_compile_pipeline(rng, convention,
                                                              clip):
    stages = [("clahe", {"clip_limit": clip, "grid_size": (4, 4),
                         "convention": convention})]
    x = rng.random((2, 64, 96)).astype(np.float32)
    ref = np.asarray(mies_tpu.compile_pipeline(
        mies_tpu.PipelineConfig.make(stages), batched=True, donate=False)(
            jnp.asarray(x)))
    out = mies_tpu_torch.compile_pipeline(
        mies_tpu_torch.PipelineConfig.make(stages), batched=True,
        device="cpu")(torch.from_numpy(x)).numpy()
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_clahe_argument_rules_raise_at_build():
    cfg = mies_tpu_torch.PipelineConfig.make(
        [("clahe", {"convention": "opencv", "nbins": 128})])
    with pytest.raises(NotImplementedError, match="only the skimage"):
        mies_tpu_torch.compile_pipeline(cfg, batched=True, device="cpu")


def test_chain_on_cpu_launches_no_kernel(rng):
    _build.reset_launches()
    x = torch.from_numpy(rng.random((2, 64, 64)).astype(np.float32))
    mies_tpu_torch.compile_pipeline(flagship_config(), batched=True,
                                    device="cpu")(x)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)


def test_timing_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        time_pipeline(flagship_config(), (64, 64), 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        time_latency(latency_config(), (64, 64), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_pipeline(latency_config(), (64, 64), 2, device="cpu")
    if not torch.cuda.is_available():  # the CLI times the card or raises
        with pytest.raises(RuntimeError, match="CUDA device"):
            runner_main([str(REPO / "configs" / "xray_adapthist_skimage.yaml")])


def test_port_imports_neither_jax_nor_mies_tpu(tmp_path):
    """The port, its file I/O (every codec), the native decoders, the CLI,
    the file entry points, the metric suite and its reports, the models,
    the sharded evaluation, the server, the export and the profiling
    utilities load no jax, jaxlib, triton or mies_tpu module;
    a DICOM/.nc-only run (one small DICOM of each compressed syntax
    decoded, a DICOM enhanced, a .nc streamed) loads no PIL either, so
    the card's path cannot need Pillow; nothing loads matplotlib (only a
    report's panel draws it)."""
    code = (
        "import sys, torch\n"
        "import numpy as np\n"
        "import mies_tpu_torch\n"
        "import mies_tpu_torch.io, mies_tpu_torch.native, mies_tpu_torch.cli\n"
        "import mies_tpu_torch.eval, mies_tpu_torch.eval.report\n"
        "import mies_tpu_torch.models, mies_tpu_torch.models.augment\n"
        "import mies_tpu_torch.parallel.sharding\n"
        "import mies_tpu_torch.serve, mies_tpu_torch.pipeline.export\n"
        "import mies_tpu_torch.utils, mies_tpu_torch.utils.profiling\n"
        "import mies_tpu_torch.io.jpegll, mies_tpu_torch.io.jpegdct\n"
        "import mies_tpu_torch.io.jpegls, mies_tpu_torch.io.jpeg2k\n"
        "import mies_tpu_torch.io.htj2k, mies_tpu_torch.io.htj2k_tables\n"
        "import mies_tpu_torch.io.hdf5, mies_tpu_torch.io.netcdf3\n"
        "from mies_tpu_torch.io import dicom as D\n"
        "from mies_tpu_torch.io.volume import save_volume, load_volume\n"
        "from mies_tpu_torch.pipeline.presets import (flagship_config,\n"
        "                                             flagship_volume_config)\n"
        "from mies_tpu_torch.pipeline import runner\n"
        "from mies_tpu_torch.pipeline.runner import (enhance_image,\n"
        "    enhance_batch, enhance_volume, enhance_volume_stream)\n"
        "fn = mies_tpu_torch.compile_pipeline(flagship_config(), batched=True,\n"
        "                                     device='cpu')\n"
        "assert fn(torch.rand(2, 64, 64)).dtype == torch.uint8\n"
        "tmp = sys.argv[1]\n"
        "rng = np.random.default_rng(0)\n"
        "u8 = rng.integers(0, 256, (24, 32), dtype=np.uint8)\n"
        "u16 = rng.integers(0, 4096, (24, 32), dtype=np.uint16)\n"
        "for i, (ts, px) in enumerate([\n"
        "        (D.RLE_LOSSLESS, u16), (D.JPEG_LOSSLESS_SV1, u16),\n"
        "        (D.JPEG_LOSSLESS_P14, u16), (D.JPEG_BASELINE, u8),\n"
        "        (D.JPEG_EXTENDED, u16), (D.JPEG_LS_LOSSLESS, u16),\n"
        "        (D.JPEG_LS_NEAR, u8), (D.JPEG_2000_LOSSLESS, u16),\n"
        "        (D.HTJ2K_LOSSLESS, u16), (D.HTJ2K_LOSSLESS_RPCL, u16),\n"
        "        (D.DEFLATED_EXPLICIT_VR_LE, u16)]):\n"
        "    path = f'{tmp}/s{i}.dcm'\n"
        "    D.write_dicom(path, px, transfer_syntax=ts)\n"
        "    got = D.read_dicom(path).pixels\n"
        "    assert got.shape == px.shape, ts\n"
        "ct = rng.integers(-1000, 2000, (12, 32, 24), dtype=np.int16)\n"
        "D.write_dicom(f'{tmp}/ct.dcm', ct[0])\n"
        "cfg = flagship_volume_config()\n"
        "assert enhance_image(f'{tmp}/ct.dcm', cfg, device='cpu').dtype == np.uint8\n"
        "save_volume(f'{tmp}/in.nc', ct)\n"
        "enhance_volume_stream(f'{tmp}/in.nc', cfg, f'{tmp}/out.nc', slab_size=5,\n"
        "                      device='cpu')\n"
        "assert load_volume(f'{tmp}/out.nc')[0].shape == ct.shape\n"
        "from mies_tpu_torch.eval import evaluate\n"
        "assert evaluate(ct[0], ct[0] + 1, device='cpu')['ssim'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'triton', 'mies_tpu', 'PIL',\n"
        "              'matplotlib', 'flax', 'optax', 'orbax'))\n"
        "print(bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
