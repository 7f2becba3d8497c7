"""The port's AOT export (mies_tpu_torch/pipeline/export.py) on the CPU.

Every case of the reference's TestExport (tests/test_pipeline.py) against
the port; the header against the reference's; all 14 shipped configs
exported ([2, 64, 96], ct_volume_3d at [16, 64, 96]) and each artifact
bit-equal to its chain; the module caches after an export (the eager chain
and a second export still work); the flagship graph's ``mies`` ops; the
eager chain never through ``torch.ops.mies``; the refusals.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mies_tpu_torch import cli
from mies_tpu_torch.pipeline.compiler import (
    compile_pipeline,
    compile_volume_pipeline,
)
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
from mies_tpu_torch.pipeline.export import (
    export_pipeline,
    load_exported,
    read_export_header,
)
from mies_tpu_torch.pipeline.presets import flagship_config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))


def _rand(shape, dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int16":
        return rng.integers(-1000, 1500, shape, dtype=np.int16)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "uint16":
        return rng.integers(0, 65536, shape, dtype=np.uint16)
    return rng.random(shape, dtype=np.float32)


def _ops_of(module) -> set[str]:
    return {str(n.target) for n in module.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("mies.")}


# --- the reference's TestExport cases ------------------------------------------


def test_export_roundtrip_bit_equal(tmp_path):
    cfg = PipelineConfig.make(
        [("clahe", {"clip_limit": 2.0, "grid_size": (4, 4),
                    "convention": "opencv"}),
         ("unsharp_mask", {"radius": 1.0, "amount": 0.5})], name="exp")
    p = export_pipeline(cfg, tmp_path / "c.mies", shape=(64, 64),
                        batch_size=2, device="cpu")
    fn, hdr = load_exported(p, device="cpu")
    assert hdr["input_shape"] == [2, 64, 64] and hdr["config"]["name"] == "exp"
    x = torch.from_numpy(_rand((2, 64, 64), "float32"))
    ref = compile_pipeline(cfg, batched=True, device="cpu")(x)
    assert torch.equal(fn(x), ref)


def test_export_diffusion_kernel_chain_roundtrip(tmp_path):
    cfg = PipelineConfig.make(
        [("anisotropic_diffusion", {"niter": 4, "kappa": 0.05, "gamma": 0.2}),
         ("musica", {"levels": 3, "p": 0.6, "gain": 1.4})], name="musica-exp")
    p = export_pipeline(cfg, tmp_path / "m.mies", shape=(64, 128),
                        batch_size=2, device="cpu")
    fn, _ = load_exported(p, device="cpu")
    x = torch.from_numpy(_rand((2, 64, 128), "float32", seed=1))
    assert "mies.anisotropic_diffusion.default" in _ops_of(fn)
    assert torch.equal(fn(x), compile_pipeline(cfg, batched=True,
                                               device="cpu")(x))


def test_export_single_slice_and_header(tmp_path):
    cfg = PipelineConfig.make([("adjust_gamma", {"gamma": 0.8})], name="g")
    p = export_pipeline(cfg, tmp_path / "g.mies", shape=(32, 32), device="cpu")
    hdr = read_export_header(p)
    assert hdr["input_shape"] == [32, 32] and hdr["platforms"] == ["cpu"]
    fn, _ = load_exported(p, device="cpu")
    x = torch.from_numpy(_rand((32, 32), "float32", seed=2))
    out = fn(x)
    assert out.dtype == torch.uint8
    assert torch.equal(out, compile_pipeline(cfg, device="cpu")(x))


def test_export_bad_magic(tmp_path):
    bad = tmp_path / "x.mies"
    bad.write_bytes(b"NOTMIES!" + b"\x00" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        load_exported(bad, device="cpu")


def test_cli_export(tmp_path, capsys):
    cfgp = tmp_path / "c.yaml"
    cfgp.write_text("name: e\npipeline:\n  - {op: adjust_gamma, gamma: 0.9}\n")
    out = tmp_path / "e.mies"
    assert cli.main(["export", "-c", str(cfgp), "-o", str(out), "--size",
                     "32", "--batch", "2"], device="cpu") == 0
    line = json.loads(capsys.readouterr().out)
    assert out.exists() and line["input_shape"] == [2, 32, 32]
    assert line["platforms"] == ["cpu"] and line["bytes"] == out.stat().st_size
    with pytest.raises(SystemExit, match="--batch does not apply"):
        cli.main(["export", "-c", str(cfgp), "-o", str(out), "--volume", "4",
                  "8", "8", "--batch", "2"], device="cpu")


def test_export_volume(tmp_path):
    cfg = PipelineConfig.make(
        [("resample3d", {"depth": 8, "height": 32, "width": 32}),
         ("gaussian_blur3d", {"sigma": 1.0})], name="vexp")
    p = export_pipeline(cfg, tmp_path / "v.mies", shape=(16, 32, 32),
                        volume=True, quantize=False, device="cpu")
    fn, hdr = load_exported(p, device="cpu")
    assert hdr["volume"] is True
    vol = torch.from_numpy(_rand((16, 32, 32), "float32", seed=3))
    assert torch.equal(fn(vol), compile_volume_pipeline(
        cfg, quantize=False, device="cpu")(vol))


def test_export_volume_rejects_batch(tmp_path):
    cfg = PipelineConfig.make([("gaussian_blur3d", {"sigma": 1.0})], name="v")
    with pytest.raises(ValueError, match="batch"):
        export_pipeline(cfg, tmp_path / "x.mies", shape=(8, 16, 16),
                        volume=True, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="input_dtype"):
        export_pipeline(cfg, tmp_path / "x.mies", shape=(8, 16, 16),
                        volume=True, input_dtype="int8", device="cpu")


# --- the port's own cases -----------------------------------------------------


@pytest.mark.parametrize("batch", [None, 2])
def test_header_equals_the_reference_but_platforms(tmp_path, batch):
    """The same container and keys: the port's header is the reference's
    read_export_header of the same export, but 'platforms'."""
    from mies_tpu.pipeline.config import PipelineConfig as JaxConfig
    from mies_tpu.pipeline.export import export_pipeline as jax_export
    from mies_tpu.pipeline.export import read_export_header as jax_header

    stages = [("adjust_gamma", {"gamma": 0.8}),
              ("unsharp_mask", {"radius": 1.0})]
    ours = export_pipeline(PipelineConfig.make(stages, name="h"),
                           tmp_path / "t.mies", shape=(32, 48),
                           batch_size=batch, input_dtype="uint8", device="cpu")
    ref = jax_export(JaxConfig.make(stages, name="h"), tmp_path / "j.mies",
                     shape=(32, 48), batch_size=batch, input_dtype="uint8")
    got, want = read_export_header(ours), jax_header(ref)
    assert got.pop("platforms") == ["cpu"]
    want.pop("platforms")
    assert got == want
    # the reference's reader parses the port's container, and the other way
    assert jax_header(ours)["input_shape"] == got["input_shape"]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_shipped_config_exports_bit_equal(tmp_path, name):
    cfg = load_config(REPO / "configs" / name)
    dtype = cfg.io_dict().get("dtype", "float32")
    volume = name == "ct_volume_3d.yaml"
    shape = (16, 64, 96) if volume else (2, 64, 96)
    x = torch.from_numpy(_rand(shape, dtype, seed=4))
    if volume:
        p = export_pipeline(cfg, tmp_path / "a.mies", shape=shape, volume=True,
                            input_dtype=dtype, device="cpu")
        want = compile_volume_pipeline(cfg, device="cpu")(x)
    else:
        p = export_pipeline(cfg, tmp_path / "a.mies", shape=shape[1:],
                            batch_size=2, input_dtype=dtype, device="cpu")
        want = compile_pipeline(cfg, batched=True, device="cpu")(x)
    fn, hdr = load_exported(p, device="cpu")
    assert hdr["input_dtype"] == dtype
    assert torch.equal(fn(x), want)


def test_export_leaves_the_caches_real(tmp_path):
    """A cold export (the chain's caches empty) followed by the eager chain
    and a second export at another shape in the same process: every
    artifact equals the chain."""
    from mies_tpu_torch.pipeline.export import _module_caches

    cfg = load_config(REPO / "configs" / "xray_adapthist_skimage.yaml")
    for cache in _module_caches():
        cache.cache_clear()
    for i, hw in enumerate([(48, 80), (48, 80), (40, 72)]):
        x = torch.from_numpy(_rand((2, *hw), "float32", seed=5 + i))
        p = export_pipeline(cfg, tmp_path / f"{i}.mies", shape=hw,
                            batch_size=2, device="cpu")
        want = compile_pipeline(cfg, batched=True, device="cpu")(x)
        fn, _ = load_exported(p, device="cpu")
        assert torch.equal(fn(x), want)
        assert torch.equal(compile_pipeline(cfg, batched=True,
                                            device="cpu")(x), want)


@pytest.mark.parametrize("batch", [1, 32])
def test_flagship_graph_holds_the_four_kernels(tmp_path, batch):
    """K1 to the LUTs, K2, K3 and K4 as mies ops, at b1 and b32 (uint8)."""
    p = export_pipeline(flagship_config(), tmp_path / "f.mies", shape=(64, 64),
                        batch_size=None if batch == 1 else batch,
                        input_dtype="uint8", device="cpu")
    fn, _ = load_exported(p, device="cpu")
    assert _ops_of(fn) == {"mies.tile_luts.default",
                           "mies.clahe_apply_lut.default",
                           "mies.bilateral.default",
                           "mies.unsharp_quant.default"}
    shape = (64, 64) if batch == 1 else (batch, 64, 64)
    x = torch.from_numpy(_rand(shape, "uint8", seed=6))
    assert torch.equal(fn(x), compile_pipeline(
        flagship_config(), batched=batch > 1, device="cpu")(x))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["xray_clahe.yaml", "ct_volume_3d.yaml",
                                  "xray_adapthist_skimage.yaml"])
def test_the_eager_chain_never_dispatches_a_mies_op(name):
    cfg = load_config(REPO / "configs" / name)
    dtype = cfg.io_dict().get("dtype", "float32")
    if name == "ct_volume_3d.yaml":
        fn, x = compile_volume_pipeline(cfg, device="cpu"), _rand(
            (16, 32, 48), dtype)
    else:
        fn, x = compile_pipeline(cfg, batched=True, device="cpu"), _rand(
            (2, 32, 48), dtype)
    with _Ops() as seen:
        fn(torch.from_numpy(x))
    assert seen.names and not [n for n in seen.names if n.startswith("mies.")]


def test_an_untraceable_stage_is_refused_by_name(tmp_path):
    cfg = PipelineConfig.make([("adjust_gamma", {"gamma": 0.8}),
                               ("canny", {})], name="edges")
    with pytest.raises(ValueError, match=r"stage 1 \('canny'\) cannot be "
                                         r"traced"):
        export_pipeline(cfg, tmp_path / "c.mies", shape=(32, 32),
                        batch_size=2, device="cpu")


def test_another_platform_is_refused(tmp_path):
    """An artifact whose header names the card, loaded on the CPU."""
    cfg = PipelineConfig.make([("adjust_gamma", {"gamma": 0.8})], name="g")
    p = export_pipeline(cfg, tmp_path / "g.mies", shape=(16, 16), device="cpu")
    raw = p.read_bytes()
    n = struct.unpack("<I", raw[8:12])[0]
    hdr = json.loads(raw[12:12 + n])
    hdr["platforms"] = ["cuda"]
    hj = json.dumps(hdr).encode()
    p.write_bytes(raw[:8] + struct.pack("<I", len(hj)) + hj + raw[12 + n:])
    with pytest.raises(ValueError, match=r"exported for platform\(s\) "
                                         r"\['cuda'\].*re-export on this"):
        load_exported(p, device="cpu")


def test_a_reference_artifact_is_refused(tmp_path):
    """A .mies the JAX package wrote (its blob a jax.export program)."""
    from mies_tpu.pipeline.config import PipelineConfig as JaxConfig
    from mies_tpu.pipeline.export import export_pipeline as jax_export

    p = jax_export(JaxConfig.make([("adjust_gamma", {"gamma": 0.8})],
                                  name="j"), tmp_path / "j.mies",
                   shape=(16, 16))
    with pytest.raises(ValueError, match="not a torch.export archive.*"
                                         "re-export with mies_tpu_torch"):
        load_exported(p, device="cpu")


def test_export_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        export_pipeline(flagship_config(), tmp_path / "f.mies")
