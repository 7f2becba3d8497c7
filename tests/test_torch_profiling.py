"""The port's profiling utilities, doctor, warmup and --stage-costs on the
CPU (the cases of tests/test_aux.py against mies_tpu_torch): the six names
of ``mies_tpu.utils``, stage costs of every stage kind (2-D kernels, plain
ops, a stage builder, volume ops) as numbers, ``strict_numerics`` naming
the op that made a NaN, the Chrome trace, the CLI's doctor (exit 1 here,
the gloo world of 2 healthy), warmup and enhance --run-report
--stage-costs. The timing on the card is marked ``cuda``.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
from pytest import skip

from mies_tpu_torch import cli, utils
from mies_tpu_torch.io.image import save_image
from mies_tpu_torch.pipeline.config import PipelineConfig
from mies_tpu_torch.pipeline.presets import flagship_config


def _finite_costs(c: dict) -> bool:
    return ("error" not in c and math.isfinite(c["flops"])
            and math.isfinite(c["bytes"]) and c["flops"] > 0
            and c["bytes"] > 0)


def test_the_reference_names():
    import mies_tpu.utils as ref

    assert sorted(utils.__all__) == sorted(ref.__all__)
    for name in utils.__all__:
        assert callable(getattr(utils, name))


def test_time_fn_refuses_the_cpu():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        utils.time_fn(lambda x: x + 1, torch.ones(4))


@pytest.mark.cuda
def test_time_fn_measures_the_card():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (CUDA events)")
    x = torch.ones((256, 256), device="cuda")
    r = utils.time_fn(lambda a: torch.sin(a).sum(), x, iters=8, repeats=2)
    assert r["ms_per_call"] > 0 and math.isfinite(r["calls_per_sec"])


def test_device_sync_and_compilation_cache():
    utils.device_sync(torch.ones(3))
    utils.device_sync((torch.ones(3), torch.zeros(2)))
    from mies_tpu_torch.kernels import _build

    try:
        _build.find_nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            utils.enable_compilation_cache()
        return
    assert utils.enable_compilation_cache() == str(_build.BUILD_DIR)


def test_stage_costs_reports_per_stage():
    cfg = PipelineConfig.make([("adjust_gamma", {"gamma": 0.8}),
                               ("gaussian_blur", {"sigma": 1.0})])
    costs = utils.stage_costs(cfg, shape=(64, 64), batch_size=2, device="cpu")
    assert [c["op"] for c in costs] == ["adjust_gamma", "gaussian_blur"]
    assert all(_finite_costs(c) for c in costs)
    gamma = costs[0]
    # one pass over 2 x 64 x 64 floats, in and out at least
    assert gamma["bytes"] >= 2 * 4 * 2 * 64 * 64
    assert gamma["intensity"] == gamma["flops"] / gamma["bytes"]


def test_stage_costs_count_the_kernels_as_their_ops():
    """The flagship's kernels are counted by PERF.md's operations per pixel:
    K3's 136 at k 5, K1 to the LUTs 5 per pixel + 20 per LUT entry, K2 29."""
    from mies_tpu_torch.kernels import _build

    b, h, w = 2, 64, 64
    costs = utils.stage_costs(flagship_config(), shape=(h, w), batch_size=b,
                              device="cpu")
    assert [c["op"] for c in costs] == ["clahe", "bilateral_blur",
                                        "unsharp_mask"]
    assert all(_finite_costs(c) for c in costs)
    npx = b * h * w
    assert costs[1]["flops"] == 136 * npx
    clahe = 5 * npx + 20 * b * 64 * 256 + 29 * npx
    assert clahe <= costs[0]["flops"] < clahe + 4 * npx
    assert _build.OPERATIONS["bilateral"](torch.empty(1, 8, 8), 5) == 136 * 64


def test_stage_costs_covers_builders_and_3d(tmp_path):
    """learned_denoise (a stage builder) and clahe3d (a volume op, K1 and
    K8 routed as mies ops) report numbers, not errors."""
    assert cli.main(["train-denoiser", "-o", str(tmp_path / "ck"), "--steps",
                     "1", "--batch", "2", "--patch", "16", "--features", "4",
                     "--depth", "1"], device="cpu") == 0
    cfg = PipelineConfig.make([
        ("learned_denoise", {"checkpoint": str(tmp_path / "ck")}),
        ("clahe3d", {"clip_limit": 2.0, "grid_size": (4, 4, 4),
                     "convention": "opencv"}),
        ("guided_blur3d", {"kernel_size": 3, "eps": 0.01}),
        ("clahe", {"clip_limit": 2.0, "grid_size": (4, 4),
                   "convention": "opencv"}),
    ])
    costs = utils.stage_costs(cfg, shape=(64, 64), batch_size=2,
                              volume_depth=16, device="cpu")
    assert [c["op"] for c in costs] == [s.op for s in cfg.stages]
    for c in costs:
        assert _finite_costs(c), c
    # the learned stage's convolutions by the flop counter: 2 x 64 x 64
    # pixels through at least one 3 x 3 convolution (multiply and add)
    assert costs[0]["flops"] >= 2 * 64 * 64 * 9 * 2
    # K8 u8norm: 51 operations per voxel of [16, 64, 64]
    assert costs[1]["flops"] >= 51 * 16 * 64 * 64


def test_stage_costs_records_a_failing_stage():
    cfg = PipelineConfig.make([("histogram_match", {"reference": "nope.png"})])
    (c,) = utils.stage_costs(cfg, shape=(16, 16), batch_size=1, device="cpu")
    assert c["op"] == "histogram_match" and "not found" in c["error"]


def test_strict_numerics_names_the_op():
    x = torch.zeros(4)
    with pytest.raises(FloatingPointError, match=r"aten\.div"):
        with utils.strict_numerics():
            x / x
    with pytest.raises(FloatingPointError, match=r"aten\.log"):
        with utils.strict_numerics():
            torch.log(x)
    with utils.strict_numerics():  # finite values pass; no mode left after
        y = torch.exp(torch.ones(3))
        empty = torch.empty(1_000_000)  # uninitialized memory is not checked
    assert y.shape == (3,) and empty.numel() == 1_000_000
    assert bool(torch.isnan(torch.zeros(1) / torch.zeros(1)))


def test_trace_writes_a_chrome_trace(tmp_path):
    with utils.trace(str(tmp_path / "tr")) as d:
        torch.ones(64).cumsum(0)
    rec = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr") and rec["traceEvents"]


def test_cli_warmup_runs_each_batch(tmp_path, capsys):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"name": "w", "pipeline": [
        {"op": "adjust_gamma", "gamma": 0.9},
        {"op": "gaussian_blur", "sigma": 1.0}]}))
    assert cli.main(["warmup", "-c", str(cfg), "--size", "64", "--batch", "1",
                     "4"], device="cpu") == 0
    line = json.loads(capsys.readouterr().out)
    assert line["config"] == "w" and line["backend"] == "cpu"
    assert [c["batch"] for c in line["compiled"]] == [1, 4]
    assert all(c["seconds"] >= 0 and c["shape"] == [64, 64]
               for c in line["compiled"])
    assert cli.main(["warmup", "-c", str(cfg), "--size", "32", "--batch", "2",
                     "--dtype", "int16"], device="cpu") == 0


def test_cli_run_report_stage_costs(tmp_path, xray, capsys):
    from mies_tpu_torch.io.image import from_float

    src = tmp_path / "x.png"
    save_image(src, from_float(np.asarray(xray)))
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"name": "t", "pipeline": [
        {"op": "gaussian_blur", "sigma": 1.0}]}))
    rep = tmp_path / "run.json"
    assert cli.main(["enhance", str(src), "-c", str(cfg), "-o",
                     str(tmp_path / "o.png"), "--run-report", str(rep),
                     "--stage-costs"], device="cpu") == 0
    rec = json.loads(rep.read_text())
    (c,) = rec["stage_costs"]
    assert c["op"] == "gaussian_blur" and _finite_costs(c)
    # without the flag the report carries no stage costs
    assert cli.main(["enhance", str(src), "-c", str(cfg), "-o",
                     str(tmp_path / "o.png"), "--run-report", str(rep)],
                    device="cpu") == 0
    assert "stage_costs" not in json.loads(rep.read_text())


def test_cli_doctor(capsys):
    """One JSON health object; here (no card, no nvcc) status degraded and
    exit 1, with the gloo world of 2 healthy."""
    rc = cli.main(["doctor", "--probe-timeout", "60"], device="cpu")
    rep = json.loads(capsys.readouterr().out)
    assert {"torch", "accelerator", "kernels", "native_dicom", "sharding",
            "status"} <= set(rep)
    assert rep["sharding"]["ok"] is True
    if torch.cuda.is_available():
        assert "name" in rep["accelerator"]
        return
    assert rc == 1 and rep["status"] == "degraded"
    assert "is_available() is False" in rep["accelerator"]["error"]
