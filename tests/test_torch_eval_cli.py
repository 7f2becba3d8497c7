"""The port's reports (``mies_tpu_torch.eval.report``) and the command
line's eval side against the JAX package on the CPU.

* ``write_run_report``, ``save_comparison_report`` and ``reference_u8``
  against the reference's: the same record (but the timestamp), the same
  panels pixel for pixel, the same uint8 baseline.
* The CLI's ``evaluate``, ``enhance --report/--run-report`` and
  ``enhance-volume --metrics`` against ``mies_tpu.cli`` on the same files
  (metrics within tests/test_torch_metrics.py's bounds, plus the two
  chains' own 1-level gaps where a chain runs first: stated per test), in
  process and as ``python -m mies_tpu_torch``; and their refusals.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mies_tpu.cli as jcli
import mies_tpu.utils.profiling as jprofiling
from mies_tpu.eval import report as JR
from mies_tpu_torch import cli
from mies_tpu_torch.eval import metrics as T
from mies_tpu_torch.eval import report as TR
from mies_tpu_torch.io.image import save_image
from mies_tpu_torch.io.volume import save_volume
from mies_tpu_torch.pipeline.config import load_config
from tests.test_torch_metrics import _close

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


# --- reports ------------------------------------------------------------------


def _strip_time(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "timestamp"}


def test_write_run_report_equals_the_references(tmp_path):
    """inf/nan become strings in both; the same config hash and record."""
    import mies_tpu

    path = REPO / "configs" / "xray_clahe.yaml"
    metrics = {"psnr": float("inf"), "ssim": 0.5, "vifp": float("nan")}
    timings = {"wall_ms": 3.25}
    got = TR.write_run_report(tmp_path / "t.json", load_config(path),
                              metrics=metrics, timings=timings,
                              extra={"input": "a.png"})
    want = JR.write_run_report(tmp_path / "j.json", mies_tpu.load_config(path),
                               metrics=metrics, timings=timings,
                               extra={"input": "a.png"})
    assert _strip_time(got) == _strip_time(want)
    assert got["metrics"]["psnr"] == "inf" and got["metrics"]["vifp"] == "nan"
    assert _strip_time(json.loads((tmp_path / "t.json").read_text())) == \
        _strip_time(got)


def test_save_comparison_report_draws_the_references_panels(tmp_path):
    from PIL import Image

    """Raw HU on the left (the percentile window), uint8 on the right."""
    rng = np.random.default_rng(2)
    enh = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    hu = rng.integers(-1000, 2000, (48, 64)).astype(np.int16)
    for i, (a, b) in enumerate(((hu, enh),)):
        TR.save_comparison_report(a, b, tmp_path / f"t{i}.png", title="x",
                                  metrics={"psnr": 20.0})
        JR.save_comparison_report(a, b, tmp_path / f"j{i}.png", title="x",
                                  metrics={"psnr": 20.0})
        t = np.asarray(Image.open(tmp_path / f"t{i}.png"))
        j = np.asarray(Image.open(tmp_path / f"j{i}.png"))
        assert t.shape == j.shape and t.shape[0] > 100
        np.testing.assert_array_equal(t, j)


def test_reference_u8_equals_the_references(tmp_path):
    """The uint8 baseline of a PNG, of an int16 DICOM through the chain's
    window and through the percentile window."""
    import mies_tpu
    from mies_tpu_torch.io.dicom import write_dicom

    rng = np.random.default_rng(4)
    save_image(tmp_path / "a.png", rng.integers(0, 256, (40, 56), np.uint8))
    write_dicom(tmp_path / "ct.dcm",
                rng.integers(-1000, 1500, (40, 56)).astype(np.int16))
    cfgs = {"win": [("window_hu", {"center": 40.0, "width": 400.0})],
            "none": [("median_blur", {"kernel_size": 3})]}
    for src in ("a.png", "ct.dcm"):
        for stages in cfgs.values():
            got = TR.reference_u8(tmp_path / src,
                                  cli_config(stages))
            want = JR.reference_u8(tmp_path / src,
                                   mies_tpu.PipelineConfig.make(stages))
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


def cli_config(stages):
    from mies_tpu_torch.pipeline.config import PipelineConfig

    return PipelineConfig.make(stages)


# --- the command line ---------------------------------------------------------


@pytest.fixture()
def jax_main(monkeypatch):
    """mies_tpu.cli.main without its persistent compilation cache (which
    writes outside the checkout)."""
    monkeypatch.setattr(jprofiling, "enable_compilation_cache", lambda: None)
    return jcli.main


def _xray_u8(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    img = 0.5 + 0.3 * np.sin(x / 9.0) * np.cos(y / 13.0)
    img = img + 0.05 * rng.standard_normal(shape)
    return np.clip(np.rint(img * 255), 0, 255).astype(np.uint8)


def _json_out(capsys) -> dict:
    return json.loads(capsys.readouterr().out)


def _module_cli(args, cwd) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    code = ("import sys; from mies_tpu_torch import cli; "
            "sys.exit(cli.main(sys.argv[1:], device='cpu'))")
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_cli_evaluate_equals_the_references(tmp_path, capsys, jax_main):
    """Metrics of two uint8 PNGs, in process and as a subprocess, within
    the metric bounds; the default names psnr, ssim, uqi."""
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    save_image(a, _xray_u8((64, 96), 0))
    save_image(b, _xray_u8((64, 96), 1))
    names = ("psnr", "vifp", "sam", "rmse")
    args = ["evaluate", str(a), str(b), "-m", *names]
    assert cli.main(args, device="cpu") == 0
    got = _json_out(capsys)
    assert jax_main(args) == 0
    want = _json_out(capsys)
    assert list(got) == list(want) == sorted(names)
    for k in names:
        _close(got[k], want[k], k)
    assert cli.main(["evaluate", str(a), str(b)], device="cpu") == 0
    assert list(_json_out(capsys)) == ["psnr", "ssim", "uqi"]  # sorted
    proc = _module_cli(args, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == got


SHARP = """name: bilateral-sharpen
pipeline:
  - {op: bilateral_blur, kernel_size: 5, sigma_color: 0.1, sigma_space: 1.5}
  - {op: unsharp_mask, radius: 1.5, amount: 1.0}
"""


def test_cli_enhance_reports_equal_the_references(tmp_path, capsys,
                                                  jax_main):
    """--report and --run-report on one PNG (the PNG drawn by the port;
    the panels are held to the reference's above): the same record as the
    reference's but the timestamp and the wall time, psnr and ssim within
    1e-4 relative (the two chains' outputs differ by at most 1 level on
    < 1e-3 of pixels: the bilateral's 2e-6), the PNG drawn; and the same
    from `python -m mies_tpu_torch`."""
    src = tmp_path / "x.png"
    save_image(src, _xray_u8((96, 128), 5))
    cfg = tmp_path / "c.yaml"
    cfg.write_text(SHARP)

    def run(main, tag, **kw):
        args = ["enhance", str(src), "-c", str(cfg), "-o",
                str(tmp_path / f"{tag}.png"), "--run-report",
                str(tmp_path / f"{tag}.json")]
        if tag == "t":
            args += ["--report", str(tmp_path / f"{tag}_r.png")]
        assert main(args, **kw) == 0
        line = _json_out(capsys)
        rec = json.loads((tmp_path / f"{tag}.json").read_text())
        return line, rec

    line, got = run(cli.main, "t", device="cpu")
    _, want = run(jax_main, "j")
    assert line["shape"] == [96, 128]
    assert (tmp_path / "t_r.png").stat().st_size > 1000
    assert set(got) == set(want)
    for k in ("config_name", "config_hash", "config"):
        assert got[k] == want[k]
    assert list(got["metrics"]) == ["psnr", "ssim"]
    for k in ("psnr", "ssim"):
        assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-4)
    assert got["input"] == str(src) and got["output"] == str(tmp_path / "t.png")
    proc = _module_cli(["enhance", str(src), "-c", str(cfg), "-o",
                        str(tmp_path / "m.png"), "--run-report",
                        str(tmp_path / "m.json")], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert json.loads((tmp_path / "m.json").read_text())["metrics"] == \
        got["metrics"]


def test_cli_enhance_reports_refusals(tmp_path, capsys):
    """The reference's refusals: a batch, a shape-changing chain."""
    srcs = []
    for i in range(2):
        srcs.append(tmp_path / f"x{i}.png")
        save_image(srcs[-1], _xray_u8((40, 48), i))
    cfg = tmp_path / "c.yaml"
    cfg.write_text(SHARP)
    assert cli.main(["enhance", *map(str, srcs), "-c", str(cfg), "-o",
                     str(tmp_path / "out"), "--run-report", "r.json"],
                    device="cpu") == 2
    assert "single-image flags" in capsys.readouterr().err
    crop = tmp_path / "crop.yaml"
    crop.write_text("name: crop\npipeline:\n"
                    "  - {op: center_crop, height: 32, width: 32}\n")
    assert cli.main(["enhance", str(srcs[0]), "-c", str(crop), "-o",
                     str(tmp_path / "c.png"), "--run-report",
                     str(tmp_path / "r.json")], device="cpu") == 2
    assert "shape-preserving chain" in capsys.readouterr().err


def test_cli_enhance_volume_metrics_equal_the_references(tmp_path, capsys,
                                                         jax_main):
    """--metrics psnr ssim on a float [6, 48, 64] volume in slice mode:
    per-slice values and means within 1e-4 relative of the reference's
    (the chains' 1-level gaps), the same JSON file layout; an int16 volume
    through window_hu; and the refusals (no window_hu, --stream,
    --isotropic)."""
    rng = np.random.default_rng(8)
    vol = np.clip(0.5 + 0.2 * rng.standard_normal((6, 48, 64)), 0, 1
                  ).astype(np.float32)
    save_volume(tmp_path / "v.npy", vol)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(SHARP)

    def run(main, tag, **kw):
        out = tmp_path / f"{tag}.npy"
        assert main(["enhance-volume", str(tmp_path / "v.npy"), "-c",
                     str(cfg), "-o", str(out), "--metrics", "psnr", "ssim",
                     "-q"], **kw) == 0
        line = _json_out(capsys)
        return line, json.loads(Path(str(out) + ".metrics.json").read_text())

    line, got = run(cli.main, "t", device="cpu")
    _, want = run(jax_main, "j")
    assert line["metrics_file"] == str(tmp_path / "t.npy") + ".metrics.json"
    assert line["metrics_mean"] == got["mean"]
    for k in ("psnr", "ssim"):
        assert got["mean"][k] == pytest.approx(want["mean"][k], rel=1e-4)
        np.testing.assert_allclose(got["per_slice"][k], want["per_slice"][k],
                                   rtol=1e-4)
    proc = _module_cli(["enhance-volume", str(tmp_path / "v.npy"), "-c",
                        str(cfg), "-o", str(tmp_path / "m.npy"), "--metrics",
                        "psnr", "ssim", "-q"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["metrics_mean"] == got["mean"]

    hu = rng.integers(-300, 400, (4, 32, 40)).astype(np.int16)
    save_volume(tmp_path / "hu.npy", hu)
    win = tmp_path / "w.yaml"
    win.write_text("name: w\npipeline:\n"
                   "  - {op: window_hu, center: 40.0, width: 400.0}\n"
                   "  - {op: gaussian_blur, sigma: 1.0}\n")
    assert cli.main(["enhance-volume", str(tmp_path / "hu.npy"), "-c",
                     str(win), "-o", str(tmp_path / "h.npy"), "--metrics",
                     "psnr", "-q"], device="cpu") == 0
    m = _json_out(capsys)["metrics_mean"]
    from mies_tpu_torch.ops.intensity import window_hu
    from mies_tpu_torch.pipeline.compiler import _quantize_u8

    gt = _quantize_u8(window_hu(torch.from_numpy(hu), 40.0, 400.0))
    want = T.evaluate_volume(gt, np.load(tmp_path / "h.npy"), ("psnr",),
                             device="cpu")
    assert m == want["mean"]
    norm = tmp_path / "n.yaml"
    norm.write_text("name: n\npipeline:\n  - {op: normalize}\n")
    with pytest.raises(SystemExit, match="needs a window_hu"):
        cli.main(["enhance-volume", str(tmp_path / "hu.npy"), "-c", str(norm),
                  "-o", str(tmp_path / "x.npy"), "--metrics", "psnr", "-q"],
                 device="cpu")
    with pytest.raises(SystemExit, match="incompatible with --metrics"):
        cli.main(["enhance-volume", str(tmp_path / "v.npy"), "-c", str(cfg),
                  "-o", str(tmp_path / "s.npy"), "--stream", "--metrics",
                  "psnr"], device="cpu")
