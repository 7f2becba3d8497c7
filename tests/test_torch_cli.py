"""The port's command line (``mies_tpu_torch.cli.main(..., device="cpu")``)
end to end against the JAX package's (``mies_tpu.cli.main``) on the same
input files: ``enhance`` (one file, a batch) and ``enhance-volume``
(streamed and in memory) within PERF.md section 2's bound (at most 1
level on fewer than 1e-3 of pixels), on chains without opencv CLAHE
(the JAX package's opencv CLAHE on XLA:CPU is off cv2; ROADMAP.md queue
3). Also the flags and subcommands refused until they were ported
(--stage-costs, --data-parallel, serve, export, doctor, warmup, and the
eval ones), ``ops``, ``--window-from-file``, ``--mode 3d`` and
``python -m mies_tpu_torch``.
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
from PIL import Image

import mies_tpu.cli as jcli
import mies_tpu.utils.profiling as jprofiling
from mies_tpu_torch import cli
from mies_tpu_torch.io.dicom import write_dicom
from mies_tpu_torch.io.image import load_image
from mies_tpu_torch.io.volume import load_volume, save_volume
from mies_tpu_torch.pipeline import runner
from mies_tpu_torch.pipeline.compiler import OP_REGISTRY, compile_volume_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config

REPO = Path(__file__).resolve().parent.parent
SHARPEN = """name: gauss-sharpen
pipeline:
  - {op: gaussian_blur, sigma: 1.0}
  - {op: unsharp_mask, radius: 1.5, amount: 1.0}
"""


@pytest.fixture()
def jax_main(monkeypatch):
    """mies_tpu.cli.main without its persistent compilation cache (which
    writes outside the checkout)."""
    monkeypatch.setattr(jprofiling, "enable_compilation_cache", lambda: None)
    return jcli.main


def _within_bound(a: np.ndarray, b: np.ndarray) -> None:
    """PERF.md section 2: at most 1 level on fewer than 1e-3 of pixels."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.count_nonzero(d) < 1e-3 * d.size, np.count_nonzero(d)


def _xray(shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    base = 0.5 + 0.3 * np.sin(y / 9.0) * np.cos(x / 13.0)
    return np.clip(base + 0.05 * rng.standard_normal(shape), 0, 1)


def _png(path: Path, shape=(96, 128), seed=0, deep=False) -> Path:
    img = _xray(shape, seed)
    a = (img * 65535).astype(np.uint16) if deep else (img * 255).astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(a).save(path)
    return path


@pytest.fixture()
def sharpen(tmp_path) -> Path:
    p = tmp_path / "sharpen.yaml"
    p.write_text(SHARPEN)
    return p


@pytest.mark.parametrize("deep", [False, True], ids=["png8", "png16"])
def test_enhance_one_file_matches_jax_cli(tmp_path, sharpen, jax_main, deep,
                                          capsys):
    src = _png(tmp_path / "in.png", deep=deep)
    assert jax_main(["enhance", str(src), "-c", str(sharpen), "-o",
                     str(tmp_path / "jax.png")]) == 0
    assert cli.main(["enhance", str(src), "-c", str(sharpen), "-o",
                     str(tmp_path / "port.png")], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"output": str(tmp_path / "port.png"), "shape": [96, 128]}
    _within_bound(np.asarray(Image.open(tmp_path / "port.png")),
                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_enhance_batch_matches_jax_cli(tmp_path, sharpen, jax_main, capsys):
    srcs = [str(_png(tmp_path / "in" / f"x{i}.png", seed=i)) for i in range(3)]
    assert jax_main(["enhance", *srcs, "-c", str(sharpen), "-o",
                     str(tmp_path / "jax"), "--batch", "2"]) == 0
    capsys.readouterr()
    assert cli.main(["enhance", *srcs, "-c", str(sharpen), "-o",
                     str(tmp_path / "port"), "--batch", "2"], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["done"] == 3 and out["failed"] == 0
    for s in srcs:
        name = Path(s).name
        _within_bound(np.asarray(Image.open(tmp_path / "port" / name)),
                      np.asarray(Image.open(tmp_path / "jax" / name)))
    # resumed: nothing left to do
    assert cli.main(["enhance", *srcs, "-c", str(sharpen), "-o",
                     str(tmp_path / "port")], device="cpu") == 0
    assert len((tmp_path / "port" / "manifest.jsonl").read_text().splitlines()) == 3


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "in-memory"])
def test_enhance_volume_matches_jax_cli(tmp_path, sharpen, jax_main, stream):
    vol = np.stack([_xray((64, 80), s) for s in range(11)]).astype(np.float32)
    save_volume(tmp_path / "in.nc", vol)
    extra = ["--stream"] if stream else []
    assert jax_main(["enhance-volume", str(tmp_path / "in.nc"), "-c",
                     str(sharpen), "-o", str(tmp_path / "jax.nc"), "--slab",
                     "4", "-q", *extra]) == 0
    assert cli.main(["enhance-volume", str(tmp_path / "in.nc"), "-c",
                     str(sharpen), "-o", str(tmp_path / "port.nc"), "--slab",
                     "4", "-q", *extra], device="cpu") == 0
    got, _ = load_volume(tmp_path / "port.nc")
    ref, _ = load_volume(tmp_path / "jax.nc")
    _within_bound(got, ref)


def test_enhance_volume_3d_equals_the_volume_program(tmp_path):
    cfg_path = REPO / "configs" / "ct_volume_3d.yaml"
    vol = np.random.default_rng(0).integers(-200, 300, (8, 48, 64), dtype=np.int16)
    save_volume(tmp_path / "in.npy", vol)
    assert cli.main(["enhance-volume", str(tmp_path / "in.npy"), "-c",
                     str(cfg_path), "-o", str(tmp_path / "o.npy"), "--mode",
                     "3d"], device="cpu") == 0
    want = compile_volume_pipeline(load_config(cfg_path), device="cpu")(
        torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "o.npy"), want)
    with pytest.raises(SystemExit, match="slice-mode only"):
        cli.main(["enhance-volume", str(tmp_path / "in.npy"), "-c",
                  str(cfg_path), "-o", str(tmp_path / "s.nc"), "--mode", "3d",
                  "--stream"], device="cpu")


PORTED_FLAGS = [
    ("enhance", ["--stage-costs"], "run report"),
    ("enhance", ["--data-parallel"], "batch"),
    ("enhance-volume", ["--data-parallel", "--stream"], "stream"),
]


@pytest.mark.parametrize("cmd,flag,item", PORTED_FLAGS,
                         ids=[f"{c}{f[0]}" for c, f, _ in PORTED_FLAGS])
def test_unported_flags_exit_2_naming_the_roadmap_item(tmp_path, sharpen, cmd,
                                                       flag, item, capsys):
    """Refused (exit 2, naming ROADMAP.md queue 1 item 7) until they were
    ported, the flags run as the reference's: --stage-costs adds each
    stage's costs to the run report; --data-parallel, in a world of one
    (no torchrun variables), writes what the run without it writes, and
    single-image mode refuses it with the reference's message."""
    if item == "run report":
        rep = tmp_path / "r.json"
        assert cli.main([cmd, str(_png(tmp_path / "in.png")), "-c",
                         str(sharpen), "-o", str(tmp_path / "o.png"),
                         "--run-report", str(rep), *flag], device="cpu") == 0
        costs = json.loads(rep.read_text())["stage_costs"]
        assert [c["op"] for c in costs] == ["gaussian_blur", "unsharp_mask"]
        assert all(c["flops"] > 0 and c["bytes"] > 0 for c in costs)
        return
    if item == "batch":
        srcs = [str(_png(tmp_path / "in" / f"x{i}.png", seed=i))
                for i in range(3)]
        for out, extra in (("dp", flag), ("one", [])):
            assert cli.main([cmd, *srcs, "-c", str(sharpen), "-o",
                             str(tmp_path / out), "--batch", "2", *extra],
                            device="cpu") == 0
        for i in range(3):
            np.testing.assert_array_equal(
                load_image(tmp_path / "dp" / f"x{i}.png", dtype="raw"),
                load_image(tmp_path / "one" / f"x{i}.png", dtype="raw"))
        capsys.readouterr()
        assert cli.main([cmd, srcs[0], "-c", str(sharpen), *flag],
                        device="cpu") == 2
        assert "applies to batch mode only" in capsys.readouterr().err
        return
    vol = np.random.default_rng(3).random((6, 24, 32)).astype(np.float32)
    save_volume(tmp_path / "in.nc", vol)
    for out, extra in (("dp.nc", flag), ("one.nc", ["--stream"])):
        assert cli.main([cmd, str(tmp_path / "in.nc"), "-c", str(sharpen),
                         "-o", str(tmp_path / out), "--slab", "4", "-q",
                         *extra], device="cpu") == 0
    np.testing.assert_array_equal(load_volume(tmp_path / "dp.nc")[0],
                                  load_volume(tmp_path / "one.nc")[0])


# the flags queue 1 item 5 ported (eval), refused until then
EVAL_FLAGS = [
    ("enhance", ["--report", "r.png"]),
    ("enhance", ["--run-report", "r.json"]),
    ("enhance-volume", ["--metrics", "psnr"]),
]


@pytest.mark.parametrize("cmd,flag", EVAL_FLAGS,
                         ids=[f"{c}{f[0]}" for c, f in EVAL_FLAGS])
def test_eval_flags_run_and_write_their_file(tmp_path, sharpen, cmd, flag,
                                             capsys):
    """--report, --run-report and --metrics run (tests/test_torch_eval_cli.py
    holds their numbers against the reference's) and write their file."""
    if cmd == "enhance":
        src, out = _png(tmp_path / "x.png"), tmp_path / "o.png"
    else:
        src, out = tmp_path / "v.npy", tmp_path / "o.npy"
        save_volume(src, np.random.default_rng(1).random((3, 24, 32)).astype(
            np.float32))
    made = tmp_path / flag[1]
    argv = [cmd, str(src), "-c", str(sharpen), "-o", str(out), flag[0],
            str(made) if cmd == "enhance" else flag[1]]
    assert cli.main(argv, device="cpu") == 0
    line = json.loads(capsys.readouterr().out)
    if cmd == "enhance-volume":
        made = Path(line["metrics_file"])
        assert set(line["metrics_mean"]) == {"psnr"}
    assert made.exists() and made.stat().st_size > 0


# --- enhance-volume --data-parallel in a gloo world of 2 --------------------

CT3D_CHAIN = """name: z3d
pipeline:
  - {op: window_hu, center: 40.0, width: 400.0}
  - {op: clahe3d, clip_limit: 2.0, grid_size: [8, 4, 4]}
  - {op: unsharp_mask3d, radius: 1.0, amount: 0.5}
"""
SLICE_CHAIN = """name: slices
pipeline:
  - {op: window_hu, center: 40.0, width: 400.0}
  - {op: clahe, clip_limit: 2.0, grid_size: [4, 4]}
  - {op: unsharp_mask, radius: 1.0, amount: 0.5}
"""
# name -> the arguments after the input file
DP_RUNS = {
    "3d": ["-c", "c3d.yaml", "--mode", "3d"],
    "slices": ["-c", "slices.yaml", "--slab", "6"],
    "isotropic": ["-c", "iso.yaml", "--mode", "3d", "--isotropic", "1.25"],
}
DP_REFUSED = {
    "odd_z": ["bad.nc", "-c", "c3d.yaml", "--mode", "3d"],
    "odd_depth": ["series", "-c", "iso.yaml", "--mode", "3d", "--isotropic",
                  "1.0"],
}


def _dp_source(name: str) -> str:
    return "series" if name == "isotropic" else "ct.nc"


def _dp_rank(rank: int, world: int, ports: list, tmp: str) -> None:
    """One rank of a world of ``world``: each run of DP_RUNS and DP_REFUSED
    through ``cli.main(..., device="cpu")`` with --data-parallel, the
    process group joined by the CLI itself from torchrun's env://
    variables (a port of its own per run); exit codes and SystemExit
    messages to <tmp>/dp_<rank>.json."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    result = {}
    runs = [(name, [_dp_source(name), *argv]) for name, argv in DP_RUNS.items()]
    runs += list(DP_REFUSED.items())
    for (name, argv), port in zip(runs, ports):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        args = ["enhance-volume", str(tmp / argv[0]), *argv[1:]]
        args = [str(tmp / a) if a.endswith(".yaml") else a for a in args]
        try:
            result[name] = cli.main([*args, "-o", str(tmp / f"dp_{name}.nc"),
                                     "--data-parallel", "-q"], device="cpu")
        except SystemExit as e:
            result[name] = str(e)
    (tmp / f"dp_{rank}.json").write_text(json.dumps(result))


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    """The CLI's inputs, and one spawn of a gloo world of 2 that runs them
    all with --data-parallel."""
    import socket

    tmp = tmp_path_factory.mktemp("dp")
    save_volume(tmp / "ct.nc", np.random.default_rng(11).integers(
        -500, 1500, (16, 32, 32), dtype=np.int16))
    save_volume(tmp / "bad.nc", np.zeros((9, 32, 32), np.int16))
    (tmp / "c3d.yaml").write_text(CT3D_CHAIN)
    (tmp / "slices.yaml").write_text(SLICE_CHAIN)
    (tmp / "iso.yaml").write_text(ISO_CHAIN)
    _dicom_series(tmp / "series")
    socks = [socket.socket() for _ in range(len(DP_RUNS) + len(DP_REFUSED))]
    for sock in socks:
        sock.bind(("localhost", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, 2, ports, str(tmp)))
             for r in range(2)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(120)
    hung = [proc.pid for proc in procs if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
    assert not hung and all(proc.exitcode == 0 for proc in procs), (
        hung, [proc.exitcode for proc in procs])
    return tmp


@pytest.mark.parametrize("name", list(DP_RUNS))
def test_data_parallel_writes_the_file_of_the_run_without_it(dp_world, name):
    """--data-parallel in --mode 3d (z slabs through volume_shard_apply,
    also with --isotropic: the z-sharded resample3d) and in slice mode
    (enhance_volume(mesh=)) on a gloo world of 2: exit 0 on both ranks, and
    rank 0's output file byte-identical to the one written without it."""
    for r in range(2):
        assert json.loads((dp_world / f"dp_{r}.json").read_text())[name] == 0
    args = [str(dp_world / a) if a.endswith(".yaml") else a
            for a in DP_RUNS[name]]
    assert cli.main(["enhance-volume", str(dp_world / _dp_source(name)),
                     *args, "-o", str(dp_world / f"one_{name}.nc"), "-q"],
                    device="cpu") == 0
    assert (dp_world / f"dp_{name}.nc").read_bytes() == \
        (dp_world / f"one_{name}.nc").read_bytes()


@pytest.mark.parametrize("name,match", [
    ("odd_z", "Z=9 must divide by the 2 devices"),
    ("odd_depth", "target depth 15 is not divisible by the 2 devices"),
])
def test_data_parallel_refuses_a_size_that_does_not_divide(dp_world, name,
                                                           match):
    """The reference's refusals, on every rank: a Z (--mode 3d) and an
    --isotropic depth that do not divide by the ranks."""
    for r in range(2):
        msg = json.loads((dp_world / f"dp_{r}.json").read_text())[name]
        assert match in msg, msg


ISO_CHAIN = """name: iso
pipeline:
  - {op: window_hu, center: 40.0, width: 256.0}
  - {op: median_blur3d, kernel_size: 3}
"""


def _dicom_series(path: Path, z=6, h=24, w=20) -> np.ndarray:
    """An int16 CT series, slices 2.5 mm apart (image positions), pixels
    0.8 x 0.6 mm, files in reverse order; returns the HU volume."""
    rng = np.random.default_rng(3)
    zz, yy, xx = np.mgrid[0:z, 0:h, 0:w]
    hu = (40 + 60 * np.sin(yy / 4.0) * np.cos(xx / 3.0) + 20 * zz
          + rng.normal(0, 10, (z, h, w))).astype(np.int16)
    path.mkdir(parents=True)
    for k in range(z):
        write_dicom(path / f"s{z - k:02d}.dcm", hu[k], instance_number=k + 1,
                    slice_location=2.5 * k, image_position=(0.0, 0.0, 2.5 * k),
                    pixel_spacing=(0.8, 0.6))
    return hu


def test_isotropic_resamples_the_series_as_the_jax_cli(tmp_path, jax_main,
                                                        capsys):
    """--isotropic 1.0 on a (2.5, 0.8, 0.6) mm series prepends resample3d
    to [round(6 * 2.5), round(24 * 0.8), round(20 * 0.6)] = [15, 19, 12]:
    the reference's shape, its output within 1 level on < 1e-3 of voxels,
    and equal to the port's volume program on the resampled config."""
    hu = _dicom_series(tmp_path / "series")
    cfg_path = tmp_path / "iso.yaml"
    cfg_path.write_text(ISO_CHAIN)
    args = ["enhance-volume", str(tmp_path / "series"), "-c", str(cfg_path),
            "--mode", "3d", "--isotropic", "1.0", "-o"]
    assert cli.main([*args, str(tmp_path / "port.nc")], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [15, 19, 12]
    assert jax_main([*args, str(tmp_path / "jax.nc")]) == 0
    got, _ = load_volume(tmp_path / "port.nc")
    ref, _ = load_volume(tmp_path / "jax.nc")
    _within_bound(got, ref)
    want = compile_volume_pipeline(PipelineConfig.make(
        [("resample3d", {"depth": 15, "height": 19, "width": 12}),
         *load_config(cfg_path).stages]), device="cpu")(hu).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra,match", [
    (["--mode", "3d", "--stream"], "slice-mode only"),
    (["--stream"], "--isotropic needs --mode 3d"),
    ([], "--isotropic needs --mode 3d"),
    (["--mode", "3d", "--npy"], "--isotropic needs voxel spacing"),
], ids=["stream-3d", "stream", "slices", "no-spacing"])
def test_isotropic_refusals(tmp_path, extra, match):
    _dicom_series(tmp_path / "series")
    cfg_path = tmp_path / "iso.yaml"
    cfg_path.write_text(ISO_CHAIN)
    src = str(tmp_path / "series")
    if "--npy" in extra:  # a format without a spacing
        extra = extra[:-1]
        save_volume(tmp_path / "in.npy", np.zeros((4, 8, 8), np.int16))
        src = str(tmp_path / "in.npy")
    with pytest.raises(SystemExit, match=match):
        cli.main(["enhance-volume", src, "-c", str(cfg_path), "-o",
                  str(tmp_path / "o.nc"), "--isotropic", "1.0", *extra],
                 device="cpu")


def test_isotropic_with_metrics_is_refused_naming_item_5(tmp_path, capsys):
    """Since --metrics is ported (queue 1 item 5) the refusal is the
    reference's: the resampled grid has no full-reference counterpart."""
    _dicom_series(tmp_path / "series")
    cfg_path = tmp_path / "iso.yaml"
    cfg_path.write_text(ISO_CHAIN)
    with pytest.raises(SystemExit, match="--isotropic changes the grid shape"):
        cli.main(["enhance-volume", str(tmp_path / "series"), "-c",
                  str(cfg_path), "-o", str(tmp_path / "o.nc"), "--mode",
                  "3d", "--isotropic", "1.0", "--metrics", "psnr"],
                 device="cpu")


@pytest.mark.parametrize("sub,item", [("serve", "serving"),
                                      ("export", "artifact"),
                                      ("doctor", "status"),
                                      ("warmup", "compiled")])
def test_unported_subcommands_exit_2_naming_the_roadmap_item(
        sub, item, tmp_path, sharpen, monkeypatch, capsys):
    """Refused until they were ported (queue 1 item 7), the subcommands run
    and print the reference's JSON: serve announces its chain (the
    blocking loop replaced by one that closes the server; the server
    itself: tests/test_torch_serve.py), export writes an artifact, doctor
    reports (exit 1 without a card), warmup runs each batch."""
    import mies_tpu_torch.serve as serve_mod

    monkeypatch.setattr(serve_mod, "_run_server", lambda srv, announce: (
        print(json.dumps(announce)), srv.server_close()))
    argv = {
        "serve": ["-c", str(sharpen), "--port", "0", "--warmup", "32x48"],
        "export": ["-c", str(sharpen), "-o", str(tmp_path / "s.mies"),
                   "--size", "32", "--batch", "1", "--dtype", "uint8"],
        "doctor": ["--probe-timeout", "60"],
        "warmup": ["-c", str(sharpen), "--size", "32", "--batch", "1", "2"],
    }[sub]
    rc = cli.main([sub, *argv], device="cpu")
    out = json.loads(capsys.readouterr().out)
    assert item in out
    assert rc == (1 if sub == "doctor" and not torch.cuda.is_available()
                  else 0)
    if sub == "export":
        assert out["input_shape"] == [32, 32] and out["platforms"] == ["cpu"]
    if sub == "serve":
        assert out["pipeline"] == "gauss-sharpen"


@pytest.mark.parametrize("sub", ["evaluate", "train-denoiser"])
def test_ported_subcommands_run(tmp_path, sub, capsys):
    """evaluate (queue 1 item 5) and train-denoiser (item 6), refused until
    ported, run: one JSON result (tests/test_torch_eval_cli.py and
    tests/test_torch_train.py hold them to the reference's)."""
    if sub == "evaluate":
        a, b = _png(tmp_path / "a.png", seed=1), _png(tmp_path / "b.png", seed=2)
        argv = [sub, str(a), str(b)]
    else:
        argv = [sub, "-o", str(tmp_path / "ck"), "--steps", "2", "--batch",
                "2", "--patch", "16", "--features", "4", "--depth", "3"]
    assert cli.main(argv, device="cpu") == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) >= ({"psnr", "ssim", "uqi"} if sub == "evaluate"
                        else {"checkpoint", "steps", "loss_curve"})


def test_batch_mode_needs_an_output_dir(tmp_path, sharpen, capsys):
    srcs = [str(_png(tmp_path / f"x{i}.png", seed=i)) for i in range(2)]
    assert cli.main(["enhance", *srcs, "-c", str(sharpen)], device="cpu") == 2
    assert "requires -o" in capsys.readouterr().err


def test_ops_lists_the_ports_registry(capsys):
    assert cli.main(["ops"], device="cpu") == 0
    got = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(OP_REGISTRY) and len(got) == 99
    ref = json.loads(json.dumps(jcli._ops_listing(), default=str))
    got = json.loads(json.dumps(got, default=str))
    for op, params in got.items():  # same parameters and defaults
        assert list(params) == list(ref[op]), op
        for name, info in params.items():
            assert info.get("default") == ref[op][name].get("default"), (op, name)


def test_bench_refuses_the_cpu(sharpen):
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", "-c", str(sharpen), "--batch", "2", "--size", "32"],
                 device="cpu")


def test_window_from_file_rewrites_window_hu_as_the_reference(tmp_path):
    cfg_path = REPO / "configs" / "ct_soft_tissue.yaml"
    ct = np.random.default_rng(2).integers(-300, 400, (48, 64), dtype=np.int16)
    dcm = tmp_path / "ct.dcm"
    write_dicom(dcm, ct, window=(60.0, 350.0))
    got = cli._apply_file_window(load_config(cfg_path), [dcm])
    ref = jcli._apply_file_window(jcli._load_cfg(str(cfg_path)), [dcm])
    assert got.to_dict() == ref.to_dict()
    assert got.stages[0].kwargs() == {"center": 60.0, "width": 350.0}
    assert cli.main(["enhance", str(dcm), "-c", str(cfg_path), "-o",
                     str(tmp_path / "o.dcm"), "--window-from-file"],
                    device="cpu") == 0
    want = runner.enhance_image(dcm, got, device="cpu")
    np.testing.assert_array_equal(load_image(tmp_path / "o.dcm", dtype="raw"), want)
    # refusals: a PNG input, a DICOM without the window tags
    png = _png(tmp_path / "p.png")
    assert cli.main(["enhance", str(png), "-c", str(cfg_path),
                     "--window-from-file"], device="cpu") == 2
    write_dicom(tmp_path / "nowin.dcm", ct)
    assert cli.main(["enhance", str(tmp_path / "nowin.dcm"), "-c", str(cfg_path),
                     "--window-from-file"], device="cpu") == 2


def test_python_m_runs_the_cli(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-m", "mies_tpu_torch", "serve"],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 1
    assert "serve needs -c CONFIG or --artifact FILE.mies" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "mies_tpu_torch", "ops"],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0 and len(json.loads(proc.stdout)) == 99
