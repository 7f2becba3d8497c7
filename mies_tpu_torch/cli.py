"""CLI: enhance / enhance-volume / evaluate / train-denoiser / serve / export /
doctor / warmup / ops / bench on the card.

The reference's command line (``mies_tpu/cli.py``), its subcommands, flags,
defaults, JSON lines and messages:

  python -m mies_tpu_torch enhance -c config.yaml input.png [-o out.png] [--report r.png] [--run-report r.json [--stage-costs]]
  python -m mies_tpu_torch enhance -c config.yaml imgs/*.dcm -o outdir/   (batch, resumable)
  torchrun --nproc-per-node 4 -m mies_tpu_torch enhance -c config.yaml imgs/*.dcm -o outdir/ --data-parallel
  python -m mies_tpu_torch enhance-volume -c config.yaml vol.nc -o out.nc [--stream [--data-parallel]] [--metrics psnr ssim]
  python -m mies_tpu_torch enhance-volume -c configs/ct_volume_3d.yaml vol.nc -o out.nc --mode 3d
  python -m mies_tpu_torch enhance-volume -c chain3d.yaml dicom_dir/ -o out.nc --mode 3d --isotropic 1.0
  torchrun --nproc-per-node 4 -m mies_tpu_torch enhance-volume -c configs/ct_volume_3d.yaml vol.nc -o out.nc --mode 3d --data-parallel
  python -m mies_tpu_torch evaluate orig.png enhanced.png -m psnr ssim uqi
  python -m mies_tpu_torch train-denoiser -o ckpt/ [--steps 500 --arch dncnn --eval]
  torchrun --nproc-per-node 4 -m mies_tpu_torch train-denoiser -o ckpt/ --data-parallel
  python -m mies_tpu_torch serve -c config.yaml --warmup 512x512 [--port 8080]
  python -m mies_tpu_torch export -c config.yaml -o chain.mies --batch 1 --dtype uint8
  python -m mies_tpu_torch serve --artifact chain.mies
  python -m mies_tpu_torch doctor
  python -m mies_tpu_torch warmup -c config.yaml --batch 1 32
  python -m mies_tpu_torch ops
  python -m mies_tpu_torch bench -c config.yaml --batch 32 --size 512

Everything runs on the card; without one the commands raise (``doctor``
reports it and exits 1). ``--data-parallel`` runs one rank per card,
launched by ``torchrun`` (the process group joins from its ``env://``
variables; without them it is a world of one). ``enhance``: rank 0
decodes each batch, sends each rank its part, gathers the outputs, saves
them and keeps the manifest (``runner.enhance_batch(mesh=)``).
``enhance-volume``: rank 0 reads the input, sends each rank its z slab
(``--mode 3d``: ``parallel.volume_shard_apply``) or its part of every
slab (slice mode: ``runner.enhance_volume(mesh=)``; ``--stream``:
``runner.enhance_volume_stream(mesh=)``), gathers the output and writes
it. ``train-denoiser``: each rank trains on its shard of every batch, the
gradients summed by all_reduce; rank 0 writes the checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

def _load_cfg(path: str):
    from mies_tpu_torch.pipeline.config import load_config

    return load_config(path)


def _apply_file_window(cfg, inputs):
    """Rewrite the chain's window_hu stage with the FIRST input's
    modality-recommended WindowCenter/Width (DICOM 0028,1050/1051).
    Returns the new config, or None (error printed) when the request
    can't be honored: never a silent fallback to the config's numbers."""
    from mies_tpu_torch.io.dicom import read_dicom_header
    from mies_tpu_torch.pipeline.config import (
        PipelineConfig,
        StageConfig,
        validate,
    )

    first = inputs[0]
    if first.suffix.lower() not in (".dcm", ".dicom"):
        print("error: --window-from-file needs DICOM input(s)",
              file=sys.stderr)
        return None
    hdr = read_dicom_header(first)
    wc, ww = hdr.get("window_center"), hdr.get("window_width")
    if wc is None or ww is None:
        print(f"error: {first} carries no WindowCenter/WindowWidth "
              "(0028,1050/1051); drop --window-from-file or window "
              "explicitly in the config", file=sys.stderr)
        return None
    stages = []
    hit = False
    for st in cfg.stages:
        if st.op == "window_hu":
            kw = st.kwargs()
            kw.pop("preset", None)
            kw.update(center=float(wc), width=float(ww))
            stages.append(StageConfig.make("window_hu", **kw))
            hit = True
        else:
            stages.append(st)
    if not hit:
        print("error: --window-from-file needs a window_hu stage in "
              "the chain to rewrite", file=sys.stderr)
        return None
    out = PipelineConfig.make(
        stages, name=cfg.name, io=cfg.io_dict(), eval=cfg.eval_dict()
    )
    validate(out)
    return out


def cmd_enhance(args, device) -> int:
    from mies_tpu_torch.pipeline import runner

    cfg = _load_cfg(args.config)
    inputs = [Path(p) for p in args.inputs]
    if args.window_from_file:
        cfg = _apply_file_window(cfg, inputs)
        if cfg is None:
            return 2
    # batch mode when there are several inputs OR the output names a
    # directory: existing, trailing-separator, or suffix-less (a one-file
    # glob with a not-yet-created outdir/ must NOT degrade to single-file
    # mode and save an image AS the directory's path)
    batch_mode = len(inputs) > 1 or (
        args.output is not None
        and (
            Path(args.output).is_dir()
            or str(args.output).endswith(os.sep)
            or Path(args.output).suffix == ""
        )
    )
    if not batch_mode:
        if args.data_parallel:
            print("error: --data-parallel applies to batch mode only "
                  "(single-image runs use one device)", file=sys.stderr)
            return 2
        out_path = args.output or inputs[0].with_name(
            inputs[0].stem + ".enhanced" + inputs[0].suffix
        )
        t0 = time.perf_counter()
        out = runner.enhance_image(inputs[0], cfg, out_path, device=device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if args.report or args.run_report:
            return _reports(args, cfg, inputs[0], out_path, out, wall_ms,
                            device)
        print(json.dumps({"output": str(out_path), "shape": list(out.shape)}))
        return 0
    if not args.output:
        print("error: batch mode requires -o OUTPUT_DIR", file=sys.stderr)
        return 2
    if args.report or args.run_report:
        print("error: --report/--run-report are single-image flags; batch "
              "runs record progress in the manifest instead", file=sys.stderr)
        return 2
    if args.data_parallel:
        from mies_tpu_torch.parallel import make_mesh

        with _process_group(device):
            manifest = runner.enhance_batch(
                inputs, cfg, args.output, batch_size=args.batch,
                resume=not args.no_resume, mesh=make_mesh())
        if manifest is None:  # not rank 0: rank 0 saves and reports
            return 0
    else:
        manifest = runner.enhance_batch(
            inputs, cfg, args.output, batch_size=args.batch,
            resume=not args.no_resume, device=device,
        )
    print(json.dumps({"done": manifest.done_count,
                      "failed": len(manifest.failures),
                      "manifest": str(manifest.path)}))
    return 1 if manifest.failures else 0


def _reports(args, cfg, src: Path, out_path, out, wall_ms: float,
             device) -> int:
    """``enhance --report/--run-report``: psnr and ssim of the output
    against the input's uint8 form (``eval.report.reference_u8``), the
    before/after PNG and the JSON run report (with ``--stage-costs``,
    ``utils.profiling.stage_costs`` of the chain at the output's shape
    and batch 1). Refused (exit 2) for a multi-channel output or a chain
    that changes the shape."""
    from mies_tpu_torch.eval.metrics import evaluate
    from mies_tpu_torch.eval.report import (
        reference_u8,
        save_comparison_report,
        write_run_report,
    )

    if out.ndim != 2:
        print("error: --report/--run-report metrics support grayscale "
              "outputs only (io.channels: per-channel produces [C, H, W]); "
              "rerun without reports", file=sys.stderr)
        return 2
    orig = reference_u8(src, cfg)
    if orig.shape != out.shape:
        print(f"error: --report/--run-report metrics need a shape-preserving "
              f"chain (input {orig.shape} vs output {out.shape} — "
              f"resize/crop/rot90 stages change it); rerun without reports",
              file=sys.stderr)
        return 2
    metrics = evaluate(orig, out, names=("psnr", "ssim"), device=device)
    if args.report:
        save_comparison_report(orig, out, args.report, title=cfg.name,
                               metrics=metrics)
    if args.run_report:
        extra = {"input": str(src), "output": str(out_path)}
        if args.stage_costs:
            from mies_tpu_torch.utils.profiling import stage_costs

            extra["stage_costs"] = stage_costs(
                cfg, shape=out.shape[-2:], batch_size=1, device=device)
        write_run_report(
            args.run_report, cfg, metrics=metrics,
            timings={"wall_ms_including_compile": wall_ms},
            extra=extra,
        )
    print(json.dumps({"output": str(out_path), "shape": list(out.shape)}))
    return 0


def cmd_enhance_volume(args, device) -> int:
    from mies_tpu_torch.io.volume import load_volume, save_volume
    from mies_tpu_torch.pipeline import runner

    cfg = _load_cfg(args.config)
    if args.window_from_file:
        vp = Path(args.input)
        first = (sorted(vp.glob("*.dcm"))[:1] or [vp])[0] if vp.is_dir() else vp
        cfg = _apply_file_window(cfg, [first])
        if cfg is None:
            return 2
    if args.stream:
        # disk to disk: the volume is never wholly resident on the host
        if args.mode == "3d" or args.metrics:
            raise SystemExit("--stream is slice-mode only and incompatible "
                             "with --metrics (both need the whole volume in "
                             "memory)")
        if args.isotropic is not None:
            raise SystemExit(
                "--isotropic needs --mode 3d (whole-volume resample); "
                "it cannot run under --stream's slab-at-a-time model"
            )
        if args.data_parallel:
            from mies_tpu_torch.parallel import make_mesh

            with _process_group(device):
                meta = runner.enhance_volume_stream(
                    args.input, cfg, args.output, slab_size=args.slab,
                    var_name=args.var, progress=not args.quiet,
                    mesh=make_mesh())
            if meta is None:  # not rank 0: rank 0 writes and reports
                return 0
        else:
            meta = runner.enhance_volume_stream(
                args.input, cfg, args.output, slab_size=args.slab,
                var_name=args.var, progress=not args.quiet, device=device,
            )
        print(json.dumps({"input": meta.source, "shape": list(meta.shape),
                          "output": args.output, "streamed": True}))
        return 0
    if args.data_parallel:
        return _enhance_volume_data_parallel(args, cfg, device)
    vol, meta = load_volume(args.input, var_name=args.var)
    if args.isotropic is not None:
        cfg = _isotropic_config(cfg, args, vol.shape, meta.spacing)
    if args.mode == "3d":
        from mies_tpu_torch.pipeline.compiler import compile_volume_pipeline

        fn = compile_volume_pipeline(cfg, device=device)
        out = fn(vol).cpu().numpy()
    else:
        out = runner.enhance_volume(vol, cfg, slab_size=args.slab,
                                    progress=not args.quiet, device=device)
    save_volume(args.output, out)
    result = {"input": meta.source, "shape": list(out.shape),
              "output": args.output}
    if args.metrics:
        result.update(_volume_metrics(args, cfg, vol, out, device))
    print(json.dumps(result))
    return 0


def _volume_metrics(args, cfg, vol: np.ndarray, out: np.ndarray,
                    device) -> dict:
    """``enhance-volume --metrics``: per-slice metrics of the output against
    the input on the uint8 scale (an integer volume other than uint8
    through the chain's window_hu first), written to
    ``<output>.metrics.json``; returns the result line's additions."""
    from mies_tpu_torch.eval.metrics import evaluate_volume
    from mies_tpu_torch.ops.intensity import window_hu
    from mies_tpu_torch.pipeline.compiler import (
        _quantize_u8,
        _to_device,
        resolve_device,
    )

    x = _to_device(vol, resolve_device(device))
    if np.issubdtype(vol.dtype, np.integer) and vol.dtype != np.uint8:
        win = next((st.kwargs() for st in cfg.stages if st.op == "window_hu"),
                   None)
        if win is None:
            raise SystemExit("--metrics on int16 volumes needs a window_hu "
                             "stage to define the reference scale")
        gt = _quantize_u8(window_hu(x, **win))
    else:
        gt = x if vol.dtype == np.uint8 else _quantize_u8(x)
    m = evaluate_volume(gt, out, names=tuple(args.metrics), device=device)
    mpath = str(args.output) + ".metrics.json"
    with open(mpath, "w") as f:
        json.dump(m, f, indent=2)
    return {"metrics_mean": m["mean"], "metrics_file": mpath}


@contextlib.contextmanager
def _process_group(device):
    """Join the process group for ``--data-parallel`` (torchrun's env://
    variables, else a world of one) unless one is joined; leave it after."""
    import tempfile

    import torch.distributed as dist

    from mies_tpu_torch.parallel import init_distributed

    joined = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as store:
        if joined and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_distributed("env://", device=device)  # torchrun
        elif joined:
            init_distributed(f"file://{store}/store", 1, 0, device)
        try:
            yield dist.get_world_size(), dist.get_rank()
        finally:
            if joined:
                dist.destroy_process_group()


def _enhance_volume_data_parallel(args, cfg, device) -> int:
    """``enhance-volume --data-parallel``: join the process group, read the
    volume on rank 0, run it z-sharded (``--mode 3d``) or slab-sharded, and
    write the output (and ``--metrics``) on rank 0. Refused, on every rank:
    a Z (``--mode 3d``) or an ``--isotropic`` depth that does not divide by
    the ranks."""
    import torch.distributed as dist

    from mies_tpu_torch.io.volume import load_volume, save_volume
    from mies_tpu_torch.parallel import make_mesh, volume_shard_apply
    from mies_tpu_torch.pipeline import runner

    with _process_group(device) as (n, rank):
        vol, head = None, [None]
        if rank == 0:
            vol, meta = load_volume(args.input, var_name=args.var)
            head = [(vol.shape, meta.spacing, meta.source)]
        dist.broadcast_object_list(head, src=0)
        shape, spacing, source = head[0]
        if args.isotropic is not None:
            cfg = _isotropic_config(cfg, args, shape, spacing, n)
        if args.mode == "3d":
            if shape[0] % n:
                raise SystemExit(
                    f"--data-parallel with --mode 3d z-shards the volume: "
                    f"Z={shape[0]} must divide by the {n} devices"
                )
            mesh = make_mesh(data=1, space=n)
            out = runner.run_sharded(vol, volume_shard_apply(cfg, mesh),
                                     shape[0], mesh)
        else:
            out = runner.enhance_volume(vol, cfg, slab_size=args.slab,
                                        progress=not args.quiet,
                                        mesh=make_mesh())
        if rank == 0:
            save_volume(args.output, out)
            result = {"input": source, "shape": list(out.shape),
                      "output": args.output, "ranks": n}
            if args.metrics:
                result.update(_volume_metrics(args, cfg, vol, out, device))
            print(json.dumps(result))
    return 0


def _isotropic_config(cfg, args, shape, spacing, ranks: int | None = None):
    """The chain with a ``resample3d`` stage prepended that takes the
    volume to ``--isotropic`` mm voxels from the series' (dz, dy, dx)
    spacing: each axis ``max(1, round(n * s / mm))`` samples. Refused
    outside ``--mode 3d`` and without a spacing (only a DICOM series
    carries one)."""
    from mies_tpu_torch.pipeline.config import PipelineConfig

    if args.mode != "3d":
        raise SystemExit("--isotropic needs --mode 3d (it resamples the "
                         "whole [Z, H, W] grid)")
    if args.metrics:
        raise SystemExit("--isotropic changes the grid shape; full-reference "
                         "--metrics need matching shapes")
    if spacing is None:
        raise SystemExit(
            "--isotropic needs voxel spacing, which only DICOM series "
            "inputs carry (PixelSpacing + slice positions); use an "
            "explicit resample3d stage for other formats"
        )
    tgt = float(args.isotropic)
    d, h, w = (max(1, round(n * s / tgt)) for n, s in zip(shape, spacing))
    if ranks is not None and d % ranks:
        # the z-sharded resample3d needs the OUTPUT depth divisible by the
        # ranks: never silently change the user's grid
        lo, hi = (d // ranks) * ranks, (d // ranks + 1) * ranks
        raise SystemExit(
            f"--isotropic {tgt:g} under --data-parallel: target depth {d} "
            f"is not divisible by the {ranks} devices; adjust --isotropic so "
            f"the depth lands on a multiple of {ranks} (nearest: {lo} or "
            f"{hi} slices), or run without --data-parallel"
        )
    return PipelineConfig.make(
        [("resample3d", {"depth": d, "height": h, "width": w}), *cfg.stages],
        name=f"{cfg.name}-iso{tgt:g}mm", io=cfg.io_dict(),
        eval=cfg.eval_dict(),
    )


def cmd_export(args, device) -> int:
    """Export the chain as a portable .mies artifact (``torch.export``)."""
    from mies_tpu_torch.pipeline.export import (
        export_pipeline,
        read_export_header,
    )

    cfg = _load_cfg(args.config)
    if args.volume:
        if args.batch is not None:
            raise SystemExit("--batch does not apply to --volume exports "
                             "(whole-volume programs have no batch axis)")
        out = export_pipeline(cfg, args.output, shape=tuple(args.volume),
                              volume=True, input_dtype=args.dtype,
                              device=device)
    else:
        batch = 32 if args.batch is None else args.batch
        out = export_pipeline(
            cfg, args.output, shape=(args.size, args.size),
            batch_size=None if batch <= 1 else batch,
            input_dtype=args.dtype, device=device,
        )
    hdr = read_export_header(out)
    print(json.dumps({
        "artifact": str(out), "bytes": out.stat().st_size,
        "platforms": hdr["platforms"], "input_shape": hdr["input_shape"],
    }))
    return 0


# the accelerator probe: the card's name, count and power limit, as one
# JSON line (nvidia-smi's power.limit where it answers)
_CARD_PROBE = """\
import json, subprocess, torch
if not torch.cuda.is_available():
    raise SystemExit("torch.cuda.is_available() is False")
rep = {"name": torch.cuda.get_device_name(0),
       "devices": torch.cuda.device_count()}
try:
    rep["power_limit"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.splitlines()[0]
except (OSError, IndexError, subprocess.TimeoutExpired) as e:
    rep["power_limit"] = f"unavailable: {e}"
print(json.dumps(rep))
"""

# one rank of the sharding probe: a gloo all_reduce over a world of 2
_RANK_PROBE = """\
import sys, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method=sys.argv[1], world_size=2,
                        rank=int(sys.argv[2]))
t = torch.ones(4)
dist.all_reduce(t)
dist.destroy_process_group()
print(float(t.sum()))
"""


def _last_error(text: str, rc: int) -> str:
    lines = text.strip().splitlines()
    return lines[-1][:200] if lines else f"exit {rc}"


def _probe_card(timeout: float) -> dict:
    import subprocess

    try:
        r = subprocess.run([sys.executable, "-c", _CARD_PROBE],
                           timeout=timeout, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return {"error": f"card probe exceeded {timeout}s"}
    if r.returncode != 0:
        return {"error": _last_error(r.stderr, r.returncode)}
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"error": f"unparseable probe output: "
                         f"{r.stdout.strip()[:200]!r}"}


def _probe_kernels() -> dict:
    """The kernel build: nvcc, whether the library is built and its stamp
    the sources' current hash."""
    from mies_tpu_torch.kernels import _build

    stamp = _build.LIBRARY.with_suffix(".sha256")
    rep = {"library": str(_build.LIBRARY), "built": _build.LIBRARY.is_file(),
           "current": (_build.LIBRARY.is_file() and stamp.is_file()
                       and stamp.read_text() == _build._digest())}
    try:
        rep["nvcc"] = _build.find_nvcc()
    except RuntimeError as e:
        rep["error"] = str(e)
    return rep


def _probe_sharding(timeout: float = 180.0) -> dict:
    """A gloo world of 2 on the CPU, one subprocess a rank."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as store:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK_PROBE, f"file://{store}/store",
             str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(2)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                results.append((p.returncode, out, err))
        except subprocess.TimeoutExpired:
            return {"ok": False, "error": "probe timed out"}
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for rc, out, err in results:
        if rc != 0 or out.split()[-1:] != ["8.0"]:
            return {"ok": False, "error": _last_error(err, rc)}
    return {"ok": True, "world": 2, "backend": "gloo"}


def cmd_doctor(args, device) -> int:
    """Deployment health report: the card (a bounded probe in a
    subprocess: its name, count and power limit), the kernel build (nvcc,
    the library and its stamp), the native DICOM parser, and a gloo world
    of 2 on the CPU. One JSON object.

    Unlike the reference, whose CPU backend is a working deployment, the
    status is "ok" (exit 0) only when the card is usable and nvcc found:
    the port's entry points have no CPU fallback, so a healthy CPU alone
    is "degraded" (exit 1)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mies_tpu_torch import native

    with ThreadPoolExecutor(max_workers=2) as pool:  # both probes at once
        card = pool.submit(_probe_card, args.probe_timeout)
        sharding = pool.submit(_probe_sharding)
        report = {
            "torch": torch.__version__,
            "accelerator": card.result(),
            "kernels": _probe_kernels(),
            "native_dicom": {"available": native.available()},
            "sharding": sharding.result(),
        }
    ok = "error" not in report["accelerator"] and \
        "error" not in report["kernels"]
    report["status"] = "ok" if ok else "degraded"
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


def cmd_warmup(args, device) -> int:
    """Pay a config's first-call costs before production: build the kernels
    (nvcc, on the card), then run the chain once for each ``--batch`` on
    zeros of ``--dtype`` and report the seconds of each (the first call's
    allocator growth and cuDNN algorithm search)."""
    import time

    import torch

    from mies_tpu_torch.pipeline.compiler import (
        compile_pipeline,
        resolve_device,
    )
    from mies_tpu_torch.utils.profiling import (
        device_sync,
        enable_compilation_cache,
    )

    dev = resolve_device(device)
    cfg = _load_cfg(args.config)
    build_s = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        enable_compilation_cache()
        build_s = round(time.perf_counter() - t0, 2)
    h, w = args.size, args.size
    dtype = torch.int16 if args.dtype == "int16" else torch.float32
    compiled = []
    for b in args.batch:
        t0 = time.perf_counter()
        fn = compile_pipeline(cfg, batched=(b > 1), device=dev)
        shape = (b, h, w) if b > 1 else (h, w)
        device_sync(fn(torch.zeros(shape, dtype=dtype, device=dev)))
        compiled.append(
            {"batch": b, "shape": [h, w], "dtype": args.dtype,
             "seconds": round(time.perf_counter() - t0, 2)}
        )
    print(json.dumps({"config": cfg.name, "backend": dev.type,
                      "kernel_build_seconds": build_s,
                      "compiled": compiled}))
    return 0


def cmd_serve(args, device) -> int:
    from mies_tpu_torch.serve import serve

    if args.artifact is None and args.config is None:
        raise SystemExit("serve needs -c CONFIG or --artifact FILE.mies")
    if args.artifact is not None and args.config is not None:
        raise SystemExit(
            "-c and --artifact conflict: the artifact embeds its own "
            "config — pass exactly one"
        )
    if args.artifact is not None and args.warmup:
        raise SystemExit("--warmup is meaningless with --artifact "
                         "(the program is AOT-compiled)")
    warmup = None
    if args.warmup:
        try:
            h, w = (int(x) for x in args.warmup.lower().split("x"))
            warmup = (h, w)
        except ValueError:
            raise SystemExit(
                f"--warmup expects HxW (e.g. 512x512), got {args.warmup!r}"
            )
    if args.max_body_mb <= 0:
        raise SystemExit(f"--max-body-mb must be positive, got "
                         f"{args.max_body_mb}")
    serve(args.config, host=args.host, port=args.port, warmup=warmup,
          artifact=args.artifact, max_body_bytes=args.max_body_mb * 2**20,
          device=device)
    return 0


def _ops_listing() -> dict:
    """Op registry -> {op: {param: {default, expects}}}, the ``ops``
    command's JSON, over the port's registry."""
    import inspect

    from mies_tpu_torch.pipeline.compiler import OP_REGISTRY, STAGE_BUILDERS
    from mies_tpu_torch.pipeline.config import _VALUE_RULES

    out = {}
    for name, fn in sorted(OP_REGISTRY.items()):
        params = {}
        # a builder takes only config params (no image argument to skip)
        skip = 0 if name in STAGE_BUILDERS else 1
        for p in list(inspect.signature(fn).parameters.values())[skip:]:
            info = {}
            if p.default is not inspect.Parameter.empty:
                info["default"] = p.default
            rule = _VALUE_RULES.get(name, {}).get(p.name)
            if rule is not None:
                info["expects"] = rule[1]
            params[p.name] = info
        out[name] = params
    return out


def cmd_ops(args, device) -> int:
    """Print the op registry as JSON: params, defaults, constraints."""
    print(json.dumps(_ops_listing(), indent=2, default=str))
    return 0


def cmd_evaluate(args, device) -> int:
    """Full-reference metrics of two image files on the uint8 scale."""
    from mies_tpu_torch.eval.metrics import evaluate
    from mies_tpu_torch.io.image import from_float, load_image

    gt = from_float(load_image(args.original))
    p = from_float(load_image(args.enhanced))
    out = evaluate(gt, p, names=tuple(args.metrics), device=device)
    print(json.dumps(out, indent=2))
    return 0


def _default_augment(elastic: float = 0.0):
    """The standard medical-training recipe: full D4 geometry, mild
    intensity jitter on the input, no extra noise; the elastic warp by
    amplitude."""
    from mies_tpu_torch.models.augment import AugmentConfig

    return AugmentConfig(hflip=0.5, vflip=0.5, rot90=True, brightness=0.05,
                         contrast=0.1, gamma=0.1, elastic=elastic)


def cmd_train_denoiser(args, device) -> int:
    """Train the learned denoiser; prints one JSON line (rank 0)."""
    from mies_tpu_torch.models.train import train_denoiser

    depth = args.depth
    if depth is None:
        depth = 2 if args.arch == "unet" else 6
    kwargs = dict(
        steps=args.steps, batch=args.batch, patch=args.patch,
        features=args.features, depth=depth, arch=args.arch,
        sigma=args.noise_sigma, checkpoint_dir=args.output,
        data_dir=args.data, evaluate=args.eval,
        self_supervised=args.self_supervised,
        augment=(_default_augment(args.elastic)
                 if (args.augment or args.elastic > 0) else None),
        loss=args.loss, device=device,
    )

    def report(state, losses, rep) -> None:
        print(json.dumps({"checkpoint": args.output, "steps": int(state.step),
                          "loss_curve": losses, **rep}))

    if not args.data_parallel:
        report(*train_denoiser(**kwargs))
        return 0
    from mies_tpu_torch.parallel import make_mesh

    with _process_group(device) as (_, rank):
        result = train_denoiser(mesh=make_mesh(), **kwargs)
        if rank == 0:
            report(*result)
    return 0


def cmd_bench(args, device) -> int:
    from mies_tpu_torch.pipeline.runner import time_pipeline

    cfg = _load_cfg(args.config)
    res = time_pipeline(cfg, shape=(args.size, args.size),
                        batch_size=args.batch, iters=args.iters, device=device)
    res["config"] = cfg.name
    print(json.dumps(res))
    return 0


def main(argv=None, device="cuda") -> int:
    """Run one subcommand; ``device`` ("cuda" by default) is where the
    chains run (tests pass "cpu" for the plain chain)."""
    ap = argparse.ArgumentParser(prog="mies_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("enhance", help="enhance image(s) with a config chain")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-o", "--output", help="output file (single) or dir (batch)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--window-from-file", action="store_true",
                   help="rewrite the chain's window_hu stage with the "
                        "first DICOM input's own WindowCenter/Width "
                        "(0028,1050/1051)")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank per card under torchrun: each batch split "
                        "over the ranks (batch must divide by them)")
    p.add_argument("--report", help="write a before/after PNG report here")
    p.add_argument("--run-report",
                   help="write a structured JSON run report (config hash, "
                        "timings, metrics)")
    p.add_argument("--stage-costs", action="store_true",
                   help="include per-stage operations/bytes in the run "
                        "report")
    p.set_defaults(fn=cmd_enhance)

    p = sub.add_parser("enhance-volume", help="run a volume through the chain")
    p.add_argument("input")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--var", help="variable name inside .nc/.npz")
    p.add_argument("--slab", type=int, default=16)
    p.add_argument("--mode", choices=["slices", "3d"], default="slices",
                   help="'3d' runs a volumetric chain (clahe3d etc.) on the "
                        "whole volume")
    p.add_argument("--window-from-file", action="store_true",
                   help="rewrite the chain's window_hu stage with the "
                        "first DICOM file's WindowCenter/Width")
    p.add_argument("--stream", action="store_true",
                   help="disk-to-disk slab streaming (O(slab) host memory; "
                        "output .nc/.npy/DICOM dir)")
    p.add_argument("--isotropic", type=float, metavar="MM",
                   help="resample to MM-mm isotropic voxels first "
                        "(--mode 3d, DICOM series inputs)")
    p.add_argument("--metrics", nargs="+", default=None,
                   help="also write per-slice quality metrics vs the "
                        "(windowed) input, e.g. --metrics psnr ssim")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank per card under torchrun: --mode 3d "
                        "z-shards the volume, slice mode (and --stream) "
                        "splits each slab")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=cmd_enhance_volume)

    p = sub.add_parser("evaluate", help="full-reference quality metrics")
    p.add_argument("original")
    p.add_argument("enhanced")
    p.add_argument("-m", "--metrics", nargs="+",
                   default=["psnr", "ssim", "uqi"])
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train-denoiser", help="train the learned denoiser")
    p.add_argument("-o", "--output", required=True, help="checkpoint dir")
    p.add_argument("--data", help="directory of real slices "
                   "(png/jpg/tif/npy/dcm) to train on; default: synthetic "
                   "phantoms")
    p.add_argument("--eval", action="store_true",
                   help="report PSNR vs the bilateral baseline on a "
                        "held-out phantom set")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--patch", type=int, default=64)
    p.add_argument("--arch", choices=("dncnn", "unet"), default="dncnn",
                   help="model family: all-3x3 residual CNN or U-Net "
                        "encoder-decoder (larger receptive field/FLOP)")
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--depth", type=int, default=None,
                   help="dncnn: conv layers (default 6); unet: stride-2 "
                        "levels (default 2)")
    p.add_argument("--noise-sigma", type=float, default=0.08)
    p.add_argument("--self-supervised", action="store_true",
                   help="Noise2Void blind-spot training: no clean "
                        "targets; with --data, the slices' own noise is "
                        "the noise")
    p.add_argument("--loss", choices=("l2", "l1", "ssim", "mix"),
                   default="l2",
                   help="training objective: l2 (default), l1, ssim, mix "
                        "(0.16 L1 + 0.84 SSIM); Noise2Void supports l1/l2")
    p.add_argument("--augment", action="store_true",
                   help="stochastic augmentation on the card (flips + "
                        "90-degree rotations on input AND target, "
                        "brightness/contrast/gamma jitter on the input "
                        "only)")
    p.add_argument("--elastic", type=float, default=0.0, metavar="PX",
                   help="add elastic deformation (implies --augment) with "
                        "peak displacement PX pixels")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank per card under torchrun: each rank trains "
                        "on its shard of every batch")
    p.set_defaults(fn=cmd_train_denoiser)

    p = sub.add_parser("serve", help="HTTP inference server: a resident "
                                     "POST /enhance endpoint (see "
                                     "mies_tpu_torch/serve.py)")
    p.add_argument("-c", "--config")
    p.add_argument("--artifact", help="serve a .mies export instead of a "
                                      "config: one fixed-shape program")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--warmup", default=None, metavar="HxW",
                   help="run the chain once on this uint8 shape before the "
                        "socket serves, e.g. 512x512")
    p.add_argument("--max-body-mb", type=int, default=256,
                   help="reject POST bodies above this size with a 413 "
                        "before reading them (default 256)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("ops", help="list every pipeline op with its params, "
                                   "defaults, and constraints")
    p.set_defaults(fn=cmd_ops)

    p = sub.add_parser("export", help="export the chain (torch.export) as "
                                      "one portable artifact")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-o", "--output", required=True, help=".mies artifact path")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=None,
                   help="leading batch axis (default 32; 1 = the "
                        "single-slice program `serve --artifact` needs)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "uint8", "uint16", "int16"),
                   help="traced input spec: uint8 for PNG/X-ray serving, "
                        "int16 for CT window_hu chains (raw ints normalize "
                        "in the program), float32 for pre-normalized "
                        "callers")
    p.add_argument("--volume", type=int, nargs=3, metavar=("Z", "H", "W"),
                   help="export the [Z, H, W] volume program instead")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("doctor", help="deployment health report: the card "
                                      "(bounded probe), the kernel build, "
                                      "native parser, sharding sanity")
    p.add_argument("--probe-timeout", type=int, default=240,
                   help="seconds to wait for the card probe")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("warmup", help="build the kernels and run a config's "
                                      "chain once per batch size (the first "
                                      "call's costs)")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, nargs="+", default=[1, 32],
                   help="batch sizes to run (1 = the single-slice program)")
    p.add_argument("--dtype", choices=("float32", "int16"),
                   default="float32")
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("bench", help="throughput benchmark for a config")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
