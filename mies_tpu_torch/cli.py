"""CLI: enhance / enhance-volume / ops / bench on the card.

The reference's command line (``mies_tpu/cli.py``) for the subcommands
whose modules are ported:

  python -m mies_tpu_torch enhance -c config.yaml input.png [-o out.png]
  python -m mies_tpu_torch enhance -c config.yaml imgs/*.dcm -o outdir/   (batch, resumable)
  python -m mies_tpu_torch enhance-volume -c config.yaml vol.nc -o out.nc [--stream]
  python -m mies_tpu_torch enhance-volume -c configs/ct_volume_3d.yaml vol.nc -o out.nc --mode 3d
  python -m mies_tpu_torch enhance-volume -c chain3d.yaml dicom_dir/ -o out.nc --mode 3d --isotropic 1.0
  torchrun --nproc-per-node 4 -m mies_tpu_torch enhance-volume -c configs/ct_volume_3d.yaml vol.nc -o out.nc --mode 3d --data-parallel
  python -m mies_tpu_torch ops
  python -m mies_tpu_torch bench -c config.yaml --batch 32 --size 512

Everything runs on the card; without one the commands raise.
``enhance-volume --data-parallel`` runs one rank per card, launched by
``torchrun`` (the process group joins from its ``env://`` variables;
without them it is a world of one): rank 0 reads the input, sends each
rank its z slab (``--mode 3d``: ``parallel.volume_shard_apply``) or its
part of every slab (slice mode: ``runner.enhance_volume(mesh=)``),
gathers the output and writes it. The reference's other subcommands and
the flags whose modules are not ported yet are refused with exit code 2
and the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

# refused flag or subcommand -> the ROADMAP.md item that ports it
NOT_PORTED = {
    "--report": "queue 1 item 5 (eval: metrics and the report)",
    "--run-report": "queue 1 item 5 (eval: metrics and the report)",
    "--stage-costs": "queue 1 item 7 (utils/profiling)",
    "--metrics": "queue 1 item 5 (eval: metrics)",
    "--data-parallel": "queue 1 item 7 (data-parallel image batches and "
                       "streamed volumes)",
    "evaluate": "queue 1 item 5 (eval)",
    "train-denoiser": "queue 1 item 6 (models)",
    "serve": "queue 1 item 7 (serve.py)",
    "export": "queue 1 item 7 (pipeline/export.py)",
    "doctor": "queue 1 item 7 (the user-facing surface)",
    "warmup": "queue 1 item 7 (the user-facing surface)",
}
REFUSED_COMMANDS = ("evaluate", "train-denoiser", "serve", "export", "doctor",
                    "warmup")


def _refuse(what: str) -> int:
    print(f"error: {what} is not ported to mies_tpu_torch yet: ROADMAP.md "
          f"{NOT_PORTED[what]}", file=sys.stderr)
    return 2


def _refused_flags(args, flags: tuple[str, ...]) -> str | None:
    """The first of ``flags`` that was given, or None."""
    for flag in flags:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if value not in (None, False):
            return flag
    return None


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

    flag = _refused_flags(args, ("--report", "--run-report", "--stage-costs",
                                 "--data-parallel"))
    if flag:
        return _refuse(flag)
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
        out_path = args.output or inputs[0].with_name(
            inputs[0].stem + ".enhanced" + inputs[0].suffix
        )
        out = runner.enhance_image(inputs[0], cfg, out_path, device=device)
        print(json.dumps({"output": str(out_path), "shape": list(out.shape)}))
        return 0
    if not args.output:
        print("error: batch mode requires -o OUTPUT_DIR", file=sys.stderr)
        return 2
    manifest = runner.enhance_batch(
        inputs, cfg, args.output, batch_size=args.batch,
        resume=not args.no_resume, device=device,
    )
    print(json.dumps({"done": manifest.done_count,
                      "failed": len(manifest.failures),
                      "manifest": str(manifest.path)}))
    return 1 if manifest.failures else 0


def cmd_enhance_volume(args, device) -> int:
    from mies_tpu_torch.io.volume import load_volume, save_volume
    from mies_tpu_torch.pipeline import runner

    flag = _refused_flags(args, ("--metrics",))
    if flag or (args.stream and args.data_parallel):
        return _refuse(flag or "--data-parallel")
    cfg = _load_cfg(args.config)
    if args.window_from_file:
        vp = Path(args.input)
        first = (sorted(vp.glob("*.dcm"))[:1] or [vp])[0] if vp.is_dir() else vp
        cfg = _apply_file_window(cfg, [first])
        if cfg is None:
            return 2
    if args.stream:
        # disk to disk: the volume is never wholly resident on the host
        if args.mode == "3d":
            raise SystemExit("--stream is slice-mode only (--mode 3d needs "
                             "the whole volume in memory)")
        if args.isotropic is not None:
            raise SystemExit(
                "--isotropic needs --mode 3d (whole-volume resample); "
                "it cannot run under --stream's slab-at-a-time model"
            )
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
    print(json.dumps({"input": meta.source, "shape": list(out.shape),
                      "output": args.output}))
    return 0


def _enhance_volume_data_parallel(args, cfg, device) -> int:
    """``enhance-volume --data-parallel``: join the process group (from
    torchrun's ``env://`` variables, else a world of one), read the volume
    on rank 0, run it z-sharded (``--mode 3d``) or slab-sharded, and write
    the output on rank 0. Refused, on every rank: a Z (``--mode 3d``) or an
    ``--isotropic`` depth that does not divide by the ranks."""
    import tempfile

    import torch.distributed as dist

    from mies_tpu_torch.io.volume import load_volume, save_volume
    from mies_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        volume_shard_apply,
    )
    from mies_tpu_torch.pipeline import runner

    joined = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as store:
        if joined and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_distributed("env://", device=device)  # torchrun
        elif joined:
            init_distributed(f"file://{store}/store", 1, 0, device)
        try:
            n, rank = dist.get_world_size(), dist.get_rank()
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
                print(json.dumps({"input": source, "shape": list(out.shape),
                                  "output": args.output, "ranks": n}))
        finally:
            if joined:
                dist.destroy_process_group()
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
                   help="not ported yet (refused)")
    p.add_argument("--report", help="not ported yet (refused)")
    p.add_argument("--run-report", help="not ported yet (refused)")
    p.add_argument("--stage-costs", action="store_true",
                   help="not ported yet (refused)")
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
                   help="not ported yet (refused)")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank per card under torchrun: --mode 3d "
                        "z-shards the volume, slice mode splits each slab "
                        "(not with --stream: refused)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=cmd_enhance_volume)

    p = sub.add_parser("ops", help="list every pipeline op with its params, "
                                   "defaults, and constraints")
    p.set_defaults(fn=cmd_ops)

    p = sub.add_parser("bench", help="throughput benchmark for a config")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    for name in REFUSED_COMMANDS:
        sub.add_parser(name, help="not ported yet (refused)")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in REFUSED_COMMANDS:
        return _refuse(argv[0])  # whatever its arguments
    args = ap.parse_args(argv)
    return args.fn(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
