"""Throughput, latency and device-time harnesses on the card (CUDA events,
``torch.profiler``).

    python -m mies_tpu_torch.pipeline.runner configs/xray_adapthist_skimage.yaml

prints one JSON line: the config's batched throughput at b32 512^2 on
seeded slices of the config's ``io.dtype`` (and, with --profile, its
device time by kernel and busy share). With ``--volume Z`` the config runs
as a volume program (``compile_volume_pipeline``) on one seeded
[Z, 512, 512] volume, reported in z-slices/s:

    python -m mies_tpu_torch.pipeline.runner configs/ct_volume_3d.yaml --volume 256

A measurement needs a CUDA device: asked for any other device, or run
where there is no card, these raise instead of timing the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mies_tpu_torch.pipeline.compiler import (
    compile_pipeline,
    compile_volume_pipeline,
)
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"timing needs a CUDA device; got {device!r} "
            f"(torch.cuda.is_available() = {torch.cuda.is_available()})"
        )
    return dev


def make_batch(cfg: PipelineConfig, shape: tuple[int, int], batch_size: int,
               device, seed: int = 0) -> torch.Tensor:
    """Seeded input of the config's ``io.dtype`` on ``device``: int16
    Hounsfield units in [-1000, 1500), uint8 or uint16 levels over their
    whole range, or float32 in [0, 1) (no ``io.dtype``)."""
    rng = np.random.default_rng(seed)
    size = (batch_size, *shape)
    dtype = cfg.io_dict().get("dtype", "float32")
    if dtype == "int16":
        a = rng.integers(-1000, 1500, size, dtype=np.int16)
    elif dtype == "uint8":
        a = rng.integers(0, 256, size, dtype=np.uint8)
    elif dtype == "uint16":
        a = rng.integers(0, 65536, size, dtype=np.uint16)
    else:
        a = rng.random(size, dtype=np.float32)
    return torch.from_numpy(a).to(device)


def _ms_per_call(fn, x: torch.Tensor, iters: int) -> float:
    """Device milliseconds per call over ``iters`` back-to-back calls,
    between two CUDA events on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _median_ms(fn, x: torch.Tensor, iters: int, warmup: int, repeats: int,
               dev: torch.device) -> float:
    """The median of ``repeats`` runs of ``_ms_per_call`` after ``warmup``
    calls."""
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn(x)
        torch.cuda.synchronize(dev)
        runs = sorted(_ms_per_call(fn, x, iters) for _ in range(repeats))
    return runs[len(runs) // 2]


def _percentiles_ms(samples: list[float]) -> dict:
    samples = sorted(samples)
    return {
        "p50_ms": samples[len(samples) // 2],
        "p95_ms": samples[min(int(len(samples) * 0.95), len(samples) - 1)],
    }


def time_pipeline(
    cfg: PipelineConfig,
    shape: tuple[int, int] = (512, 512),
    batch_size: int = 32,
    iters: int = 20,
    warmup: int = 3,
    repeats: int = 5,
    device="cuda",
    batch: torch.Tensor | None = None,
) -> dict:
    """Batched throughput of ``cfg`` (quantize on) on ``batch`` (default:
    ``make_batch``'s seeded slices): CUDA events around ``iters`` calls
    after ``warmup``, the median of ``repeats`` such runs."""
    dev = _cuda_device(device)
    if batch is None:
        batch = make_batch(cfg, shape, batch_size, dev)
    batch_size, shape = batch.shape[0], tuple(batch.shape[1:])
    fn = compile_pipeline(cfg, batched=True, quantize=True, device=dev)
    per_batch = _median_ms(fn, batch, iters, warmup, repeats, dev)
    return {
        "slices_per_sec": batch_size / (per_batch / 1000.0),
        "p50_ms_per_slice": per_batch / batch_size,
        "ms_per_batch": per_batch,
        "batch_size": batch_size,
        "shape": list(shape),
        "device": torch.cuda.get_device_name(dev),
    }


def time_latency(
    cfg: PipelineConfig,
    shape: tuple[int, int] = (512, 512),
    iters: int = 32,
    repeats: int = 32,
    device="cuda",
) -> dict:
    """Batch-1 latency: the single-slice program, CUDA events around
    ``iters`` calls per repeat (after 3 warm-up calls); p50/p95 over the
    ``repeats`` per-call estimates."""
    dev = _cuda_device(device)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    fn = compile_pipeline(cfg, batched=False, quantize=True, device=dev)
    with torch.cuda.device(dev):
        for _ in range(3):
            fn(img)
        torch.cuda.synchronize(dev)
        samples = [_ms_per_call(fn, img, iters) for _ in range(repeats)]
    return {
        **_percentiles_ms(samples),
        "batch_size": 1,
        "shape": list(shape),
        "program": "single-slice",
        "device": torch.cuda.get_device_name(dev),
    }


def _profile(fn, x: torch.Tensor, iters: int, dev: torch.device) -> dict:
    """Device time per call of ``fn(x)`` by kernel name (``torch.profiler``
    over ``iters`` calls, kernels, copies and fills alike) and by the host
    op that launched it, the device operations launched per call, the
    unprofiled event-timed ms per call over as many calls, and their
    ratio, the device's busy share (the rest is time the host keeps the
    card waiting)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.cuda.device(dev):
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize(dev)
        wall = _ms_per_call(fn, x, iters)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(x)
            torch.cuda.synchronize(dev)
    events = prof.key_averages()
    by_kernel = {
        evt.key: evt.self_device_time_total / 1e3 / iters
        for evt in events
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and evt.self_device_time_total > 0
    }
    # the same device time by the host op that launched it (aten::...)
    by_op = {
        evt.key: evt.self_device_time_total / 1e3 / iters
        for evt in events
        if evt.device_type == torch.autograd.DeviceType.CPU
        and evt.self_device_time_total > 0
    }
    device_ms = sum(by_kernel.values())
    launches = sum(evt.count for evt in events
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and evt.self_device_time_total > 0)
    return {
        "ms_per_call": wall,
        "device_ms_per_call": device_ms,
        "device_launches_per_call": launches / iters,
        "busy_share": device_ms / wall,
        "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])),
        "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
        "device": torch.cuda.get_device_name(dev),
    }


def profile_pipeline(
    cfg: PipelineConfig,
    shape: tuple[int, int] = (512, 512),
    batch_size: int = 32,
    iters: int = 10,
    device="cuda",
    batch: torch.Tensor | None = None,
) -> dict:
    """Where a batched call's time goes: ``_profile`` of the batched
    chain (quantize on) on ``batch`` (default: ``make_batch``'s seeded
    slices)."""
    dev = _cuda_device(device)
    if batch is None:
        batch = make_batch(cfg, shape, batch_size, dev)
    fn = compile_pipeline(cfg, batched=True, quantize=True, device=dev)
    return {**_profile(fn, batch, iters, dev),
            "batch_size": batch.shape[0], "shape": list(batch.shape[1:])}


def time_volume(
    cfg: PipelineConfig,
    shape: tuple[int, int, int] = (32, 512, 512),
    iters: int = 10,
    warmup: int = 2,
    repeats: int = 3,
    quantize: bool = True,
    device="cuda",
    vol: torch.Tensor | None = None,
) -> dict:
    """Volume throughput of ``cfg`` through ``compile_volume_pipeline`` on
    ``vol`` (default: one seeded [Z, H, W] volume of the config's
    ``io.dtype``): CUDA events around ``iters`` calls after ``warmup``,
    the median of ``repeats`` such runs, in z-slices/s."""
    dev = _cuda_device(device)
    if vol is None:
        vol = make_batch(cfg, tuple(shape[1:]), shape[0], dev)
    fn = compile_volume_pipeline(cfg, quantize=quantize, device=dev)
    per_volume = _median_ms(fn, vol, iters, warmup, repeats, dev)
    return {
        "z_slices_per_sec": vol.shape[0] / (per_volume / 1000.0),
        "ms_per_volume": per_volume,
        "shape": list(vol.shape),
        "device": torch.cuda.get_device_name(dev),
    }


def profile_volume(
    cfg: PipelineConfig,
    shape: tuple[int, int, int] = (32, 512, 512),
    iters: int = 10,
    quantize: bool = True,
    device="cuda",
    vol: torch.Tensor | None = None,
) -> dict:
    """``_profile`` of the volume program on ``vol`` (default: one seeded
    volume of ``shape``)."""
    dev = _cuda_device(device)
    if vol is None:
        vol = make_batch(cfg, tuple(shape[1:]), shape[0], dev)
    fn = compile_volume_pipeline(cfg, quantize=quantize, device=dev)
    return {**_profile(fn, vol, iters, dev), "shape": list(vol.shape)}


def main(argv: list[str] | None = None) -> int:
    from mies_tpu_torch.pipeline.presets import flagship_config

    ap = argparse.ArgumentParser(
        description="Time a config's batched chain on the card; one JSON line.")
    ap.add_argument("config", nargs="?",
                    help="a .yaml/.json config (default: the flagship chain)")
    ap.add_argument("--profile", action="store_true",
                    help="also report device time by kernel (torch.profiler)")
    ap.add_argument("--volume", type=int, metavar="Z",
                    help="run the config as a volume program on one "
                         "[Z, 512, 512] volume (z-slices/s)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config) if args.config else flagship_config()
    if args.volume is not None:
        shape = (args.volume, 512, 512)
        result = {"config": cfg.name, **time_volume(cfg, shape)}
        if args.profile:
            result["profile"] = profile_volume(cfg, shape)
    else:
        result = {"config": cfg.name, **time_pipeline(cfg)}
        if args.profile:
            result["profile"] = profile_pipeline(cfg)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
