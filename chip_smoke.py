#!/usr/bin/env python3
"""Bring-up check of mies_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one printed line each (or a few):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile the CUDA kernels (csrc/*.cu) with nvcc;
  3. kernels — each kernel against its plain PyTorch version on the card
               at the flagship path's shapes ([32, 512, 512]), and again on
               one ragged 251x333 slice, with both times (CUDA events);
  4. slice   — compile_pipeline(flagship_config(), batched=True) on float32
               and uint8 batches: every kernel launched exactly once per
               call, output against the same chain in plain PyTorch on the
               card and on the CPU, single-slice == batched row;
  5. timing  — slices/s at batch 32 of 512^2, batch-1 latency p50/p95.
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0);
without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH, SIZE, GRID = 32, 512, (8, 8)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _ms(fn, iters: int = 20) -> float:
    """Device ms per call of fn(), CUDA events around ``iters`` calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _xray_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Synthetic chest-X-ray-like float32 slices in [0, 1]: smooth lung
    glow, rib texture and noise, each slice shifted and scaled."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w), np.float32)
    for i in range(b):
        cy, cx = h / 2 + rng.uniform(-40, 40), w / 2 + rng.uniform(-40, 40)
        r = np.sqrt((y - cy) ** 2 + (x - cx) ** 2) / (h / 2)
        base = rng.uniform(0.4, 0.7) * np.exp(-((r / 0.9) ** 2))
        ribs = 0.12 * np.maximum(np.sin(y / rng.uniform(12, 20)), 0.0) ** 3
        noise = 0.03 * rng.standard_normal((h, w)).astype(np.float32)
        out[i] = np.clip(base + ribs + noise + 0.08, 0.0, 1.0)
    return out


def main() -> int:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.kernels import bilateral as KB
    from mies_tpu_torch.kernels import clahe as KC
    from mies_tpu_torch.kernels import unsharp_gauss as KU
    from mies_tpu_torch.ops import filters as F
    from mies_tpu_torch.ops import histogram as H
    from mies_tpu_torch.pipeline.compiler import (
        OP_REGISTRY,
        _ingest,
        _quantize_u8,
        compile_pipeline,
    )
    from mies_tpu_torch.pipeline.presets import flagship_config, latency_config
    from mies_tpu_torch.pipeline.runner import time_latency, time_pipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _require(smi.returncode == 0 and smi.stdout.strip() != "",
             f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"device: {torch.cuda.get_device_name(dev)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | cards "
          f"{torch.cuda.device_count()}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    compiled = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if compiled else 'up to date'}) -> {_build.LIBRARY.name}")

    # -- 3. each kernel against its plain version, main-path shapes ------
    x = torch.from_numpy(_xray_batch(BATCH, SIZE, SIZE, seed=0)).to(dev)
    th, tw = SIZE // GRID[0], SIZE // GRID[1]
    rec = {}

    hk, hp = KC.tile_hists(x, GRID), KC.tile_hists_plain(x, GRID)
    err = (hk - hp).abs().max().item()
    _require(torch.equal(hk, hp), f"K1 counts differ by up to {err}")
    rec["K1"] = (err, _ms(lambda: KC.tile_hists(x, GRID)),
                 _ms(lambda: KC.tile_hists_plain(x, GRID)))

    luts = H._luts_opencv(hk.reshape(BATCH, -1, 256).float(), 2.0, th * tw)
    luts = luts.reshape(BATCH, *GRID, 256)
    ck, cp = KC.clahe_apply_lut(x, luts, GRID), KC.clahe_apply_lut_plain(x, luts, GRID)
    err = (ck - cp).abs().max().item()
    _require(torch.equal(ck, cp), f"K2 output differs by up to {err}")
    rec["K2"] = (err, _ms(lambda: KC.clahe_apply_lut(x, luts, GRID)),
                 _ms(lambda: KC.clahe_apply_lut_plain(x, luts, GRID)))

    bk = KB.bilateral_cuda(ck, 5, 0.1, 1.5, "reflect")
    bp = F.bilateral_blur(ck, 5, 0.1, 1.5, "reflect")
    err = (bk - bp).abs().max().item()
    _require(err <= 2e-6, f"K3 max abs error {err} > 2e-6")
    rec["K3"] = (err, _ms(lambda: KB.bilateral_cuda(ck, 5, 0.1, 1.5, "reflect")),
                 _ms(lambda: F.bilateral_blur(ck, 5, 0.1, 1.5, "reflect")))

    uk, up = KU.unsharp_quant_cuda(bk, 1.5, 1.0), KU.unsharp_quant_plain(bk, 1.5, 1.0)
    err = (uk.int() - up.int()).abs().max().item()
    _require(torch.equal(uk, up), f"K4 uint8 differs by up to {err} levels")
    _require(torch.equal(KU.unsharp_quant_cuda(bk, 1.5, 1.0, quantize=False),
                         KU.unsharp_quant_plain(bk, 1.5, 1.0, quantize=False)),
             "K4 float32 (quantize=False) is not bit-equal")
    rec["K4"] = (err, _ms(lambda: KU.unsharp_quant_cuda(bk, 1.5, 1.0)),
                 _ms(lambda: KU.unsharp_quant_plain(bk, 1.5, 1.0)))
    torch.cuda.synchronize()
    for k, (e, ms, pms) in rec.items():
        print(f"{k} [{BATCH},{SIZE},{SIZE}]: max_abs_err {e} | kernel "
              f"{ms:.4f} ms | plain {pms:.4f} ms | {card}")

    # the ragged edge: one 251x333 slice, every border mode of K3
    r = x[:1, :251, :333].contiguous()
    _require(torch.equal(KC.clahe_cuda(r, 2.0, GRID), H.clahe(r, 2.0, GRID)),
             "K1+K2 on 251x333 differ from the plain CLAHE")
    worst = 0.0
    for mode in ("reflect", "mirror", "nearest"):
        for k in (3, 5, 9):
            e = (KB.bilateral_cuda(r, k, 0.1, 1.5, mode)
                 - F.bilateral_blur(r, k, 0.1, 1.5, mode)).abs().max().item()
            _require(e <= 2e-6, f"K3 {mode} k={k} on 251x333: {e} > 2e-6")
            worst = max(worst, e)
    _require(torch.equal(KU.unsharp_quant_cuda(r, 1.5, 1.0),
                         KU.unsharp_quant_plain(r, 1.5, 1.0)),
             "K4 on 251x333 differs from the plain version")
    torch.cuda.synchronize()
    print(f"ragged 251x333: K1+K2 equal, K3 max abs {worst} (3 modes x "
          f"k 3/5/9), K4 equal")

    # -- 4. the slice through the port's entry points -------------------
    cfg = flagship_config()
    fn = compile_pipeline(cfg, batched=True)

    def plain_chain(batch: torch.Tensor) -> torch.Tensor:
        y = _ingest(batch)
        for s in cfg.stages:
            y = OP_REGISTRY[s.op](y, **s.kwargs())
        return _quantize_u8(y)

    x8 = _quantize_u8(x)
    launches = None
    for name, inp in (("float32", x), ("uint8", x8)):
        _build.reset_launches()
        out = fn(inp)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        _require(all(v == 1 for v in counts.values()),
                 f"{name} batch: launches per kernel {counts}, want 1 each")
        launches = launches or counts
        _require(out.shape == inp.shape and out.dtype == torch.uint8,
                 f"{name} output {tuple(out.shape)} {out.dtype}")
        d = (out.int() - plain_chain(inp).int()).abs()
        n = int((d > 0).sum().item())
        _require(d.max().item() <= 1 and n < 1e-3 * d.numel(),
                 f"{name}: {n} pixels differ (max {d.max().item()} levels)")
        print(f"slice {name} [{BATCH},{SIZE},{SIZE}]: launches {counts} | "
              f"vs plain chain on the card: {n} of {d.numel()} pixels differ "
              f"by 1 level")

    kw = cfg.stages[0].kwargs()
    _require(torch.equal(KC.clahe_batched(x, **kw), H.clahe(x, **kw)),
             "CLAHE stage (K1 + K2) differs from the plain CLAHE")
    out = fn(x)
    cpu = compile_pipeline(cfg, batched=True)(x[:2].cpu())
    d = (out[:2].cpu().int() - cpu.int()).abs()
    n = int((d > 0).sum().item())
    _require(d.max().item() <= 1 and n < 1e-3 * d.numel(),
             f"card vs CPU reference: {n} pixels differ (max {d.max().item()})")
    fout = compile_pipeline(cfg, batched=True, quantize=False)(x)
    _require(bool(torch.isfinite(fout).all()) and fout.min().item() >= 0.0
             and fout.max().item() <= 1.0, "float output not finite in [0, 1]")
    _require(torch.equal(compile_pipeline(cfg)(x[1]), out[1]),
             "single-slice output differs from the batched row")
    lat_out = compile_pipeline(latency_config(), batched=True)(x)
    _require(lat_out.shape == x.shape and lat_out.dtype == torch.uint8,
             "latency_config output shape/dtype")
    torch.cuda.synchronize()
    print(f"slice checks: CLAHE stage == plain, card vs CPU plain chain "
          f"{n} of {d.numel()} pixels differ, float output finite in [0,1], "
          f"single == batched row, latency_config runs")

    # -- 5. timing ----------------------------------------------------------
    tp = time_pipeline(flagship_config(), (SIZE, SIZE), BATCH, device=dev)
    # 200 samples: the p95 has 10 samples beyond it
    lat = time_latency(flagship_config(), (SIZE, SIZE), repeats=200, device=dev)
    lat2 = time_latency(latency_config(), (SIZE, SIZE), repeats=200, device=dev)
    torch.cuda.synchronize()
    print(f"throughput flagship b{BATCH} {SIZE}^2: "
          f"{tp['slices_per_sec']:.1f} slices/s | {tp['ms_per_batch']:.4f} "
          f"ms/batch | {card}")
    print(f"latency flagship b1 {SIZE}^2 (200 x 32 calls): p50 "
          f"{lat['p50_ms']:.4f} ms | p95 "
          f"{lat['p95_ms']:.4f} ms | latency_config p50 {lat2['p50_ms']:.4f} "
          f"ms p95 {lat2['p95_ms']:.4f} ms | {card}")

    sources = {
        "K1": ("tile_hists", "mies_tpu_torch/csrc/clahe.cu",
               "mies_tpu/kernels/clahe.py:923"),
        "K2": ("clahe_apply_lut", "mies_tpu_torch/csrc/clahe.cu",
               "mies_tpu/kernels/clahe.py:242"),
        "K3": ("bilateral", "mies_tpu_torch/csrc/bilateral.cu",
               "mies_tpu/kernels/bilateral.py:106"),
        "K4": ("unsharp_quant", "mies_tpu_torch/csrc/unsharp.cu",
               "mies_tpu/kernels/unsharp_gauss.py:159"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": rec[k][0],
         "ms": rec[k][1], "plain_ms": rec[k][2]}
        for k, (name, src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
