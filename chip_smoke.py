#!/usr/bin/env python3
"""Bring-up check of mies_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one printed line each (or a few):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile the CUDA kernels (csrc/*.cu) with nvcc;
  3. kernels — each kernel against its plain PyTorch version on the card
               at the main paths' shapes ([32, 512, 512]: the flagship's
               8x8 tiles (K1 to the OpenCV LUTs, K1's float counts, K2
               in both epilogues), the skimage config's 8x8 regions of
               64x64 (K6a and K6 also at nbins 1000); the
               restoration kernels K9-K12 on the inputs their chains give
               them, at the shipped parameters (K9 also at option 2 and at
               1 and 7 steps); the 3-D CLAHE kernels K8 (both epilogues)
               and K8s on a [32, 512, 512] volume at grid (4, 8, 8) (K8s
               also at nbins 1000), K8
               also on the windowed [256, 512, 512] CT phantom; K7, K3 and
               K4 at [8, 1024, 1024]; at a 4096^2
               slice K1 to the LUTs (twice: repeated calls give equal
               LUTs), K1 float and bins, K2 in both epilogues, K6 on
               regions of 512^2 and K5 at
               every band of a 4-way row split, the stitched bands against
               K2; K13 against K3 ->
               K4 and its plain version at [32, 512, 512] and
               [8, 1024, 1024], by the profiler beside K3 + K4), with the
               kernel's, the plain version's and (where one PyTorch call
               computes the same function) the library call's time (CUDA
               events), the bound (least time for the bytes and the
               operations), and for K1-K4, K5, K6, K6a and K13 also the
               profiler's device time; then on ragged shapes (251x333
               slices, skimage regions 31x41: odd region columns, kc % 64
               != 0; volumes
               [12, 96, 160] at grid (3, 3, 5) and [20, 251, 333], K8s at
               [12, 96, 166] (W % 4 != 0); K5 on a
               3-way split at grid (6, 5); K13 in K3's three borders; K3
               at k 3, 5, 7, 9 in its three borders and K4 at radii 1.0,
               1.5 and 4.0, both quantize modes, at 1x1, 3x5, 130x77,
               251x333 and 513x511);
  4. slices  — through load_config / compile_pipeline(batched=True) on
               float32, uint8, uint16 and int16 batches: the flagship chain
               (at 512^2 and 1024^2), configs/xray_adapthist_skimage.yaml,
               configs/ct_lowdose_nlm.yaml (int16 HU), configs/ultrasound_
               despeckle.yaml, configs/mammogram_sharpen.yaml (uint16,
               1024^2) and the BASELINE w10, w9, w8 and w3 (1024^2) chains;
               the chains of the intensity, equalization, median, guided
               and morphology ops: configs/histeq_baseline.yaml (uint8),
               BASELINE w1 (float32, batch 1), configs/ct_soft_tissue.yaml
               and configs/ct_guided_denoise.yaml (int16; K1 to the LUTs,
               K2, K4), BASELINE w4 (int16, batch 64; K3), configs/
               mammo_microcalc_tophat.yaml (uint8, 8 x 1024^2) and
               BASELINE w7 (float32; its uint8 hash equal to the CPU
               plain chain's), each equal to its plain chain on the card;
               the chains of the frequency, wavelet and ridge ops:
               configs/xray_homomorphic.yaml (uint8; K4),
               configs/xray_wavelet_denoise.yaml (float32; K1 to the LUTs,
               K2) and configs/angio_vessel_enhance.yaml (uint8, a
               synthetic angiography batch; no hand kernel), each equal to
               its plain chain on the card and within 1 level on < 1e-3
               of pixels of the CPU plain chain on 4 slices; butterworth,
               sato, meijering, hessian (off frangi's knife edge) and
               cycle_spin (max_shifts 3) once each against the CPU;
               and through compile_volume_pipeline: configs/ct_volume_3d.yaml
               on an int16 [256, 512, 512] phantom, BASELINE w6 and clahe3d
               fraction and skimage at [32, 512, 512]. Each kernel of the
               path launched exactly as often per call as the design says
               and no other, output against the same chain in plain PyTorch
               on the card (and the CPU), single-slice == batched row, the
               flagship's uint8 output hash; a
               fraction and a kornia config once each; the row-sharded
               flagship (mies_tpu_torch.parallel) on an NCCL process group
               of one rank: spatial_shard_apply at [4096, 4096] and
               batch_spatial_shard_apply at [8, 4096, 4096], each equal to
               compile_pipeline, K1 to the LUTs, K5, K3, K4 once per
               call, timed and
               (the 4096^2 slice) profiled beside compile_pipeline;
  5. timing  — slices/s at batch 32 of 512^2 for every 2-D chain of phase 4
               but fraction and kornia (w1 at its batch 1, w4 at 64), at
               batch 8 of 1024^2 for w3, the mammogram configs and the
               flagship, z-slices/s for w6 and
               the CT volume config and clahe3d skimage, flagship batch-1
               latency p50/p95, and
               each timed chain's device time by kernel and its device
               launches per call (torch.profiler; not w10's) against its
               event-timed time per call: the device's busy share; the
               fused tail's A/B on the flagship (MIES_TPU_FUSE_TAIL off,
               on, on, off by time_pipeline; with it on K1 to the LUTs,
               K2, K13 once each and the same output); one line each of
               K3's and K4's, of K1's, K2's and K5's, of K6a's, and of K6's
               and K8s's,
               ms beside the device time and busy share of the chains they
               lie on; one line each for the homomorphic, wavelet and
               angiography chains: slices/s, device ms, launches, busy;
  6. files   — load -> enhance -> save through the file entry points
               (mies_tpu_torch.pipeline.runner) and the command line,
               without Pillow: the native DICOM decoders build (g++);
               BASELINE w5, a seeded 512^3 int16 volume written to .nc
               and streamed .nc -> .nc by enhance_volume_stream through
               presets.flagship_volume_config at slab 16, twice (end-to-
               end z-slices/s, the stream's own peak device memory under
               256 MiB, K1 to the LUTs, K2, K3, K4 once per slab and no
               other kernel), once under tracemalloc (the host's numpy
               peak within 2 slabs + 1 MiB: the stream's two read
               buffers; seconds, z-slices/s), once more under the
               profiler (device time by kind, the busy share), the chain
               alone by time_pipeline
               (int16 b16 512^2), the slab read and the output write
               alone; the output equal to compile_pipeline(batched=True)
               per slab and to enhance_volume, its first slab within 1
               level on < 1e-3 of pixels of the CPU plain chain; a
               64-slice int16 CT series (rescale slope and intercept,
               files in shuffled order) streamed directory -> DICOM
               directory in position order, enhance_batch of its 64 files
               with configs/ct_soft_tissue.yaml (every output equal to
               compile_pipeline, a manifest of 64 done, a resumed run that
               processes none), enhance_image on one file; `python -m
               mies_tpu_torch enhance-volume --stream` and `--mode 3d -c
               configs/ct_volume_3d.yaml` (K8) in subprocesses, exit 0,
               each output equal to the in-process call's;
  7. volume ops — the volume registry at full width: the 3-D low-dose
               CT chain (int16 [256, 512, 512] phantom: window_hu ->
               median_blur3d -> denoise_tv3d -> clahe3d opencv (K1, the
               LUT build, K8) -> unsharp_mask3d -> uint8) through
               compile_volume_pipeline, K1 and K8 once a call and no other
               kernel, equal to the chain with the plain clahe3d on the
               card and within 1 level on < 1e-3 of voxels of the CPU
               plain chain at [32, 512, 512], z-slices/s (time_volume),
               device ms by op, launches and busy share (profile_volume),
               peak device memory; every other volume op once at
               [256, 512, 512] on the windowed phantom (device ms by CUDA
               events, peak memory under 40 GiB, finite, card vs CPU on a
               [16, 64, 96] and a [12, 67, 93] crop within the CPU tests'
               bounds); `python -m mies_tpu_torch enhance-volume --mode 3d
               --isotropic 1.0` on a 64-slice DICOM series at (2.5, 0.7,
               0.7) mm in a subprocess, exit 0, its [160, 358, 358] output
               equal to the in-process call's, TF32 off;
  8. z-sharded volume — K8z (K8 at a band's z offset) on phase 7's
               windowed [256, 512, 512] CT phantom at grid (4, 8, 8) in both
               epilogues, split into 2 and 4 z bands: each band bit-equal
               to the plain K8z, the bands concatenated bit-equal to K8,
               each launch's device ms beside its bound;
               configs/ct_volume_3d.yaml through volume_shard_apply on an
               NCCL world of one at int16 [512, 512, 512] (K1 and K8z once
               a call), bit-equal to compile_volume_pipeline, both timed
               per volume (CUDA events) and profiled (device ms, launches,
               busy share), peak memory of each; clahe3d fraction through
               it (K8z clip01); `python -m mies_tpu_torch enhance-volume
               --data-parallel` in --mode 3d and slice mode on a 512^3 .nc
               and with --isotropic 1.0 on the 64-slice series, each
               output file equal to the one written without the flag;
  9. 2-D registry — the rest of the 2-D registry at full width: chain
               (a), b32 512^2 X-ray phantoms through retinex (sigma 2, 8,
               30, clip) -> denoise_bilateral (K3 at k 7, 'edge') -> clahe
               opencv (K1 to the LUTs, K2) -> unsharp_mask r 1.5 + uint8
               (K4), each once a call and no other kernel, bit-equal to
               its plain stages around K3's output, < 1e-4 of its pixels
               off the all-plain chain on the card (K3's 2e-6 through
               CLAHE); on 4 slices retinex within 1e-6 and K3 within 2e-6
               of the CPU's, < 1e-3 of the uint8 pixels off, slices/s, device
               ms by op, launches, busy share, K3 at that call against the
               plain filter (the kernels line's k 7 row); chain (b), b8
               1024^2 through resize 512 -> rotate 7 -> center_crop 480 ->
               canny -> uint8 (no hand kernel; < 1e-3 of the edge pixels
               differ from the CPU's on 4 slices), the same figures and
               Canny's hysteresis steps; every other new op once at
               [32, 512, 512] (device ms, finite, card vs CPU on a
               [2, 64, 96] and a [2, 67, 93] crop within the CPU tests'
               bounds; histogram_match against a DICOM written by the
               port's writer), the rolling ball's launches a call, TF32
               off; sobel_edges -> kuwahara -> subtract_background
               (downscale 1) through spatial_shard_apply on an NCCL world
               of one at 4096^2, equal to compile_pipeline;
 10. eval and models — the metric suite and the learned denoiser at full
               width: every registry metric at b32 512^2 on the flagship's
               uint8 input and output, card against CPU on 4 slices within
               the CPU tests' bounds, ms per evaluate call;
               sharded_evaluate of configs/xray_clahe.yaml (psnr, ssim) on
               an NCCL world of one, K1 to the LUTs, K2, K3, K4 once a call
               and no other kernel, equal to compile_pipeline(batched=True)
               and the float chain's metrics, slices/s beside the flagship,
               device ms by op, busy share; train_denoiser at the CLI's
               defaults (DnCNN 32 x 6, bfloat16, b32, patch 64, 500
               synthetic steps, evaluate=True: the loss falls, psnr_model
               above psnr_noisy; steps/s, peak memory), then U-Net (24, 2),
               Noise2Void, the mix loss and --augment --elastic 4 for 20
               steps each; learned_denoise (that checkpoint) -> clahe
               opencv -> unsharp -> uint8 at b32 512^2 (K1 to the LUTs, K2,
               K4 once a call; equal to its plain CLAHE and tail on the
               card; on 4 slices the learned stage within 8e-3 of the CPU's
               and < 2% of the uint8 pixels off (bf16 on both, through
               CLAHE); slices/s, the convolutions' share, busy); one
               learned_denoise stage on the card, the CPU and the card
               again, each result equal to a fresh stage's there; evaluate,
               enhance --run-report and train-denoiser --steps 20 as
               subprocesses on DICOM files, each equal to the in-process
               result;
 11. serving and deployment — the HTTP server (mies_tpu_torch.serve) in
               a thread with the flagship chain on the card: 64 seeded
               512^2 uint8 PNGs from one client and 16 from 4 concurrent
               clients (each response equal to runner.enhance_image on the
               card, within 1 level on < 1e-3 of pixels of the plain chain
               on the card; K1 to the LUTs, K2, K3, K4 once a request),
               8 int16 DICOMs by ?filename= to a ct_soft_tissue server;
               requests/s, p50/p95, the handler's decode / chain (CUDA
               events) / encode split beside time_latency; export_pipeline
               of the flagship at b32 and b1 (uint8) and of
               configs/ct_volume_3d.yaml as an int16 [256, 512, 512] volume,
               then the b32 once more: each artifact bit-equal to its
               chain, its mies ops launching the kernels once a call, ms
               of the artifact beside the closure, bytes, export seconds;
               serve --artifact with the b1 artifact (responses equal to
               the server's, a wrong shape a 400); `python -m
               mies_tpu_torch serve --warmup 512x512`, `doctor`, `warmup`
               and `enhance --run-report --stage-costs` as four
               subprocesses at once; enhance_batch(mesh=) on the 64 PNG
               files and enhance_volume_stream(mesh=) on a seeded 512^3
               int16 .nc (w5) at NCCL world 1, equal to the runs without a
               mesh, files/s and z-slices/s beside them.
 12. device timers — runner.time_pipeline_device and
               time_latency_device: the chain ``inner`` times in one CUDA
               graph, timed by its replays. BASELINE w2, w3 (b8 1024^2),
               w4 (b64 int16), w5 (also b8 1024^2, where K1's tiles
               split), w7, w8, w9 and the skimage config at inner 8, w1
               and latency_config at b1 and inner 64: two replays
               bit-equal to the eager loop,
               exactly the path's hand kernels recorded at capture; the
               graph figure of two calls beside the event-timed
               time_pipeline / time_latency figure, the busy share, the
               graph pool's peak and the card, one line a chain.
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0);
without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

BATCH, SIZE, GRID = 32, 512, (8, 8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
# cv2.createCLAHE(2.0, (8, 8)).apply(cv2_noise(shape)) at shapes with one
# ragged axis (cv2 pads both axes then): the first 16 hex digits of the
# sha256 of its uint8 output. The card's machine has no cv2;
# tests/test_torch_clahe_cv2.py recomputes these with cv2.
CV2_CLAHE_SHA256 = {
    (67, 128): "21acfac166e70c47", (128, 93): "2ea01f89b3174d25",
    (64, 93): "976b637ac80fbe8d", (65, 64): "e177f052c11a3aa7",
    (121, 200): "e02b6647ceed358d", (512, 500): "ae00097415f613b4",
}


def cv2_noise(shape) -> np.ndarray:
    """uint8 noise from numpy seed 0, the input of CV2_CLAHE_SHA256."""
    return (np.random.default_rng(0).random(shape) * 256).astype(np.uint8)


def levels_sha256(levels: np.ndarray) -> str:
    """First 16 hex digits of the sha256 of uint8 levels."""
    return hashlib.sha256(np.ascontiguousarray(levels, np.uint8).tobytes()
                          ).hexdigest()[:16]


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


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least ms for the bytes (each input read once, each output written
    once) and the operations, at the card's published peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _bilateral_ops(k: int) -> int:
    """Operations per pixel of a k x k bilateral filter in its symmetric
    form: one weight per unordered pair (diff, square, scale, exp, times the
    spatial weight), three per tap (weight times value, two sums) and the
    final divide: 136 at k 5."""
    return (k * k - 1) // 2 * 5 + k * k * 3 + 1


def _index_add_ms(key: torch.Tensor, nbins_total: int) -> float:
    """One ``index_add_`` of ones at precomputed flat bin keys: the library
    call that computes a histogram (the key is built outside the timing)."""
    ones = torch.ones(key.numel(), device=key.device)
    out = torch.zeros(nbins_total, device=key.device)
    return _ms(lambda: out.zero_().index_add_(0, key, ones))


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


def _ct_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Synthetic int16 low-dose CT slices in Hounsfield units: an
    elliptical soft-tissue body (40 HU) in air (-1000) with a fat rim
    (-100), two lungs (-850), a contrast-filled vessel (200) and a bone
    ring (700), smoothed edges, plus quantum noise (sigma 25 HU); each
    slice shifted and scaled."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w), np.int16)
    for i in range(b):
        cy, cx = h / 2 + rng.uniform(-20, 20), w / 2 + rng.uniform(-20, 20)
        ry, rx = h * rng.uniform(0.36, 0.42), w * rng.uniform(0.42, 0.47)
        r = np.sqrt(((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2)
        hu = np.where(r < 1.0, 40.0, -1000.0)
        hu = np.where((r > 0.93) & (r < 1.0), -100.0, hu)
        for side in (-1, 1):
            rl = np.sqrt(((y - cy + 0.1 * ry) / (0.55 * ry)) ** 2
                         + ((x - cx - side * 0.45 * rx) / (0.3 * rx)) ** 2)
            hu = np.where(rl < 1.0, -850.0, hu)
        hu = np.where(np.abs(r - 0.85) < 0.025, 700.0, hu)
        hu = np.where((y - cy - 0.3 * ry) ** 2 + (x - cx) ** 2
                      < (0.08 * rx) ** 2, 200.0, hu)
        hu = 0.25 * (hu + np.roll(hu, 1, 0) + np.roll(hu, 1, 1)
                     + np.roll(hu, (1, 1), (0, 1)))
        hu = hu + 25.0 * rng.standard_normal((h, w))
        out[i] = np.clip(np.rint(hu), -1024, 3071).astype(np.int16)
    return out


def _us_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Synthetic uint8 B-mode ultrasound slices: a smooth tissue
    echogenicity with a dark cyst and a bright boundary, times fully
    developed speckle (unit-mean Rayleigh amplitude); each slice shifted."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w), np.uint8)
    for i in range(b):
        cy, cx = h / 2 + rng.uniform(-40, 40), w / 2 + rng.uniform(-40, 40)
        r = np.sqrt((y - cy) ** 2 + (x - cx) ** 2) / (h / 6)
        echo = 0.35 + 0.1 * np.sin(y / 37.0) * np.cos(x / 53.0)
        echo = np.where(r < 1.0, 0.08, echo)
        echo = np.where(np.abs(r - 1.0) < 0.06, 0.7, echo)
        speckle = rng.rayleigh(np.sqrt(2.0 / np.pi), (h, w))
        out[i] = np.clip(np.rint(255.0 * echo * speckle), 1, 255)
    return out


def _angio_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Synthetic uint8 angiography (DSA-like) slices: a bright, unevenly lit
    field with dark vessels of 1-4 px radius meandering across it, one
    branch, and noise; each slice shifted and rescaled."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w), np.uint8)
    for i in range(b):
        img = rng.uniform(0.6, 0.8) + 0.1 * (x / w) - 0.1 * (y / h)
        for k, width in enumerate((1.0, 2.0, 4.0)):
            c = (k + 1) * w / 4 + rng.uniform(-20, 20) + 12 * np.sin(
                y / rng.uniform(25, 60))
            img = img - rng.uniform(0.2, 0.35) * np.exp(-((x - c) / width) ** 2)
        r = h / 2 + rng.uniform(-40, 40) + 0.3 * (x - w / 2)
        img = img - 0.25 * np.exp(-((y - r) / 1.5) ** 2)
        img = img + 0.02 * rng.standard_normal((h, w))
        out[i] = np.clip(np.rint(255.0 * img), 0, 255)
    return out


def _ct_volume(z: int, h: int, w: int, seed: int,
               dev: torch.device) -> torch.Tensor:
    """Synthetic int16 CT volume in Hounsfield units, made on the card: an
    elliptic soft-tissue body (40 HU) in air (-1000) whose section shrinks
    towards both ends, a fat rim (-100), two ellipsoidal lungs (-850), a
    contrast-filled vessel along z (200) and a bone ring (700), smoothed
    in-plane edges, plus quantum noise (sigma 25 HU) from a seeded
    generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    zz = torch.linspace(-1.0, 1.0, z, device=dev)[:, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    cy, cx = h / 2, w / 2
    shrink = 1.0 - 0.15 * zz * zz
    ry, rx = 0.39 * h * shrink, 0.45 * w * shrink
    r = torch.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
    hu = torch.where(r < 1.0, 40.0, -1000.0)
    hu = torch.where((r > 0.93) & (r < 1.0), -100.0, hu)
    for side in (-1, 1):
        rl = torch.sqrt(((yy - cy + 0.1 * ry) / (0.55 * ry)) ** 2
                        + ((xx - cx - side * 0.45 * rx) / (0.3 * rx)) ** 2
                        + (zz / 0.8) ** 2)
        hu = torch.where(rl < 1.0, -850.0, hu)
    hu = torch.where((r - 0.85).abs() < 0.025, 700.0, hu)
    hu = torch.where((yy - cy - 0.3 * ry) ** 2 + (xx - cx) ** 2
                     < (0.08 * rx) ** 2, 200.0, hu)
    hu = 0.25 * (hu + hu.roll(1, 1) + hu.roll(1, 2) + hu.roll((1, 1), (1, 2)))
    hu = hu + 25.0 * torch.randn(hu.shape, generator=gen, device=dev)
    return torch.clamp(torch.round(hu), -1024, 3071).to(torch.int16)


def _levels_off(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """(max level difference, pixels that differ) of two uint8 arrays."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), int(np.count_nonzero(d))


def _files_phase(dev: torch.device, card: str, repo: Path) -> None:
    """Phase 6: load -> enhance -> save through the file entry points and the
    command line. BASELINE w5 (a 512^3 int16 .nc streamed to .nc through
    the flagship volume chain, slab 16, twice), a 64-slice DICOM series
    (directory -> DICOM directory, enhance_batch with resume,
    enhance_image) and two `python -m mies_tpu_torch enhance-volume`
    subprocesses."""
    from mies_tpu_torch import native
    from mies_tpu_torch.io.dicom import read_dicom_header, write_dicom
    from mies_tpu_torch.io.volume import (
        load_volume,
        open_volume_slabs,
        open_volume_writer,
        save_volume,
    )
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.pipeline.compiler import (
        compile_pipeline,
        compile_volume_pipeline,
    )
    from mies_tpu_torch.pipeline.config import load_config
    from mies_tpu_torch.pipeline.manifest import RunManifest
    from mies_tpu_torch.pipeline.presets import flagship_volume_config
    from mies_tpu_torch.pipeline.runner import (
        enhance_batch,
        enhance_image,
        enhance_volume,
        enhance_volume_stream,
        time_pipeline,
    )

    t0 = time.perf_counter()
    _require(native.available(),
             f"the native decoders did not build: {native._build_error}")
    print(f"files: native decoders available ({time.perf_counter() - t0:.2f} s "
          f"to build or load {native._SO.relative_to(repo)})")
    cfg5 = flagship_volume_config()
    want5 = {"tile_luts", "clahe_apply_lut", "bilateral", "unsharp_quant"}
    z5, slab = 512, 16
    nslabs = z5 // slab
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- w5: 512^3 int16 .nc -> .nc, slab 16 --------------------------
        vol = np.random.default_rng(0).integers(-1000, 2000, (z5, SIZE, SIZE),
                                                dtype=np.int16)
        t0 = time.perf_counter()
        save_volume(tmp / "w5.nc", vol, var_name="hu")
        write_in_s = time.perf_counter() - t0
        # the host's own parts, alone: the slab read, the output write
        from scipy.io import netcdf_file  # noqa: F401  (imported before timing)

        t0 = time.perf_counter()
        _, slabs = open_volume_slabs(tmp / "w5.nc", slab_size=slab)
        for _ in slabs:
            pass
        read_s = time.perf_counter() - t0
        zeros = np.zeros((slab, SIZE, SIZE), np.uint8)
        t0 = time.perf_counter()
        w = open_volume_writer(tmp / "zeros.nc", (z5, SIZE, SIZE), np.uint8)
        for _ in range(nslabs):
            w.append(zeros)
        w.close()
        write_s = time.perf_counter() - t0
        (tmp / "zeros.nc").unlink()
        runs = []
        for i in range(2):
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
            t0 = time.perf_counter()
            meta = enhance_volume_stream(tmp / "w5.nc", cfg5,
                                         tmp / f"w5_out{i}.nc",
                                         slab_size=slab, device=dev)
            torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev) - base
            runs.append({"s": dt, "z_slices_per_s": z5 / dt,
                         "peak_mib": peak / 2**20, "launches": launches})
            _require(tuple(meta.shape) == (z5, SIZE, SIZE),
                     f"w5 meta shape {meta.shape}")
            _require(launches == {k: nslabs if k in want5 else 0
                                  for k in launches},
                     f"w5 launches {launches}, want {sorted(want5)} "
                     f"{nslabs} times each (once per slab) and no other")
            _require(peak < 256 * 2**20,
                     f"w5 stream's own peak device memory {peak / 2**20:.1f} "
                     f"MiB is not under 256 MiB")
        # the host's numpy peak of one stream by tracemalloc: the reader's
        # two slab buffers and the writer (the pinned staging ring is
        # torch memory, which tracemalloc does not see)
        slab_bytes = slab * SIZE * SIZE * np.dtype(np.int16).itemsize
        host_limit = 2 * slab_bytes + 2**20
        tracemalloc.start()
        try:
            t0 = time.perf_counter()
            enhance_volume_stream(tmp / "w5.nc", cfg5, tmp / "w5_traced.nc",
                                  slab_size=slab, device=dev)
            torch.cuda.synchronize(dev)
            traced_s = time.perf_counter() - t0
            _, host_peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        _require(host_peak <= host_limit,
                 f"w5 stream's host numpy peak {host_peak} B is over 2 slabs "
                 f"+ 1 MiB ({host_limit} B)")
        print(f"files w5 host numpy peak (tracemalloc over one stream): "
              f"{host_peak} B = {host_peak / slab_bytes:.4f} slabs of "
              f"{slab_bytes} B (limit 2 slabs + 1 MiB = {host_limit} B) | "
              f"the traced stream {traced_s:.3f} s, {z5 / traced_s:.1f} "
              f"z-slices/s | {card}")
        # the same stream under the profiler (CUDA activity): device time
        # by kind over the stream's wall time inside the profiled window
        # (the profiler's start and stop excluded): the busy share
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enhance_volume_stream(tmp / "w5.nc", cfg5, tmp / "w5_prof.nc",
                                  slab_size=slab, device=dev)
            torch.cuda.synchronize(dev)
            prof_s = time.perf_counter() - t0
        by_kind: dict[str, float] = {}
        for evt in prof.key_averages():
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or evt.self_device_time_total <= 0):
                continue
            k = evt.key.lower()
            kind = ("copy HtoD" if "htod" in k else "copy DtoH" if "dtoh" in k
                    else "plain torch" if "at::" in k or "memset" in k
                    else "hand kernels")
            by_kind[kind] = by_kind.get(kind, 0.0) + evt.self_device_time_total / 1e3
        device_ms = sum(by_kind.values())
        _require(device_ms > 0, "the profiler saw no device time in the w5 stream")
        # the chain alone on the card: time_pipeline on int16 b16 512^2
        x16 = torch.from_numpy(vol[:slab]).to(dev)
        dev5 = time_pipeline(cfg5, batch=x16, device=dev)
        # outputs: both runs equal, equal to compile_pipeline(batched=True)
        # over the same slabs and to enhance_volume in memory; the first
        # slab within 1 level on < 1e-3 of pixels of the CPU plain chain
        out0, _ = load_volume(tmp / "w5_out0.nc")
        out1, _ = load_volume(tmp / "w5_out1.nc")
        outp, _ = load_volume(tmp / "w5_prof.nc")
        outt, _ = load_volume(tmp / "w5_traced.nc")
        _require(out0.dtype == np.uint8 and out0.shape == vol.shape,
                 f"w5 output {out0.dtype} {out0.shape}")
        _require(np.array_equal(out0, out1) and np.array_equal(out0, outp)
                 and np.array_equal(out0, outt), "w5 runs differ")
        fn5 = compile_pipeline(cfg5, batched=True, device=dev)
        for k in range(0, z5, slab):
            got = fn5(torch.from_numpy(vol[k:k + slab]).to(dev)).cpu().numpy()
            _require(np.array_equal(got, out0[k:k + slab]),
                     f"w5 slab at z {k} differs from compile_pipeline")
        mem = enhance_volume(vol, cfg5, slab_size=slab, device=dev)
        _require(np.array_equal(mem, out0), "w5: enhance_volume differs from the stream")
        cpu16 = compile_pipeline(cfg5, batched=True, device="cpu")(
            torch.from_numpy(vol[:slab])).numpy()
        off_max, off_n = _levels_off(out0[:slab], cpu16)
        _require(off_max <= 1 and off_n < 1e-3 * cpu16.size,
                 f"w5 first slab vs the CPU plain chain: {off_n} pixels off, "
                 f"max {off_max}")
        print(f"files w5 (512^3 int16 .nc -> .nc, slab {slab}): end to end "
              + ", ".join(f"{r['z_slices_per_s']:.1f} z-slices/s ({r['s']:.3f} s)"
                          for r in runs)
              + f" | device-only chain {dev5['slices_per_sec']:.1f} z-slices/s "
              f"({dev5['ms_per_batch']:.4f} ms per slab of {slab}) | the "
              f"stream's own peak device memory "
              + ", ".join(f"{r['peak_mib']:.1f}" for r in runs)
              + f" MiB (< 256) | launches per slab "
              f"{ {k: v // nslabs for k, v in runs[0]['launches'].items() if v} } "
              f"| profiled run {prof_s:.3f} s, device {device_ms:.2f} ms "
              f"(busy {device_ms / (prof_s * 1e3):.2%}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_kind.items()))
              + f" ms | host alone: read {read_s:.3f} s, write {write_s:.3f} s; "
              f"writing the input {write_in_s:.3f} s | equal to compile_pipeline "
              f"per slab and enhance_volume; slab 0 vs the CPU plain chain "
              f"{off_n} pixels off (max {off_max}) | {card}")
        del vol, out0, out1, outp, outt, mem

        # -- a 64-slice DICOM CT series -----------------------------------
        ct = _ct_volume(64, SIZE, SIZE, 5, dev).cpu().numpy()
        series = tmp / "series"
        series.mkdir()
        order = np.random.default_rng(1).permutation(64)
        for z in range(64):  # file names in shuffled order
            write_dicom(series / f"im{order[z]:03d}.dcm",
                        (ct[z].astype(np.int32) + 1024).astype(np.int16),
                        instance_number=z + 1, slice_location=1.25 * z,
                        image_position=(0.0, 0.0, 1.25 * z),
                        pixel_spacing=(0.7, 0.7), rescale_slope=1.0,
                        rescale_intercept=-1024.0, window=(40.0, 400.0))
        fn_v = compile_pipeline(cfg5, batched=True, device=dev)
        want_v = fn_v(torch.from_numpy(ct).to(dev)).cpu().numpy()
        t0 = time.perf_counter()
        enhance_volume_stream(series, cfg5, tmp / "series_out", slab_size=slab,
                              device=dev)
        series_s = time.perf_counter() - t0
        back, _ = load_volume(tmp / "series_out")
        _require(np.array_equal(back, want_v.astype(np.int16)),
                 "DICOM series stream: slices out of order or not equal to "
                 "compile_pipeline on the ordered volume")
        ct_cfg = load_config(repo / "configs" / "ct_soft_tissue.yaml")
        paths = sorted(series.glob("*.dcm"))
        _build.reset_launches()
        t0 = time.perf_counter()
        m = enhance_batch(paths, ct_cfg, tmp / "batch_out", progress=False,
                          device=dev)
        torch.cuda.synchronize(dev)
        batch_s = time.perf_counter() - t0
        batch_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        _require(m.done_count == 64 and not m.failures,
                 f"enhance_batch: {m.done_count} done, {m.failures}")
        outs = sorted((tmp / "batch_out").glob("*.dcm"))
        _require(len(outs) == 64, f"enhance_batch wrote {len(outs)} files")
        lines = (tmp / "batch_out" / "manifest.jsonl").read_text().splitlines()
        m2 = enhance_batch(paths, ct_cfg, tmp / "batch_out", progress=False,
                           device=dev)
        _require(m2.done_count == 64 and (tmp / "batch_out" / "manifest.jsonl")
                 .read_text().splitlines() == lines,
                 "the resumed enhance_batch processed files again")
        _require(RunManifest(tmp / "batch_out" / "manifest.jsonl",
                             ct_cfg.cache_key()).done_count == 64,
                 "manifest does not record 64 done")
        fn_ct = compile_pipeline(ct_cfg, batched=True, device=dev)
        from mies_tpu_torch.io.image import load_image

        raw = np.stack([load_image(p, dtype="raw") for p in paths])
        want_ct = fn_ct(torch.from_numpy(raw).to(dev)).cpu().numpy()
        got_ct = np.stack([load_image(tmp / "batch_out" / p.name, dtype="raw")
                           for p in paths])
        _require(np.array_equal(got_ct, want_ct),
                 "enhance_batch outputs differ from compile_pipeline")
        one = enhance_image(paths[7], ct_cfg, tmp / "one.dcm", device=dev)
        _require(np.array_equal(one, want_ct[7]),
                 "enhance_image differs from the batch")
        hdr = read_dicom_header(paths[0])
        print(f"files DICOM: 64-slice series (files shuffled) -> DICOM "
              f"directory in {series_s:.3f} s, slices in position order, "
              f"equal to compile_pipeline | enhance_batch ct_soft_tissue "
              f"64 files in {batch_s:.3f} s ({64 / batch_s:.1f} files/s), "
              f"launches {batch_launches}, manifest 64 done, resumed run "
              f"processed 0 | enhance_image equal | window in the header "
              f"{hdr.get('window_center')}/{hdr.get('window_width')} | {card}")

        # -- the command line, in subprocesses ----------------------------
        save_volume(tmp / "v64.nc", ct)
        cfg5.save(tmp / "w5.json")
        env = {**os.environ, "PYTHONPATH": str(repo)}
        cmds = {
            "stream": ["enhance-volume", str(tmp / "v64.nc"), "-c",
                       str(tmp / "w5.json"), "-o", str(tmp / "cli_stream.nc"),
                       "--stream", "-q"],
            "3d": ["enhance-volume", str(tmp / "v64.nc"), "-c",
                   str(repo / "configs" / "ct_volume_3d.yaml"), "-o",
                   str(tmp / "cli_3d.nc"), "--mode", "3d"],
        }
        cli_s = {}
        for name, args in cmds.items():
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "mies_tpu_torch", *args],
                                  capture_output=True, text=True, env=env,
                                  cwd=repo, timeout=300)
            cli_s[name] = time.perf_counter() - t0
            _require(proc.returncode == 0,
                     f"CLI {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        enhance_volume_stream(tmp / "v64.nc", cfg5, tmp / "in_stream.nc",
                              slab_size=slab, device=dev)
        _require((tmp / "cli_stream.nc").read_bytes()
                 == (tmp / "in_stream.nc").read_bytes(),
                 "CLI --stream output differs from enhance_volume_stream")
        _build.reset_launches()
        want3 = compile_volume_pipeline(
            load_config(repo / "configs" / "ct_volume_3d.yaml"), device=dev)(
            torch.from_numpy(ct).to(dev)).cpu().numpy()
        _require(_build.LAUNCHES["clahe3d_apply"] == 1, "K8 did not run")
        got3, _ = load_volume(tmp / "cli_3d.nc")
        _require(np.array_equal(got3, want3),
                 "CLI --mode 3d output differs from compile_volume_pipeline")
        print(f"files CLI: python -m mies_tpu_torch enhance-volume --stream "
              f"(64 slices) exit 0 in {cli_s['stream']:.1f} s, output equal to "
              f"enhance_volume_stream; --mode 3d ct_volume_3d.yaml exit 0 in "
              f"{cli_s['3d']:.1f} s, equal to compile_volume_pipeline (K8 once) "
              f"| {card}")


# Phase 7's op-by-op list: every op of the volume registry that is not in
# the CT volume config (clahe3d, gaussian_blur3d, window_hu), at its
# defaults on the windowed [256, 512, 512] phantom but where a required or
# a scale parameter is given; and the card-vs-CPU bound of each, the CPU
# tests' (tests/test_torch_volume_*.py): 0 where they hold the op bit-equal,
# the libm, reduction-order and FFT gaps elsewhere. hessian3d at gamma 15 is
# frangi's knife edge (checked as phase 4 checks hessian).
VOLUME_OPS = (
    ("adjust_gamma", {"gamma": 0.8}, 1e-6),
    ("adjust_log", {}, 1e-6),
    ("adjust_sigmoid", {}, 1e-6),
    ("invert", {}, 0.0),
    ("normalize", {}, 0.0),
    ("rescale_intensity", {}, 0.0),
    ("equalize_hist", {}, 0.0),
    ("normalize_meanstd", {}, 0.0),
    ("denormalize_meanstd", {}, 0.0),
    ("guided_blur3d", {}, 0.0),
    ("median_blur3d", {}, 0.0),
    ("unsharp_mask3d", {}, 0.0),
    ("erode3d", {}, 0.0),
    ("dilate3d", {}, 0.0),
    ("morph_open3d", {}, 0.0),
    ("morph_close3d", {}, 0.0),
    ("morph_gradient3d", {}, 0.0),
    ("top_hat3d", {"kernel_size": 5}, 0.0),
    ("black_hat3d", {"kernel_size": 5}, 0.0),
    ("resample3d", {"depth": 320, "height": 358, "width": 358}, 1e-6),
    ("difference_of_gaussians3d", {}, 0.0),
    ("denoise_nl_means3d", {}, 2e-6),
    ("denoise_tv3d", {}, 2e-6),
    ("wiener3d", {}, 2e-5),
    ("anisotropic_diffusion3d", {"kappa": 0.1}, 1e-6),
    ("srad3d", {}, 1e-6),
    ("frangi3d", {}, 2e-6),
    ("vessel_enhance3d", {}, 2e-6),
    ("sato3d", {}, 5e-6),
    ("meijering3d", {}, 5e-6),
    ("hessian3d", {}, 1e-5),
    ("butterworth3d", {}, 2e-5),
    ("homomorphic3d", {}, 2e-5),
    ("denoise_wavelet3d", {}, 2e-6),
)
CT3D_STAGES = (
    ("window_hu", {"center": 40.0, "width": 400.0}),
    ("median_blur3d", {"kernel_size": 3}),
    ("denoise_tv3d", {"weight": 0.03, "max_num_iter": 60}),
    ("clahe3d", {"clip_limit": 2.0, "grid_size": (4, 8, 8),
                 "convention": "opencv"}),
    ("unsharp_mask3d", {"radius": 1.0, "amount": 0.5}),
)


def _volume_ops_phase(dev: torch.device, card: str, repo: Path) -> dict:
    """Phase 7: the volume registry at full width. (a) The 3-D low-dose CT
    chain on the int16 [256, 512, 512] phantom through
    compile_volume_pipeline: K1 and K8 once a call and no other kernel,
    equal to the same chain with the plain clahe3d on the card, within 1
    level on < 1e-3 of voxels of the CPU plain chain at [32, 512, 512],
    z-slices/s (time_volume), device time by op and the busy share
    (profile_volume), peak device memory. (b) Every other volume op once at
    [256, 512, 512] on the windowed phantom: device ms (CUDA events), peak
    memory (each under 40 GiB), finite, and its card output on a
    [16, 64, 96] and a [12, 67, 93] crop against the CPU's. (c) `python -m
    mies_tpu_torch enhance-volume --mode 3d --isotropic 1.0` on a 64-slice
    DICOM series, 2.5 mm apart with 0.7 mm pixels, exit 0 and equal to the
    in-process call. Returns chain (a)'s launch counts."""
    from mies_tpu_torch.io.dicom import write_dicom
    from mies_tpu_torch.io.volume import load_volume
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.ops import restoration as R
    from mies_tpu_torch.ops import volume3d as V
    from mies_tpu_torch.pipeline.compiler import (
        _quantize_u8,
        _volume_registry,
        compile_volume_pipeline,
    )
    from mies_tpu_torch.pipeline.config import PipelineConfig
    from mies_tpu_torch.pipeline.runner import profile_volume, time_volume

    gib = 2**30
    hu = _ct_volume(256, SIZE, SIZE, 11, dev)

    def close(out, ref, what):
        d = (out.int() - ref.int()).abs()
        n = int((d > 0).sum().item())
        _require(d.max().item() <= 1 and n < 1e-3 * d.numel(),
                 f"{what}: {n} voxels differ (max {d.max().item()} levels)")
        return n, d.numel()

    def peak_of(fn):
        """(result, the call's own peak device memory in bytes)."""
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, torch.cuda.max_memory_allocated(dev) - base

    # -- (a) the 3-D low-dose CT chain -----------------------------------
    cfg = PipelineConfig.make(list(CT3D_STAGES), name="ct-lowdose-3d")
    fn = compile_volume_pipeline(cfg, device=dev)
    fn(hu)  # the first call allocates; count and measure the second
    _build.reset_launches()
    out, peak = peak_of(lambda: fn(hu))
    launches = dict(_build.LAUNCHES)
    want = {k: int(k in ("tile_hists", "clahe3d_apply")) for k in launches}
    _require(launches == want, f"CT 3-D chain launches {launches}, want {want}")
    _require(out.shape == hu.shape and out.dtype == torch.uint8,
             f"CT 3-D chain output {tuple(out.shape)} {out.dtype}")
    _require(peak < 40 * gib, f"CT 3-D chain peak {peak / gib:.2f} GiB")
    reg = {**_volume_registry(), "clahe3d": V.clahe3d}

    def plain(vol):
        y = vol
        for s in cfg.stages:
            y = reg[s.op](y, **s.kwargs())
        return _quantize_u8(y)

    _build.reset_launches()
    ref = plain(hu)
    torch.cuda.synchronize(dev)
    _require(not any(_build.LAUNCHES.values()),
             f"the plain CT 3-D chain launched {dict(_build.LAUNCHES)}")
    n_plain, total = close(out, ref, "CT 3-D chain vs the plain chain on the card")
    crop = hu[112:144].contiguous()
    t0 = time.perf_counter()
    cpu = compile_volume_pipeline(cfg, device="cpu")(crop.cpu())
    cpu_s = time.perf_counter() - t0
    n_cpu, total_cpu = close(fn(crop).cpu(), cpu, "CT 3-D chain card vs CPU")
    tv = time_volume(cfg, iters=3, warmup=1, repeats=2, device=dev, vol=hu)
    prof = profile_volume(cfg, iters=2, device=dev, vol=hu)
    # where the time goes: each stage alone (CUDA events), TV's steps
    card_reg = _volume_registry()
    stage_ms, y, steps = [], hu, None
    for s in cfg.stages:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if s.op == "denoise_tv3d":
            y, steps = R.tv_chambolle3d(y, **{"eps": 2e-4, **s.kwargs()})
        else:
            y = card_reg[s.op](y, **s.kwargs())
        end.record()
        end.synchronize()
        stage_ms.append((s.op, start.elapsed_time(end)))
    _require(torch.equal(_quantize_u8(y), out), "the stages in a row differ "
             "from the chain")
    hand = {k: v for k, v in prof["by_kernel"].items()
            if "clahe3d_apply" in k or "tile_hists" in k}
    top = list(prof["by_op"].items())[:6]
    print(f"volume CT 3-D chain (int16 [256,{SIZE},{SIZE}]: window_hu -> "
          f"median_blur3d k3 -> denoise_tv3d w0.03 <= 60 -> clahe3d opencv "
          f"(4,8,8) -> unsharp_mask3d r1 a0.5 -> uint8): "
          f"{tv['z_slices_per_sec']:.1f} z-slices/s ({tv['ms_per_volume']:.2f} "
          f"ms a volume) | device {prof['device_ms_per_call']:.2f} ms, "
          f"{prof['device_launches_per_call']:g} launches, busy "
          f"{prof['busy_share']:.1%} | by op: "
          + ", ".join(f"{k} {v:.2f}" for k, v in top)
          + " | stages alone: " + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms)
          + f" ms (TV {steps} steps) | hand kernels: "
          + ", ".join(f"{k} {v:.4f}" for k, v in hand.items())
          + f" | launches {({k: v for k, v in launches.items() if v})} | peak "
          f"{peak / gib:.2f} GiB | vs the plain chain on the card {n_plain} of "
          f"{total} voxels differ | [32,{SIZE},{SIZE}] vs the CPU plain chain "
          f"({cpu_s:.1f} s there) {n_cpu} of {total_cpu} voxels differ | {card}")
    del out, ref, cpu

    # -- (b) every volume op once at full width --------------------------
    x = _volume_registry()["window_hu"](hu, center=40.0, width=400.0)
    reg = _volume_registry()
    crops = ((slice(120, 136), slice(224, 288), slice(208, 304)),
             (slice(90, 102), slice(300, 367), slice(101, 194)))
    rows = []
    for op, kw, tol in VOLUME_OPS:
        f = reg[op]
        out, peak = peak_of(lambda: f(x, **kw))
        _require(bool(torch.isfinite(out).all()), f"{op}: not finite")
        _require(peak < 40 * gib, f"{op}: peak {peak / gib:.2f} GiB")
        del out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f(x, **kw)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms < 100.0:  # a short op: the mean of 5 more calls
            start.record()
            for _ in range(5):
                f(x, **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 5
        errs, knife = [], 0
        for c in crops:
            ckw = ({"depth": 20, "height": 80, "width": 120}
                   if op == "resample3d" else kw)
            xc = x[c].contiguous()
            got, want = f(xc, **ckw).cpu(), f(xc.cpu(), **ckw)
            d = (got - want).abs()
            off = d > tol
            if op == "hessian3d":  # 1.0 on one side, ~0 on the other
                a, b = got[off], want[off]
                _require(bool((((a == 1.0) & (b.abs() <= 2e-6))
                               | ((b == 1.0) & (a.abs() <= 2e-6))).all()),
                         "hessian3d: card and CPU differ off the knife edge")
                knife += int(off.sum())
                d = d[~off]
            else:
                _require(not bool(off.any()), f"{op} {list(xc.shape)}: card "
                         f"vs CPU max abs {d.max().item():.3g} > {tol}")
            errs.append(d.max().item() if d.numel() else 0.0)
        rows.append((op, ms, peak, max(errs), knife))
    rows.sort(key=lambda r: -r[1])
    print(f"volume ops at [256,{SIZE},{SIZE}] (windowed CT phantom; device "
          f"ms by CUDA events, own peak memory GiB, card vs CPU max abs on "
          f"[16,64,96] and [12,67,93] crops): " + "; ".join(
              f"{op} {ms:.2f} ms {peak / gib:.2f} GiB {err:.2g}"
              + (f" ({kn} knife-edge voxels)" if kn else "")
              for op, ms, peak, err, kn in rows) + f" | {card}")
    del x

    # -- (c) --isotropic through the command line ------------------------
    ct = _ct_volume(64, SIZE, SIZE, 12, dev).cpu().numpy()
    iso_cfg = PipelineConfig.make(
        [("window_hu", {"center": 40.0, "width": 400.0}),
         ("median_blur3d", {}), ("unsharp_mask3d", {"amount": 0.5})],
        name="ct-iso")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        series = tmp / "series"
        series.mkdir()
        for k in range(64):
            write_dicom(series / f"im{k:03d}.dcm", ct[k], instance_number=k + 1,
                        slice_location=2.5 * k,
                        image_position=(0.0, 0.0, 2.5 * k),
                        pixel_spacing=(0.7, 0.7))
        iso_cfg.save(tmp / "iso.json")
        env = {**os.environ, "PYTHONPATH": str(repo)}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mies_tpu_torch", "enhance-volume",
             str(series), "-c", str(tmp / "iso.json"), "-o",
             str(tmp / "iso.nc"), "--mode", "3d", "--isotropic", "1.0"],
            capture_output=True, text=True, env=env, cwd=repo, timeout=300)
        cli_s = time.perf_counter() - t0
        _require(proc.returncode == 0,
                 f"CLI --isotropic exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        vol, meta = load_volume(series)
        dims = [max(1, round(n * s / 1.0)) for n, s in zip(vol.shape,
                                                           meta.spacing)]
        want3 = compile_volume_pipeline(PipelineConfig.make(
            [("resample3d", dict(zip(("depth", "height", "width"), dims))),
             *iso_cfg.stages]), device=dev)(vol).cpu().numpy()
        got3, _ = load_volume(tmp / "iso.nc")
        _require(list(got3.shape) == dims == [160, 358, 358],
                 f"CLI --isotropic output {got3.shape}, want {dims}")
        _require(np.array_equal(got3, want3),
                 "CLI --isotropic output differs from the in-process call")
    print(f"volume CLI: python -m mies_tpu_torch enhance-volume --mode 3d "
          f"--isotropic 1.0 on 64 x {SIZE}^2 slices at (2.5, 0.7, 0.7) mm exit 0 "
          f"in {cli_s:.1f} s, output {dims} equal to the in-process "
          f"resample3d -> chain | TF32 off: "
          f"{not torch.backends.cuda.matmul.allow_tf32} | {card}")
    _require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    return launches


def _zshard_phase(dev: torch.device, card: str, repo: Path,
                  record) -> tuple[dict, dict]:
    """Phase 8: the z-sharded volume path. (a) K8z on the windowed int16
    [256, 512, 512] CT phantom of phase 7 with its K1 LUTs at grid (4, 8,
    8), in both epilogues: the volume split into n = 2 and 4 tile-aligned z
    bands, each band's K8z bit-equal to the plain K8z, the bands
    concatenated bit-equal to K8 on the whole volume; the device ms of each
    band's launch and the bound (8 B a voxel at 3.35 TB/s). (b) The shipped
    configs/ct_volume_3d.yaml through volume_shard_apply on an NCCL world
    of one, int16 [512, 512, 512] (w5's size): K1 and K8z once a call and
    no other kernel, bit-equal to compile_volume_pipeline, both event-timed
    per volume, the device ms, launches and busy share (profiler) and the
    peak device memory of each; a clahe3d fraction config through it at
    [32, 512, 512] (K8z clip01). (c) `python -m mies_tpu_torch
    enhance-volume --data-parallel` in subprocesses on a 512^3 .nc in
    --mode 3d and in slice mode (w5's chain, slab 16), and on phase 7's
    64-slice DICOM series with --isotropic 1.0: exit 0 and each output file
    equal to the one written without the flag. Returns the launch counts
    of (b)'s two runs."""
    from mies_tpu_torch.io.dicom import write_dicom
    from mies_tpu_torch.io.volume import save_volume
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.kernels import clahe as KC
    from mies_tpu_torch.kernels import clahe3d as K3D
    from mies_tpu_torch.ops import intensity as I
    from mies_tpu_torch.ops import volume3d as V
    from mies_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        volume_shard_apply,
    )
    from mies_tpu_torch.pipeline.compiler import compile_volume_pipeline
    from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
    from mies_tpu_torch.pipeline.presets import flagship_volume_config
    from mies_tpu_torch.pipeline.runner import _profile

    gib = 2**30
    grid = (4, 8, 8)
    # -- (a) K8z at every band of a 2- and a 4-way z split ------------------
    ctw = I.window_hu(_ct_volume(256, SIZE, SIZE, 11, dev), 40.0,
                      400.0).contiguous()
    z_total = ctw.shape[0]
    tz = z_total // grid[0]
    hists = KC.tile_hists(ctw, grid[1:]).reshape(grid[0], tz, -1, 256).sum(
        1, dtype=torch.int32).float()
    tile_vox = tz * (SIZE // grid[1]) * (SIZE // grid[2])
    nvox = ctw.numel()
    band_ms = {}
    for key, conv, clip, fin, ops in (("K8z", "opencv", 2.0, "u8norm", 51),
                                      ("K8zc", "fraction", 0.01, "clip01",
                                       49)):
        luts = V.luts_3d(hists, clip, tile_vox, conv).reshape(*grid, 256)
        whole = K3D.clahe3d_apply_lut(ctw, luts, grid, fin)
        for n in (2, 4):
            zb = z_total // n
            bands = [ctw[i * zb:(i + 1) * zb].contiguous() for i in range(n)]
            outs, errs = [], []
            for i, band in enumerate(bands):
                got = K3D.clahe3d_apply_lut_band(band, luts, grid, z_total,
                                                 i * zb, fin)
                want = K3D.clahe3d_apply_lut_band_plain(band, luts, grid,
                                                        z_total, i * zb, fin)
                errs.append((got - want).abs().max().item())
                _require(torch.equal(got, want),
                         f"{key} band {i} of {n} differs from the plain K8z "
                         f"by up to {errs[-1]}")
                outs.append(got)
                band_ms[(key, n, i)] = _ms(
                    lambda b=band, i=i: K3D.clahe3d_apply_lut_band(
                        b, luts, grid, z_total, i * zb, fin))
            _require(torch.equal(torch.cat(outs), whole),
                     f"{key}: the {n} bands differ from K8 on the volume")
            if n == 4:
                # the record: the 4 bands' launches together, the whole
                # volume's work (each voxel read and written once)
                def all_bands(fn, bands=bands, zb=zb, luts=luts, fin=fin):
                    for i, b in enumerate(bands):
                        fn(b, luts, grid, z_total, i * zb, fin)
                record(key, max(errs),
                       lambda: all_bands(K3D.clahe3d_apply_lut_band),
                       lambda: all_bands(K3D.clahe3d_apply_lut_band_plain),
                       8 * nvox + 4 * luts.numel(), ops * nvox, plain_iters=2,
                       at=f"[{z_total},{SIZE},{SIZE}] in 4 bands")
        del whole
    bound_ms = {n: _bound(8 * nvox / n, 0)[0] for n in (2, 4)}
    print("K8z ms per band launch (CUDA events; the windowed int16 "
          f"[{z_total},{SIZE},{SIZE}] CT phantom, grid {grid}; each band "
          "bit-equal to the plain K8z, the bands concatenated bit-equal to "
          "K8): " + "; ".join(
              f"{key} n={n}: " + ", ".join(
                  f"{band_ms[(key, n, i)]:.4f}" for i in range(n))
              + f" (bound {bound_ms[n]:.4f} a band)"
              for key in ("K8z", "K8zc") for n in (2, 4)) + f" | {card}")
    del ctw, hists

    # -- (b) ct_volume_3d.yaml z-sharded at world 1, 512^3 ---------------
    ctv_cfg = load_config(repo / "configs" / "ct_volume_3d.yaml")
    hu = _ct_volume(512, SIZE, SIZE, 21, dev)
    fr_cfg = PipelineConfig.make(
        [("clahe3d", {"clip_limit": 0.01, "grid_size": grid,
                      "convention": "fraction"})], name="clahe3d-fraction")
    fr_vol = torch.from_numpy(_xray_batch(BATCH, SIZE, SIZE, seed=8)).to(dev)
    want_launches = {"tile_hists": 1, "clahe3d_apply_band": 1}

    def peak_of(fn):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, torch.cuda.max_memory_allocated(dev) - base

    with tempfile.TemporaryDirectory() as store:
        init_distributed(f"file://{store}/store", 1, 0, device="cuda")
        try:
            mesh = make_mesh(1, 1)
            runs = {}
            for name, cfg, vol in (("ct_volume_3d", ctv_cfg, hu),
                                   ("clahe3d fraction", fr_cfg, fr_vol)):
                fn = volume_shard_apply(cfg, mesh)
                ref_fn = compile_volume_pipeline(cfg)
                fn(vol)  # the first call allocates; count the second
                _build.reset_launches()
                out, peak = peak_of(lambda: fn(vol))
                counts = dict(_build.LAUNCHES)
                expect = {k: want_launches.get(k, 0) for k in counts}
                _require(counts == expect,
                         f"z-sharded {name}: launches {counts}, want {expect}")
                ref, peak_ref = peak_of(lambda: ref_fn(vol))
                _require(out.dtype == torch.uint8 and torch.equal(out, ref),
                         f"z-sharded {name} differs from compile_volume_pipeline")
                del out, ref
                runs[name] = (counts, peak, peak_ref,
                              _profile(fn, vol, 5, dev),
                              _profile(ref_fn, vol, 5, dev))
        finally:
            dist.destroy_process_group()
    for name, (counts, peak, peak_ref, prof, prof_ref) in runs.items():
        shp = list((hu if name == "ct_volume_3d" else fr_vol).shape)
        print(f"z-sharded {name} {shp} (volume_shard_apply, NCCL, world 1): "
              f"launches { {k: v for k, v in counts.items() if v} } | == "
              f"compile_volume_pipeline | {prof['ms_per_call']:.4f} ms a "
              f"volume (compile_volume_pipeline {prof_ref['ms_per_call']:.4f}"
              f") | device {prof['device_ms_per_call']:.4f} ms "
              f"({prof_ref['device_ms_per_call']:.4f}), "
              f"{prof['device_launches_per_call']:g} launches "
              f"({prof_ref['device_launches_per_call']:g}), busy "
              f"{prof['busy_share']:.1%} ({prof_ref['busy_share']:.1%}) | peak "
              f"{peak / gib:.2f} GiB ({peak_ref / gib:.2f}) | top ms: "
              + "; ".join(f"{k[:40]} {v:.4f}" for k, v in
                          list(prof["by_kernel"].items())[:6])
              + f" | {card}")
    ct_counts, fr_counts = runs["ct_volume_3d"][0], runs["clahe3d fraction"][0]
    del runs, fr_vol

    # -- (c) enhance-volume --data-parallel in subprocesses --------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_volume(tmp / "ct.nc", hu.cpu().numpy(), var_name="hu")
        del hu
        flagship_volume_config().save(tmp / "w5.json")
        iso_cfg = PipelineConfig.make(
            [("window_hu", {"center": 40.0, "width": 400.0}),
             ("median_blur3d", {}), ("unsharp_mask3d", {"amount": 0.5})],
            name="ct-iso")
        iso_cfg.save(tmp / "iso.json")
        series = tmp / "series"
        series.mkdir()
        ct = _ct_volume(64, SIZE, SIZE, 12, dev).cpu().numpy()
        for k in range(64):
            write_dicom(series / f"im{k:03d}.dcm", ct[k], instance_number=k + 1,
                        slice_location=2.5 * k,
                        image_position=(0.0, 0.0, 2.5 * k),
                        pixel_spacing=(0.7, 0.7))
        cases = {
            "3d": [str(tmp / "ct.nc"), "-c",
                   str(repo / "configs" / "ct_volume_3d.yaml"), "--mode", "3d"],
            "slices": [str(tmp / "ct.nc"), "-c", str(tmp / "w5.json"),
                       "--slab", "16"],
            "isotropic": [str(series), "-c", str(tmp / "iso.json"), "--mode",
                          "3d", "--isotropic", "1.0"],
        }
        env = {**os.environ, "PYTHONPATH": str(repo)}
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(var, None)
        procs = {}
        for name, args in cases.items():
            for flag in ("", "--data-parallel"):
                cmd = [sys.executable, "-m", "mies_tpu_torch", "enhance-volume",
                       *args, "-o", str(tmp / f"{name}{flag}.nc"), "-q",
                       *([flag] if flag else [])]
                procs[(name, flag)] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=env, cwd=repo)
        try:
            for (name, flag), proc in procs.items():
                out, err = proc.communicate(timeout=600)
                _require(proc.returncode == 0,
                         f"CLI {name} {flag} exited {proc.returncode}: "
                         f"{err[-2000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        sizes = {}
        for name in cases:
            a = (tmp / f"{name}.nc").read_bytes()
            b = (tmp / f"{name}--data-parallel.nc").read_bytes()
            _require(a == b, f"CLI {name}: the --data-parallel output differs "
                     f"from the one without it")
            sizes[name] = len(a)
    print(f"CLI enhance-volume --data-parallel (NCCL, world 1) in --mode 3d "
          f"(ct_volume_3d.yaml, int16 512^3 .nc), slice mode (w5's chain, slab "
          f"16) and --isotropic 1.0 (64 x {SIZE}^2 DICOM series at (2.5, 0.7, "
          f"0.7) mm): 6 subprocesses exit 0 in {time.perf_counter() - t0:.1f} "
          f"s, each output file equal to the one without the flag ("
          + ", ".join(f"{k} {v} B" for k, v in sizes.items()) + f") | {card}")
    return ct_counts, fr_counts


# Phase 9's op-by-op list: every op of the 2-D registry's rest that chains
# (a) and (b) do not run, at the reference's defaults (a required parameter
# given), with the card-vs-CPU bound of the CPU tests (tests/test_torch_
# edges.py, _geometry.py, _background.py): 0 where the port is exact in any
# order (shifted adds, min/max, gathers, a correctly rounded root), the
# conv2d and matmul reduction orders and 30 iterations of Richardson-Lucy
# elsewhere. Each entry: op, its parameters at [32, 512, 512], at the crops.
_RESIZE_FULL, _RESIZE_CROP = {"height": 384, "width": 640}, {"height": 48,
                                                             "width": 120}
REGISTRY2D_OPS = (
    ("sobel_edges", {}, None, 0.0),
    ("scharr_edges", {}, None, 0.0),
    ("prewitt_edges", {}, None, 0.0),
    ("farid_edges", {}, None, 0.0),
    ("roberts_edges", {}, None, 0.0),
    ("laplace", {}, None, 0.0),
    ("laplacian_sharpen", {}, None, 0.0),
    ("difference_of_gaussians", {}, None, 0.0),
    ("gabor", {}, None, 2e-6),
    ("gabor_bank", {}, None, 2e-6),
    ("motion_blur", {}, None, 2e-6),
    ("kuwahara", {}, None, 0.0),
    ("box_blur", {}, None, 0.0),
    ("richardson_lucy", {}, None, 2e-6),
    ("subtract_background", {}, None, 0.0),
    ("subtract_background", {"downscale": 1}, None, 0.0),
    ("flip", {}, None, 0.0),
    ("rot90", {}, None, 0.0),
    ("affine_warp", {"matrix": [[0.95, 0.1], [-0.08, 1.05]],
                     "offset": [12.0, -20.0]}, None, 0.0),
    ("perspective_warp", {"matrix": [[1.0, 0.04, 3.0], [0.02, 1.0, -5.0],
                                     [4e-5, 2e-5, 1.0]]}, None, 0.0),
    *(("resize", {**_RESIZE_FULL, "method": m}, {**_RESIZE_CROP, "method": m},
       0.0 if m == "nearest" else 2e-6)
      for m in ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")),
    ("histogram_match", None, None, 0.0),
)
CHAIN_A = (
    ("retinex", {"sigmas": [2.0, 8.0, 30.0], "rescale": "clip"}),
    ("denoise_bilateral", {"sigma_color": 0.1, "sigma_spatial": 1.0}),
    ("clahe", {"clip_limit": 2.0, "grid_size": [8, 8], "convention": "opencv"}),
    ("unsharp_mask", {"radius": 1.5}),
)
CHAIN_B = (
    ("resize", {"height": 512, "width": 512, "method": "bilinear",
                "antialias": True}),
    ("rotate", {"angle": 7.0, "mode": "constant"}),
    ("center_crop", {"height": 480, "width": 480}),
    ("canny", {"sigma": 1.0}),
)
SHARDED_9 = (("sobel_edges", {}), ("kuwahara", {}),
             ("subtract_background", {"downscale": 1}))
CHAIN_B_BATCH, CHAIN_B_SIZE, SHARDED_9_SIZE = 8, 1024, 4096


def _registry2d_phase(dev: torch.device, card: str, record, rec: dict) -> dict:
    """Phase 9: the rest of the 2-D registry. (a) Chain (a) on b32 512^2
    X-ray phantoms, retinex (sigma 2, 8, 30, clip) -> denoise_bilateral
    (sigma_color 0.1, sigma_spatial 1: K3 at k 7, 'edge') -> clahe opencv
    8x8 clip 2 (K1 to the LUTs, K2) -> unsharp_mask r 1.5 -> uint8 (K4):
    K1L, K2, K3 and K4 once a call and no other kernel, bit-equal to the
    chain's plain stages around K3's output; against the all-plain chain on
    the card K3's 2e-6 moves < 1e-4 of the pixels (a CLAHE input level
    flips, and its LUT step may be several levels wide); on 4 slices
    retinex within 1e-6 and K3 within 2e-6 of the CPU's, which moves < 1e-3
    of the uint8 pixels, slices/s (time_pipeline), device ms
    by op, launches and busy share (profile_pipeline); K3 at its k 7 'edge'
    call on chain (a)'s retinex output against the plain filter (the
    kernels line's row). (b) Chain (b) on b8 1024^2: resize 512 bilinear
    antialias -> rotate 7 -> center_crop 480 -> canny sigma 1 -> uint8, no
    hand kernel, card against the CPU plain chain on 4 slices (an edge map:
    < 1e-3 of pixels differ), the same figures and Canny's hysteresis
    steps. (c) Every other new op once at b32 512^2: device ms (CUDA
    events), finite, card against CPU on a [2, 64, 96] and a [2, 67, 93]
    crop within the CPU tests' bounds; retinex and subtract_background's
    launches a call (torch.profiler); TF32 off. (d) sobel_edges ->
    kuwahara -> subtract_background (downscale 1) row-sharded through
    spatial_shard_apply on an NCCL world of one at 4096^2, equal to
    compile_pipeline. Returns chain (a)'s launch counts."""
    from mies_tpu_torch.io.dicom import write_dicom
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.kernels import bilateral as KB
    from mies_tpu_torch.ops import feature as FT
    from mies_tpu_torch.ops import filters as F
    from mies_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        spatial_shard_apply,
    )
    from mies_tpu_torch.pipeline.compiler import (
        OP_REGISTRY,
        STAGE_BUILDERS,
        _ingest,
        _quantize_u8,
        compile_pipeline,
    )
    from mies_tpu_torch.pipeline.config import PipelineConfig
    from mies_tpu_torch.pipeline.runner import (
        _profile,
        profile_pipeline,
        time_pipeline,
    )

    def close(out, ref, what, frac=1e-3, levels=1):
        d = (out.int() - ref.int()).abs()
        n = int((d > 0).sum().item())
        _require(d.max().item() <= levels and n < frac * d.numel(),
                 f"{what}: {n} pixels differ (max {d.max().item()} levels)")
        return n, d.numel()

    def plain_chain(stages, x):
        y = _ingest(x)
        for op, kw in stages:
            y = OP_REGISTRY[op](y, **kw)
        return _quantize_u8(y)

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms < 100.0:  # a short op: the mean of 5 more calls
            start.record()
            for _ in range(5):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 5
        return ms

    def summary(prof, n=6):
        return ", ".join(f"{k} {v:.3f}" for k, v in
                         list(prof["by_op"].items())[:n])

    # -- (a) retinex -> denoise_bilateral (K3) -> clahe -> unsharp -------
    xa = torch.from_numpy(_xray_batch(BATCH, SIZE, SIZE, seed=91)).to(dev)
    cfg_a = PipelineConfig.make(list(CHAIN_A), name="xray-retinex")
    fn_a = compile_pipeline(cfg_a, batched=True, device=dev)
    fn_a(xa)  # the first call allocates; count the second
    _build.reset_launches()
    out_a = fn_a(xa)
    torch.cuda.synchronize(dev)
    launches_a = dict(_build.LAUNCHES)
    want = {k: int(k in ("tile_luts", "clahe_apply_lut", "bilateral",
                         "unsharp_quant")) for k in launches_a}
    _require(launches_a == want, f"chain (a) launches {launches_a}, want {want}")
    _require(out_a.shape == xa.shape and out_a.dtype == torch.uint8,
             f"chain (a) output {tuple(out_a.shape)} {out_a.dtype}")
    # K1L, K2 and K4 are exact: the chain equals its plain stages around
    # K3's own output, bit for bit
    _build.reset_launches()
    y = _ingest(xa)
    for op, kw in CHAIN_A:
        y = (KB.denoise_bilateral_batched(y, **kw) if op == "denoise_bilateral"
             else OP_REGISTRY[op](y, **kw))
    _require(_build.LAUNCHES["bilateral"] == 1 and sum(
        _build.LAUNCHES.values()) == 1, f"K3 alone: {dict(_build.LAUNCHES)}")
    _require(torch.equal(_quantize_u8(y), out_a), "chain (a) differs from its "
             "plain stages around K3's output")
    # K3's 2e-6 lands on a level boundary of CLAHE's input now and then,
    # and CLAHE's LUT steps can be several levels wide: count those pixels
    _build.reset_launches()
    ref_a = plain_chain(CHAIN_A, xa)
    torch.cuda.synchronize(dev)
    _require(not any(_build.LAUNCHES.values()),
             f"chain (a)'s plain stages launched {dict(_build.LAUNCHES)}")
    n_plain_a, tot_a = close(out_a, ref_a, "chain (a) vs its plain stages",
                             frac=1e-4, levels=255)
    cpu_a = compile_pipeline(cfg_a, batched=True, device="cpu")(xa[:4].cpu())
    n_cpu_a, tot_cpu_a = close(out_a[:4].cpu(), cpu_a, "chain (a) card vs CPU",
                               frac=1e-3, levels=255)
    lv_plain = (out_a.int() - ref_a.int()).abs().max().item()
    lv_cpu = (out_a[:4].cpu().int() - cpu_a.int()).abs().max().item()
    t_a = time_pipeline(cfg_a, iters=5, warmup=1, repeats=3, device=dev,
                        batch=xa)
    p_a = profile_pipeline(cfg_a, iters=3, device=dev, batch=xa)
    ret = F.retinex(xa, sigmas=(2.0, 8.0, 30.0))
    k3 = KB.denoise_bilateral_batched(ret, 0.1, 1.0, "edge")
    k3_plain = F.denoise_bilateral(ret, 0.1, 1.0, "edge")
    err = (k3 - k3_plain).abs().max().item()
    _require(err <= 2e-6, f"K3 at denoise_bilateral k 7: max abs {err}")
    # the two float stages against the CPU at the CPU tests' bounds: the
    # logs of two libraries (1e-6), K3 on the card's retinex output (2e-6)
    ret_err = (ret[:4].cpu() - F.retinex(xa[:4].cpu(), sigmas=(2.0, 8.0, 30.0))
               ).abs().max().item()
    k3_cpu_err = (k3[:4].cpu() - F.denoise_bilateral(ret[:4].cpu(), 0.1, 1.0,
                                                     "edge")).abs().max().item()
    _require(ret_err <= 1e-6 and k3_cpu_err <= 2e-6, f"chain (a) card vs CPU: "
             f"retinex {ret_err:.3g}, K3 {k3_cpu_err:.3g}")
    npx = ret.numel()
    record("K3d", err, lambda: KB.denoise_bilateral_batched(ret, 0.1, 1.0,
                                                            "edge"),
           lambda: F.denoise_bilateral(ret, 0.1, 1.0, "edge"), 8 * npx,
           _bilateral_ops(7) * npx, plain_iters=3)
    ret_prof = _profile(lambda v: F.retinex(v, sigmas=(2.0, 8.0, 30.0)), xa,
                        2, dev)
    print(f"registry 2-D chain (a) [{BATCH},{SIZE},{SIZE}] float32 (retinex "
          f"2/8/30 clip -> denoise_bilateral k7 edge (K3) -> clahe opencv 8x8 "
          f"(K1L, K2) -> unsharp r1.5 + uint8 (K4)): "
          f"{t_a['slices_per_sec']:.1f} slices/s ({t_a['ms_per_batch']:.3f} ms "
          f"a batch) | device {p_a['device_ms_per_call']:.3f} ms, "
          f"{p_a['device_launches_per_call']:g} launches, busy "
          f"{p_a['busy_share']:.1%} | by op: {summary(p_a)} | retinex alone "
          f"{ret_prof['device_ms_per_call']:.3f} ms, "
          f"{ret_prof['device_launches_per_call']:g} launches | K3 (k7 edge) "
          f"{rec['K3d']['ms']:.4f} ms vs plain "
          f"{rec['K3d']['plain_ms']:.4f}, max abs {err:.3g} | launches "
          f"{ {k: v for k, v in launches_a.items() if v} } | == its plain "
          f"stages around K3's output | vs the plain K3 too {n_plain_a} of "
          f"{tot_a} differ (max {lv_plain} levels) | 4 slices vs CPU: "
          f"retinex max abs {ret_err:.3g}, K3 {k3_cpu_err:.3g}, uint8 "
          f"{n_cpu_a} of {tot_cpu_a} differ (max {lv_cpu}) | {card}")
    del out_a, ref_a, ret, k3, k3_plain, y

    # -- (b) resize -> rotate -> center_crop -> canny ---------------------
    xb = torch.from_numpy(_xray_batch(CHAIN_B_BATCH, CHAIN_B_SIZE,
                                      CHAIN_B_SIZE, seed=92)).to(dev)
    crop = CHAIN_B[2][1]
    cfg_b = PipelineConfig.make(list(CHAIN_B), name="xray-edges")
    fn_b = compile_pipeline(cfg_b, batched=True, device=dev)
    fn_b(xb)
    _build.reset_launches()
    out_b = fn_b(xb)
    torch.cuda.synchronize(dev)
    _require(not any(_build.LAUNCHES.values()),
             f"chain (b) launched {dict(_build.LAUNCHES)}")
    _require(tuple(out_b.shape) == (CHAIN_B_BATCH, crop["height"],
                                    crop["width"])
             and out_b.dtype == torch.uint8,
             f"chain (b) output {tuple(out_b.shape)} {out_b.dtype}")
    _require(torch.equal(out_b, plain_chain(CHAIN_B, xb)),
             "chain (b) differs from its stages in a row")
    cpu_b = compile_pipeline(cfg_b, batched=True, device="cpu")(xb[:4].cpu())
    n_cpu_b, tot_cpu_b = close(out_b[:4].cpu(), cpu_b, "chain (b) card vs CPU",
                               levels=255)
    t_b = time_pipeline(cfg_b, iters=5, warmup=1, repeats=3, device=dev,
                        batch=xb)
    p_b = profile_pipeline(cfg_b, iters=3, device=dev, batch=xb)
    pre = _ingest(xb)
    for op, kw in CHAIN_B[:-1]:
        pre = OP_REGISTRY[op](pre, **kw)
    edges, steps = FT.canny_with_steps(pre, sigma=1.0)
    _require(torch.equal(_quantize_u8(edges), out_b), "canny_with_steps "
             "differs from the chain's canny")
    print(f"registry 2-D chain (b) {list(xb.shape)} float32 (resize 512 bilinear "
          f"antialias -> rotate 7 -> center_crop 480 -> canny sigma 1 -> "
          f"uint8, no hand kernel): {t_b['slices_per_sec']:.1f} slices/s "
          f"({t_b['ms_per_batch']:.3f} ms a batch) | device "
          f"{p_b['device_ms_per_call']:.3f} ms, "
          f"{p_b['device_launches_per_call']:g} launches, busy "
          f"{p_b['busy_share']:.1%} | by op: {summary(p_b)} | Canny "
          f"hysteresis {steps} steps, {steps // FT.HYSTERESIS_CHECK_EVERY + 1} "
          f"host reads | 4 slices vs CPU {n_cpu_b} of {tot_cpu_b} differ "
          f"| {card}")
    del out_b, pre, edges

    # -- (c) every other new op once at b32 512^2 -------------------------
    crops = ((slice(0, 2), slice(100, 164), slice(200, 296)),
             (slice(2, 4), slice(300, 367), slice(50, 143)))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        ref_dcm = Path(tmp) / "ref.dcm"
        ref_img = np.clip(np.random.default_rng(93).normal(140, 40, (256, 256)),
                          0, 255).astype(np.uint8)  # read back as float [0, 1]
        write_dicom(ref_dcm, ref_img)
        for op, kw, ckw, tol in REGISTRY2D_OPS:
            if op == "histogram_match":
                f = STAGE_BUILDERS[op](reference=str(ref_dcm))
                kw = ckw = {}
            else:
                f = OP_REGISTRY[op]
            ckw = kw if ckw is None else ckw
            out = f(xa, **kw)
            _require(bool(torch.isfinite(out).all()), f"{op}: not finite")
            ms = event_ms(lambda: f(xa, **kw))
            errs = []
            for c in crops:
                xc = xa[c].contiguous()
                got, want_c = f(xc, **ckw).cpu(), f(xc.cpu(), **ckw)
                d = (got - want_c).abs().max().item()
                _require(got.shape == want_c.shape and d <= tol,
                         f"{op} {list(xc.shape)}: card vs CPU max abs {d:.3g} "
                         f"> {tol}")
                errs.append(d)
            tags = [f"{k}={v}" for k, v in kw.items()
                    if k in ("downscale", "method")]
            label = " ".join([op, *tags])
            rows.append((label, ms, max(errs)))
    sb_prof = _profile(lambda v: OP_REGISTRY["subtract_background"](v), xa, 2,
                       dev)
    sb1_prof = _profile(lambda v: OP_REGISTRY["subtract_background"](
        v, downscale=1), xa, 1, dev)
    rows.sort(key=lambda r: -r[1])
    print(f"registry 2-D ops at [{BATCH},{SIZE},{SIZE}] (device ms by CUDA "
          f"events, card vs CPU max abs on [2,64,96] and [2,67,93] crops): "
          + "; ".join(f"{op} {ms:.3f} ms {err:.2g}" for op, ms, err in rows)
          + f" | subtract_background launches a call: auto "
          f"{sb_prof['device_launches_per_call']:g} "
          f"({sb_prof['device_ms_per_call']:.3f} ms device), downscale 1 "
          f"{sb1_prof['device_launches_per_call']:g} "
          f"({sb1_prof['device_ms_per_call']:.3f} ms) | TF32 off: "
          f"{not torch.backends.cudnn.allow_tf32} | {card}")
    _require(not torch.backends.cudnn.allow_tf32
             and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

    # -- (d) the row-sharded chain at 4096^2 ------------------------------
    big = torch.from_numpy(_xray_batch(1, SHARDED_9_SIZE, SHARDED_9_SIZE,
                                       seed=94)[0]).to(dev)
    cfg_d = PipelineConfig.make(list(SHARDED_9), name="edges-background")
    with tempfile.TemporaryDirectory() as store:
        init_distributed(f"file://{store}/store", 1, 0, device=dev.type)
        try:
            fn_d = spatial_shard_apply(cfg_d, make_mesh(1, 1))
            ref_fn = compile_pipeline(cfg_d, device=dev)
            out_d = fn_d(big)
            _require(out_d.dtype == torch.uint8 and torch.equal(out_d,
                                                                ref_fn(big)),
                     "sharded sobel -> kuwahara -> subtract_background differs "
                     "from compile_pipeline")
            ms_d, ms_ref = _ms(lambda: fn_d(big), 1), _ms(lambda: ref_fn(big), 1)
        finally:
            dist.destroy_process_group()
    print(f"registry 2-D sharded (spatial_shard_apply, NCCL, world 1) "
          f"{list(big.shape)}: sobel_edges -> kuwahara -> subtract_background downscale 1 "
          f"== compile_pipeline | {ms_d:.2f} ms a slice (compile_pipeline "
          f"{ms_ref:.2f}) | {card}")
    return launches_a


# Phase 10's bounds of the card against the CPU for each metric: the CPU
# tests' (tests/test_torch_metrics.py): the same float32 adds in another
# reduction order, 5e-5 where a windowed variance cancels, sam's arccos
# near a ratio of 1.
METRIC_REL = {"ssim": 5e-5, "uqi": 5e-5, "scc": 5e-5, "vifp": 5e-5,
              "msssim": 5e-5}
METRIC_ABS = {"sam": 1e-3}
LEARNED_CHAIN = """name: learned-xray
pipeline:
  - {{op: learned_denoise, checkpoint: {ckpt}}}
  - {{op: clahe, clip_limit: 2.0, grid_size: [8, 8], convention: opencv}}
  - {{op: unsharp_mask, radius: 1.5, amount: 1.0}}
"""


def _eval_models_phase(dev: torch.device, card: str, repo: Path) -> dict:
    """Phase 10: the metric suite and the learned denoiser. (a) Every
    registry metric at b32 512^2 on the flagship's uint8 input and output
    (max_val 255), on the card against the CPU on 4 slices within the CPU
    tests' bounds, ms per evaluate call (all 13 metrics), launches, busy.
    (b) sharded_evaluate of configs/xray_clahe.yaml with psnr and ssim on
    an NCCL world of one: K1 to the LUTs, K2, K3, K4 once a call and no
    other kernel, the uint8 equal to compile_pipeline(batched=True), the
    means to the metrics of the float chain; slices/s beside the flagship
    alone, device ms by op, busy. (c) train_denoiser at the CLI's defaults
    (DnCNN 32 x 6, bfloat16, b32, patch 64, 500 synthetic steps,
    evaluate=True): the loss falls, psnr_model above psnr_noisy, steps/s
    (the loop and a step alone), peak memory; then U-Net (24, 2),
    Noise2Void, the mix loss and --augment --elastic 4 for 20 steps each.
    (d) learned_denoise (c's checkpoint) -> clahe opencv -> unsharp -> uint8
    at b32 512^2 through load_config / compile_pipeline(batched=True): K1
    to the LUTs, K2, K4 once a call, equal to the same chain with the plain
    CLAHE and tail on the card; on 4 slices the learned stage within the
    CPU tests' bf16 bound (8e-3) of the CPU's and < 2% of the uint8 pixels
    off the CPU chain's (CLAHE's LUT steps carry the bf16 gap);
    slices/s, device ms by op (the convolutions' share), launches, busy;
    one learned_denoise stage called on the card, the CPU and the card
    again, each result equal to a stage built fresh on that device. (e)
    evaluate, enhance --run-report and
    train-denoiser --steps 20 in subprocesses on DICOM files: exit 0, equal
    to the in-process results. Returns the kernels' launches in (b) and
    (d)."""
    from mies_tpu_torch.cli import _default_augment
    from mies_tpu_torch.eval.metrics import METRIC_REGISTRY, metric_values
    from mies_tpu_torch.eval.report import reference_u8
    from mies_tpu_torch.io.image import from_float, load_image, save_image
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.models.denoiser import denoise_batch, load_model
    from mies_tpu_torch.models.train import (
        make_train_step,
        synth_batch,
        train_denoiser,
    )
    from mies_tpu_torch.ops import filters as F
    from mies_tpu_torch.ops import histogram as H
    from mies_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        sharded_evaluate,
    )
    from mies_tpu_torch.pipeline.compiler import (
        OP_REGISTRY,
        _quantize_u8,
        compile_pipeline,
    )
    from mies_tpu_torch.pipeline.config import load_config
    from mies_tpu_torch.pipeline.runner import (
        _profile,
        enhance_image,
        profile_pipeline,
        time_pipeline,
    )

    names = tuple(METRIC_REGISTRY)
    flagship = load_config(repo / "configs" / "xray_clahe.yaml")
    x = torch.from_numpy(_xray_batch(BATCH, SIZE, SIZE, seed=0)).to(dev)
    counted = {}

    def count(fn):
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, dict(_build.LAUNCHES)

    def top_ops(prof, n=5):
        return ", ".join(f"{k} {v:.3f}" for k, v in
                         list(prof["by_op"].items())[:n])

    # -- (a) every metric at b32 512^2 --------------------------------------
    gt = _quantize_u8(x)
    out = compile_pipeline(flagship, batched=True, device=dev)(x)
    got = metric_values(gt, out, names, 255.0)
    want = metric_values(gt[:4].cpu(), out[:4].cpu(), names, 255.0)
    worst = {}
    for n in names:
        a, b = got[n][:4].cpu().double(), want[n].double()
        _require(got[n].shape == (BATCH,) and bool(torch.isfinite(got[n]).all()),
                 f"metric {n}: {tuple(got[n].shape)}, finite "
                 f"{bool(torch.isfinite(got[n]).all())}")
        tol = METRIC_REL.get(n, 2e-6) * b.abs() + METRIC_ABS.get(n, 1e-6)
        _require(bool(((a - b).abs() <= tol).all()),
                 f"metric {n} card vs CPU: {a.tolist()} vs {b.tolist()}")
        worst[n] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    ms_eval = _ms(lambda: metric_values(gt, out, names, 255.0), 3)
    per_metric = {n: _ms(lambda n=n: metric_values(gt, out, (n,), 255.0), 3)
                  for n in names}
    p_eval = _profile(lambda _: metric_values(gt, out, names, 255.0), None, 2,
                      dev)
    print(f"eval metrics [{BATCH},{SIZE},{SIZE}] uint8 flagship input vs "
          f"output, max_val 255, all {len(names)}: {ms_eval:.3f} ms an "
          f"evaluate call (CUDA events), device {p_eval['device_ms_per_call']:.3f}"
          f" ms, {p_eval['device_launches_per_call']:g} launches, busy "
          f"{p_eval['busy_share']:.1%} | per metric ms: "
          + ", ".join(f"{n} {v:.3f}" for n, v in per_metric.items())
          + " | means: " + ", ".join(f"{n} {got[n].double().mean():.6g}"
                                     for n in names)
          + " | card vs CPU on 4 slices, max rel: "
          + ", ".join(f"{n} {v:.2g}" for n, v in worst.items()) + f" | {card}")

    # -- (b) sharded_evaluate, NCCL world of one ----------------------------
    with tempfile.TemporaryDirectory() as store:
        init_distributed(f"file://{store}/store", 1, 0, device=dev.type)
        try:
            fn = sharded_evaluate(flagship, make_mesh(), ("psnr", "ssim"), 1.0)
            fn(x)
            (u8, means), launches_b = count(lambda: fn(x))
            want_b = {k: int(k in ("tile_luts", "clahe_apply_lut", "bilateral",
                                   "unsharp_quant")) for k in launches_b}
            _require(launches_b == want_b,
                     f"sharded_evaluate launches {launches_b}, want {want_b}")
            ms_b = _ms(lambda: fn(x), 10)
            p_b = _profile(lambda v: fn(v), x, 5, dev)
        finally:
            dist.destroy_process_group()
    _require(torch.equal(u8, out), "sharded_evaluate uint8 differs from "
             "compile_pipeline(batched=True)")
    flt = compile_pipeline(flagship, batched=True, quantize=False,
                           device=dev)(x)
    per = metric_values(x, flt, ("psnr", "ssim"), 1.0)
    for k in ("psnr", "ssim"):
        ref = float(per[k].double().mean())
        _require(abs(means[k] - ref) <= 1e-6 * abs(ref),
                 f"sharded_evaluate {k} {means[k]} vs {ref}")
    t_flag = time_pipeline(flagship, iters=10, warmup=2, repeats=3,
                           device=dev, batch=x)
    counted["sharded_evaluate"] = launches_b
    print(f"eval sharded_evaluate (NCCL, world 1) xray_clahe.yaml "
          f"[{BATCH},{SIZE},{SIZE}] psnr+ssim: {BATCH / ms_b * 1e3:.1f} slices/s "
          f"({ms_b:.4f} ms a call) beside the flagship alone "
          f"{t_flag['slices_per_sec']:.1f} ({t_flag['ms_per_batch']:.4f} ms) | "
          f"device {p_b['device_ms_per_call']:.3f} ms, "
          f"{p_b['device_launches_per_call']:g} launches, busy "
          f"{p_b['busy_share']:.1%} | by op: {top_ops(p_b)} | launches "
          f"{ {k: v for k, v in launches_b.items() if v} } | uint8 == "
          f"compile_pipeline, means psnr {means['psnr']:.6f} ssim "
          f"{means['ssim']:.6f} | {card}")

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        # -- (c) train_denoiser at the CLI's defaults -----------------------
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        state, losses, rep = train_denoiser(
            steps=500, batch=32, patch=64, features=32, depth=6,
            evaluate=True, checkpoint_dir=str(tmp / "dn"), device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        _require(state.model.dtype == torch.bfloat16 and next(
            state.model.parameters()).device.type == "cuda",
            "the denoiser does not train in bfloat16 on the card")
        _require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        _require(rep["psnr_model"] > rep["psnr_noisy"],
                 f"psnr_model {rep['psnr_model']} <= psnr_noisy "
                 f"{rep['psnr_noisy']}")
        init_fn, step_fn, _ = make_train_step(32, 6, device=dev)
        st = init_fn(0)
        noisy, clean = synth_batch(np.random.default_rng(0), 32, 64)
        for _ in range(3):
            st, _ = step_fn(st, noisy, clean)
        ms_step = _ms(lambda: step_fn(st, noisy, clean), 20)
        short = {}
        for label, kw in (
                ("unet 24x2", {"arch": "unet", "features": 24, "depth": 2}),
                ("noise2void", {"self_supervised": True}),
                ("mix", {"loss": "mix"}),
                ("augment elastic 4", {"augment": _default_augment(4.0)})):
            t1 = time.perf_counter()
            _, ls, _ = train_denoiser(**{"steps": 20, "log_every": 5,
                                         "device": dev, **kw})
            torch.cuda.synchronize(dev)
            _require(all(math.isfinite(v) for v in ls), f"{label}: {ls}")
            short[label] = (time.perf_counter() - t1, ls[0], ls[-1])
        print(f"models train_denoiser DnCNN 32x6 bf16 b32 patch 64, 500 "
              f"synthetic steps + eval: {500 / wall:.1f} steps/s by the loop "
              f"({wall:.2f} s; the host makes each batch), a step alone "
              f"{ms_step:.3f} ms ({1e3 / ms_step:.1f} steps/s) | loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f} | psnr noisy "
              f"{rep['psnr_noisy']:.3f}, model {rep['psnr_model']:.3f}, "
              f"bilateral {rep['psnr_bilateral']:.3f} dB | peak "
              f"{peak:.1f} MiB | 20 steps: "
              + "; ".join(f"{k} {v[0]:.2f} s loss {v[1]:.4f} -> {v[2]:.4f}"
                          for k, v in short.items()) + f" | {card}")

        # -- (d) learned_denoise -> clahe -> unsharp -> uint8 ---------------
        (tmp / "learned.yaml").write_text(
            LEARNED_CHAIN.format(ckpt=tmp / "dn"))
        cfg_d = load_config(tmp / "learned.yaml")
        fn_d = compile_pipeline(cfg_d, batched=True, device=dev)
        fn_d(x)
        out_d, launches_d = count(lambda: fn_d(x))
        want_d = {k: int(k in ("tile_luts", "clahe_apply_lut",
                               "unsharp_quant")) for k in launches_d}
        _require(launches_d == want_d,
                 f"learned chain launches {launches_d}, want {want_d}")
        model = load_model(tmp / "dn", dev)
        with torch.no_grad():
            den = denoise_batch(model, x)
        _build.reset_launches()
        plain = _quantize_u8(F.unsharp_mask(H.clahe(den, 2.0, (8, 8)), 1.5,
                                            1.0))
        _require(not any(_build.LAUNCHES.values()) and torch.equal(out_d, plain),
                 "learned chain differs from its plain CLAHE and tail")
        # bfloat16 on both: the card's and the CPU's convolutions round
        # their fp32 sums to bf16 in other orders, so the denoised slices
        # differ by up to a few bf16 ulps (the CPU tests' bound, 8e-3) and
        # about 0.1% of their uint8 levels; CLAHE's LUT steps turn those
        # into ~1% of the chain's pixels, some by several levels
        cpu_m = load_model(tmp / "dn")
        with torch.no_grad():
            den_err = (den[:4].cpu() - denoise_batch(cpu_m, x[:4].cpu())
                       ).abs().max().item()
        _require(den_err <= 8e-3, f"learned stage card vs CPU: {den_err}")
        cpu_d = compile_pipeline(cfg_d, batched=True, device="cpu")(x[:4].cpu())
        lv, n_off = _levels_off(out_d[:4].cpu().numpy(), cpu_d.numpy())
        _require(n_off < 0.02 * cpu_d.numel(),
                 f"learned chain card vs CPU: {n_off} pixels, {lv} levels")
        t_d = time_pipeline(cfg_d, iters=10, warmup=2, repeats=3, device=dev,
                            batch=x)
        p_d = profile_pipeline(cfg_d, iters=5, device=dev, batch=x)
        conv_ms = sum(v for k, v in p_d["by_op"].items() if "conv" in k)
        counted["learned"] = launches_d
        print(f"models learned chain [{BATCH},{SIZE},{SIZE}] float32 "
              f"(learned_denoise DnCNN 32x6 bf16 -> clahe opencv 8x8 (K1L, K2) "
              f"-> unsharp r1.5 + uint8 (K4)): {t_d['slices_per_sec']:.1f} "
              f"slices/s ({t_d['ms_per_batch']:.3f} ms a batch) | device "
              f"{p_d['device_ms_per_call']:.3f} ms, convolutions "
              f"{conv_ms:.3f} ({conv_ms / p_d['device_ms_per_call']:.1%}), "
              f"{p_d['device_launches_per_call']:g} launches, busy "
              f"{p_d['busy_share']:.1%} | by op: {top_ops(p_d)} | launches "
              f"{ {k: v for k, v in launches_d.items() if v} } | == its plain "
              f"CLAHE and tail | 4 slices vs CPU: the learned stage max abs "
              f"{den_err:.3g}, uint8 {n_off} of {cpu_d.numel()} differ (max "
              f"{lv}) | {card}")

        # one stage on the card, the CPU and the card again: each device
        # runs its own copy of the model (pipeline/compiler.py)
        build = OP_REGISTRY["learned_denoise"]
        stage = build(checkpoint=str(tmp / "dn"))
        xs = x[:2, :256, :256]
        hops = []
        for d in (dev, torch.device("cpu"), dev):
            got = stage(xs.to(d))
            fresh = build(checkpoint=str(tmp / "dn"))(xs.to(d))
            _require(got.device.type == d.type and torch.equal(got, fresh),
                     f"learned stage on {d.type} after {hops}: differs "
                     f"from a fresh stage")
            hops.append(d.type)
        print(f"models learned stage [2,256,256] on the card -> the CPU -> the "
              f"card: each result equal to a stage built fresh on that "
              f"device | {card}")

        # -- (e) the CLI in subprocesses, on DICOM files ---------------------
        a_u8, b_u8 = gt[1].cpu().numpy(), out[1].cpu().numpy()
        save_image(tmp / "a.dcm", a_u8)
        save_image(tmp / "b.dcm", b_u8)
        env = {**os.environ, "PYTHONPATH": str(repo)}

        def run(*args):
            t1 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "mies_tpu_torch",
                                   *map(str, args)], capture_output=True,
                                  text=True, env=env, cwd=repo, timeout=300)
            _require(proc.returncode == 0, f"CLI {args[0]} exited "
                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            return json.loads(proc.stdout), time.perf_counter() - t1

        ev, s_ev = run("evaluate", tmp / "a.dcm", tmp / "b.dcm")
        want_ev = metric_values(
            torch.from_numpy(from_float(load_image(tmp / "a.dcm"))).to(dev),
            torch.from_numpy(from_float(load_image(tmp / "b.dcm"))).to(dev),
            ("psnr", "ssim", "uqi"), 255.0)
        for k, v in want_ev.items():
            _require(abs(ev[k] - float(v)) <= 1e-6 * abs(float(v)),
                     f"CLI evaluate {k} {ev[k]} vs {float(v)}")
        _, s_rr = run("enhance", tmp / "a.dcm", "-c",
                      repo / "configs" / "xray_clahe.yaml", "-o",
                      tmp / "e.dcm", "--run-report", tmp / "r.json")
        rr = json.loads((tmp / "r.json").read_text())["metrics"]
        enh = enhance_image(tmp / "a.dcm", flagship, device=dev)
        want_rr = metric_values(
            torch.from_numpy(reference_u8(tmp / "a.dcm", flagship)).to(dev),
            torch.from_numpy(enh).to(dev), ("psnr", "ssim"), 255.0)
        for k, v in want_rr.items():
            _require(abs(rr[k] - float(v)) <= 1e-6 * abs(float(v)),
                     f"CLI --run-report {k} {rr[k]} vs {float(v)}")
        tr, s_tr = run("train-denoiser", "-o", tmp / "cli_dn", "--steps", 20)
        _, ls20, _ = train_denoiser(steps=20, device=dev)
        # the first loss precedes any update; cuDNN's weight gradients sum
        # in no fixed order, so the last is held to 1e-2
        _require(tr["steps"] == 20 and abs(tr["loss_curve"][0] - ls20[0])
                 <= 1e-6 * ls20[0] and abs(tr["loss_curve"][-1] - ls20[-1])
                 <= 1e-2 * ls20[-1], f"CLI train-denoiser {tr['loss_curve']} "
                 f"vs {ls20}")
        _require((tmp / "cli_dn" / "params.pt").exists(),
                 "CLI train-denoiser wrote no checkpoint")
    print(f"eval/models CLI subprocesses (DICOM in and out, no Pillow): "
          f"evaluate {s_ev:.1f} s ({ev}), enhance --run-report {s_rr:.1f} s "
          f"({rr}), train-denoiser --steps 20 {s_tr:.1f} s (loss "
          f"{tr['loss_curve']}) | each == the in-process result | {card}")
    return counted


def _post(url: str, body: bytes, timeout: float = 60.0) -> tuple[int, bytes]:
    """POST ``body`` to ``url``: (status, response body); an HTTP error's
    status and body too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _png(a: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _pct(samples: list[float]) -> tuple[float, float]:
    s = sorted(samples)
    return s[len(s) // 2], s[min(int(len(s) * 0.95), len(s) - 1)]


def _serving_phase(dev: torch.device, card: str, repo: Path) -> dict:
    """Phase 11: serving and deployment. (a) make_server(flagship) in a
    thread on the card, the reference's body cap and timeout: 64 seeded
    512^2 uint8 PNGs from one client, then 16 from 4 concurrent clients,
    and 8 seeded 512^2 int16 DICOMs (by ?filename=) to a ct_soft_tissue
    server; each response bit-equal to runner.enhance_image on the card and
    within 1 level on < 1e-3 of pixels of the plain chain on the card (K3's
    2e-6), K1 to the LUTs, K2, K3, K4 once a request; requests/s, p50/p95
    per request, the handler's decode / chain (CUDA events) / encode split,
    the chain's own batch-1 time_latency. (b) export_pipeline of the
    flagship at b32 512^2 uint8 and at b1, and of configs/ct_volume_3d.yaml
    as an int16 [256, 512, 512] volume (then the b32 flagship once more in
    the same process): each artifact bit-equal to compile_pipeline /
    compile_volume_pipeline on the same input, its mies ops launching the
    kernels once a call; ms per call of the artifact and of the closure
    (CUDA events), artifact bytes, export seconds. (c) serve --artifact
    with the b1 artifact: the 64 PNGs' responses bit-equal to (a)'s, a
    wrong shape a 400. (d) `python -m mies_tpu_torch serve -c
    configs/xray_clahe.yaml --port 0 --warmup 512x512` as a subprocess (its
    announce line read, one POST, terminated), `doctor` (exit 0, the card
    named), `warmup --batch 1 32`, `enhance --run-report --stage-costs`
    (every stage's operations and bytes finite). (e) enhance_batch(mesh=)
    on the 64 PNG files and enhance_volume_stream(mesh=) on phase 6's w5
    .nc (a seeded 512^3 int16 volume) on an NCCL world of one, each output
    bit-equal to the run without a mesh, files/s and z-slices/s beside it.
    Returns the kernels' launches by the flagship server's requests."""
    import queue
    import threading

    import torch.distributed as dist

    from mies_tpu_torch.io.dicom import write_dicom
    from mies_tpu_torch.io.image import load_image
    from mies_tpu_torch.io.volume import load_volume, save_volume
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.parallel import init_distributed, make_mesh
    from mies_tpu_torch.pipeline.compiler import (
        OP_REGISTRY,
        _ingest,
        _quantize_u8,
        compile_pipeline,
        compile_volume_pipeline,
    )
    from mies_tpu_torch.pipeline.config import load_config
    from mies_tpu_torch.pipeline.export import export_pipeline, load_exported
    from mies_tpu_torch.pipeline.presets import (
        flagship_config,
        flagship_volume_config,
    )
    from mies_tpu_torch.pipeline.runner import (
        enhance_batch,
        enhance_image,
        enhance_volume_stream,
        time_latency,
    )
    from mies_tpu_torch.serve import (
        DEFAULT_MAX_BODY_BYTES,
        make_server,
    )

    flagship = flagship_config()
    kern4 = ("tile_luts", "clahe_apply_lut", "bilateral", "unsharp_quant")
    rng = np.random.default_rng(11)
    imgs = [np.clip(_xray_batch(1, SIZE, SIZE, seed=100 + i)[0] * 255.0
                    + rng.normal(0, 2, (SIZE, SIZE)), 0, 255).astype(np.uint8)
            for i in range(64)]
    bodies = [_png(a) for a in imgs]

    def plain(cfg, img: np.ndarray) -> torch.Tensor:
        y = _ingest(torch.from_numpy(img).to(dev)[None])
        for s in cfg.stages:
            y = OP_REGISTRY[s.op](y, **s.kwargs())
        return _quantize_u8(y)[0]

    def running(srv):
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return t, f"http://127.0.0.1:{srv.server_address[1]}"

    def stop(srv, t):
        srv.shutdown()
        srv.server_close()
        t.join(60)
        _require(not t.is_alive(), "the server thread did not stop")

    def clients(url, work, n):
        """``work`` (index, body) split over ``n`` client threads; returns
        {index: (status, body, seconds)} and the wall seconds."""
        results, errors = {}, []

        def run(part):
            try:
                for i, body in part:
                    t0 = time.perf_counter()
                    st, data = _post(url, body)
                    results[i] = (st, data, time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(work[k::n],))
                   for k in range(n)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        _require(not errors and not any(t.is_alive() for t in threads),
                 f"clients failed: {errors}")
        return results, wall

    results = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        # -- (a) the server -------------------------------------------------
        srv = make_server(flagship, port=0, device=dev)
        _require(srv.RequestHandlerClass.timeout == 60.0,
                 "the server's request timeout is not the reference's")
        th, url = running(srv)
        try:
            st, _ = _post(url + "/enhance", bodies[0])  # warm the chain
            _require(st == 200, f"warm-up request: {st}")
            srv.state.timings.clear()
            _build.reset_launches()
            serial, wall_s = clients(url + "/enhance",
                                     list(enumerate(bodies)), 1)
            torch.cuda.synchronize(dev)
            counts_s = dict(_build.LAUNCHES)
            conc, wall_c = clients(url + "/enhance",
                                   [(i, bodies[i]) for i in range(16)], 4)
            torch.cuda.synchronize(dev)
            counts = dict(_build.LAUNCHES)
            timings = list(srv.state.timings)
        finally:
            stop(srv, th)
        want = {k: 80 * (k in kern4) for k in counts}
        _require(counts == want, f"served flagship launches {counts}, "
                 f"want {want} (64 + 16 requests)")
        _require({k: v for k, v in counts_s.items() if v} ==
                 dict.fromkeys(kern4, 64), f"serial launches {counts_s}")
        plain_off = 0
        for i in range(64):
            st, data, _ = serial[i]
            _require(st == 200, f"request {i}: {st} {data[:200]!r}")
            out = _unpng(data)
            (tmp / "r.png").write_bytes(bodies[i])
            _require(np.array_equal(out, enhance_image(tmp / "r.png", flagship,
                                                       device=dev)),
                     f"response {i} differs from enhance_image")
            d = np.abs(out.astype(np.int16)
                       - plain(flagship, imgs[i]).cpu().numpy().astype(
                           np.int16))
            _require(d.max() <= 1 and (d > 0).mean() < 1e-3,
                     f"response {i}: {(d > 0).sum()} pixels off the plain "
                     f"chain (max {d.max()})")
            plain_off += int((d > 0).sum())
            if i < 16:
                _require(conc[i][0] == 200 and conc[i][1] == data,
                         f"concurrent response {i} differs from the serial")
        results["served"] = [serial[i][1] for i in range(64)]
        lat_s = [serial[i][2] * 1e3 for i in range(64)]
        lat_c = [conc[i][2] * 1e3 for i in range(16)]
        split = {k: _pct([t[k] for t in timings])[0]
                 for k in ("decode_ms", "chain_ms", "encode_ms")}
        lat1 = time_latency(flagship, iters=16, repeats=16, device=dev)
        # the int16 CT server: 8 DICOMs by ?filename=
        ct_cfg = load_config(repo / "configs" / "ct_soft_tissue.yaml")
        ct = _ct_batch(8, SIZE, SIZE, seed=21)
        dcms = []
        for i in range(8):
            write_dicom(tmp / f"ct{i}.dcm", ct[i])
            dcms.append((tmp / f"ct{i}.dcm").read_bytes())
        srv = make_server(ct_cfg, port=0, device=dev)
        th, url = running(srv)
        try:
            _post(url + "/enhance?filename=w.dcm", dcms[0])
            _build.reset_launches()
            dres, wall_d = clients(url + "/enhance?filename=s.dcm",
                                   list(enumerate(dcms)), 1)
            torch.cuda.synchronize(dev)
            ct_counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        finally:
            stop(srv, th)
        _require(ct_counts == {"tile_luts": 8, "clahe_apply_lut": 8,
                               "unsharp_quant": 8},
                 f"served CT launches {ct_counts}")
        for i in range(8):
            _require(dres[i][0] == 200, f"DICOM {i}: {dres[i][0]}")
            _require(np.array_equal(_unpng(dres[i][1]), enhance_image(
                tmp / f"ct{i}.dcm", ct_cfg, device=dev)),
                f"DICOM response {i} differs from enhance_image")
        print(f"serve (a) flagship {SIZE}^2 uint8 PNG: serial 64 requests "
              f"{64 / wall_s:.1f} req/s, p50/p95 "
              f"{_pct(lat_s)[0]:.3f}/{_pct(lat_s)[1]:.3f} ms; 4 clients x 4 "
              f"{16 / wall_c:.1f} req/s, p50/p95 {_pct(lat_c)[0]:.3f}/"
              f"{_pct(lat_c)[1]:.3f} ms | in the handler (p50 of 80) decode "
              f"{split['decode_ms']:.3f}, chain {split['chain_ms']:.4f} (CUDA "
              f"events, H2D + 4 kernels), encode {split['encode_ms']:.3f} ms | "
              f"the chain's own batch-1 time_latency p50/p95 "
              f"{lat1['p50_ms']:.4f}/{lat1['p95_ms']:.4f} ms | launches "
              f"{ {k: v for k, v in counts.items() if v} } | every response "
              f"== enhance_image; {plain_off} of {64 * SIZE * SIZE} pixels 1 "
              f"level off the plain chain | ct_soft_tissue int16 DICOM x 8 "
              f"{8 / wall_d:.1f} req/s, == enhance_image, launches "
              f"{ct_counts} | max body {DEFAULT_MAX_BODY_BYTES} B | {card}")

        # -- (b) export ------------------------------------------------------
        xb = torch.from_numpy(np.stack(imgs[:BATCH])).to(dev)
        x1 = xb[0].contiguous()
        ctv_cfg = load_config(repo / "configs" / "ct_volume_3d.yaml")
        vol = _ct_volume(256, SIZE, SIZE, seed=4, dev=dev)
        arts = {}
        for key, cfg, kw, inp, ref_fn in (
                ("b32", flagship, {"batch_size": BATCH, "input_dtype": "uint8"},
                 xb, compile_pipeline(flagship, batched=True, device=dev)),
                ("b1", flagship, {"input_dtype": "uint8"}, x1,
                 compile_pipeline(flagship, device=dev)),
                ("volume", ctv_cfg, {"volume": True, "input_dtype": "int16"},
                 vol, compile_volume_pipeline(ctv_cfg, device=dev)),
                ("b32 again", flagship,
                 {"batch_size": BATCH, "input_dtype": "uint8"}, xb,
                 compile_pipeline(flagship, batched=True, device=dev))):
            shape = tuple(inp.shape) if key == "volume" else (SIZE, SIZE)
            t0 = time.perf_counter()
            path = export_pipeline(cfg, tmp / f"{key}.mies", shape=shape,
                                   device=dev, **kw)
            export_s = time.perf_counter() - t0
            fn, hdr = load_exported(path, device=dev)
            _require(hdr["platforms"] == ["cuda"], f"{key}: {hdr}")
            _build.reset_launches()
            got = fn(inp)
            torch.cuda.synchronize(dev)
            art_counts = {k: v for k, v in _build.LAUNCHES.items() if v}
            want_ref = ref_fn(inp)
            _require(torch.equal(got, want_ref),
                     f"the {key} artifact differs from its chain")
            want_counts = ({"tile_hists": 1, "clahe3d_apply": 1}
                           if key == "volume" else dict.fromkeys(kern4, 1))
            _require(art_counts == want_counts,
                     f"{key} artifact launches {art_counts}")
            arts[key] = (path, fn, hdr)
            iters = 5 if key == "volume" else 20
            ms_art = _ms(lambda: fn(inp), iters)
            ms_ref = _ms(lambda: ref_fn(inp), iters)
            print(f"export (b) {key} {list(inp.shape)} {inp.dtype}: artifact "
                  f"{ms_art:.4f} ms a call, the closure {ms_ref:.4f} (CUDA "
                  f"events, {iters} calls) | {path.stat().st_size} B, export "
                  f"{export_s:.2f} s | bit-equal, launches {art_counts} | "
                  f"{card}")

        # -- (c) serve --artifact --------------------------------------------
        _, fn1, hdr1 = arts["b1"]
        srv = make_server(flagship, port=0, artifact_fn=fn1,
                          artifact_header=hdr1, device=dev)
        th, url = running(srv)
        try:
            _post(url + "/enhance", bodies[0])
            ares, wall_a = clients(url + "/enhance", list(enumerate(bodies)), 1)
            small = _png(imgs[0][:SIZE // 2, :SIZE // 2].copy())
            st_bad, msg_bad = _post(url + "/enhance", small)
        finally:
            stop(srv, th)
        for i in range(64):
            _require(ares[i][0] == 200 and ares[i][1] == results["served"][i],
                     f"artifact response {i} differs from (a)'s")
        _require(st_bad == 400 and b"re-export" in msg_bad,
                 f"a wrong shape gave {st_bad} {msg_bad[:120]!r}")
        lat_a = [ares[i][2] * 1e3 for i in range(64)]
        print(f"serve (c) --artifact b1: 64 requests {64 / wall_a:.1f} req/s, "
              f"p50/p95 {_pct(lat_a)[0]:.3f}/{_pct(lat_a)[1]:.3f} ms, every "
              f"response == (a)'s; {SIZE // 2}^2 -> {st_bad} | {card}")

        # -- (d) the command line: the four subprocesses run at once ------
        env = {**os.environ, "PYTHONPATH": str(repo)}
        xray_cfg = repo / "configs" / "xray_clahe.yaml"
        (tmp / "in.png").write_bytes(bodies[2])
        cmds = {
            "serve": ["serve", "-c", str(xray_cfg), "--port", "0",
                      "--warmup", "512x512"],
            "doctor": ["doctor"],
            "warmup": ["warmup", "-c", str(xray_cfg), "--batch", "1", "32"],
            "enhance": ["enhance", str(tmp / "in.png"), "-c", str(xray_cfg),
                        "-o", str(tmp / "out.png"), "--run-report",
                        str(tmp / "r.json"), "--stage-costs"],
        }
        procs = {}
        t0 = time.perf_counter()
        for name, args in cmds.items():
            with open(tmp / f"{name}.out", "w") as out, \
                    open(tmp / f"{name}.err", "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "mies_tpu_torch", *args],
                    stdout=subprocess.PIPE if name == "serve" else out,
                    stderr=err, text=True, cwd=repo, env=env)
        lines: queue.Queue = queue.Queue()
        threading.Thread(
            target=lambda: lines.put(procs["serve"].stdout.readline()),
            daemon=True).start()
        try:
            try:
                announce = json.loads(lines.get(timeout=180))
            except (queue.Empty, ValueError):
                raise RuntimeError(
                    "chip_smoke check failed: serve printed no announce line "
                    "in 180 s: " + (tmp / "serve.err").read_text()[-800:]
                ) from None
            startup_s = time.perf_counter() - t0
            st, data = _post(announce["serving"] + "/enhance", bodies[1])
            for name in ("doctor", "warmup", "enhance"):
                rc = procs[name].wait(300)
                _require(rc == 0, f"{name} exit {rc}: "
                         f"{(tmp / f'{name}.err').read_text()[-500:]}")
            cli_s = time.perf_counter() - t0
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.terminate()
                    try:
                        proc.wait(30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
        _require(st == 200 and data == results["served"][1],
                 f"the serve subprocess answered {st}, not (a)'s response")
        doc = json.loads((tmp / "doctor.out").read_text())
        _require(doc["status"] == "ok" and doc["accelerator"]["name"]
                 == torch.cuda.get_device_name(0) and doc["sharding"]["ok"]
                 and doc["kernels"]["current"], f"doctor: {doc}")
        warm = json.loads((tmp / "warmup.out").read_text())
        _require([c["batch"] for c in warm["compiled"]] == [1, 32]
                 and warm["backend"] == "cuda", f"warmup: {warm}")
        costs = json.loads((tmp / "r.json").read_text())["stage_costs"]
        _require([c["op"] for c in costs] == ["clahe", "bilateral_blur",
                                              "unsharp_mask"]
                 and all(math.isfinite(c.get("flops", math.nan))
                         and math.isfinite(c.get("bytes", math.nan))
                         for c in costs), f"stage costs {costs}")
        print(f"serve (d) CLI, four subprocesses at once ({cli_s:.2f} s): "
              f"serve --warmup 512x512 announced in {startup_s:.2f} s, one "
              f"POST == (a)'s; doctor exit 0 "
              f"({doc['accelerator']['name']}, "
              f"{doc['accelerator']['power_limit']}, kernels current, gloo "
              f"world 2 ok); warmup "
              + ", ".join(f"b{c['batch']} {c['seconds']} s"
                          for c in warm["compiled"])
              + f" (kernel build {warm['kernel_build_seconds']} s); "
              f"--stage-costs " + ", ".join(
                  f"{c['op']} {c['flops']:.3g} ops {c['bytes']:.3g} B"
                  for c in costs) + f" | {card}")

        # -- (e) data-parallel at NCCL world 1 --------------------------------
        src = tmp / "png"
        src.mkdir()
        paths = []
        for i, body in enumerate(bodies):
            paths.append(src / f"x{i:02d}.png")
            paths[-1].write_bytes(body)
        vol5 = np.random.default_rng(0).integers(-1000, 2000, (512, SIZE, SIZE),
                                                 dtype=np.int16)
        save_volume(tmp / "w5.nc", vol5, var_name="hu")
        del vol5
        cfg5 = flagship_volume_config()
        walls = {}
        for mode in ("one", "mesh", "mesh 2", "one 2"):
            meshed = mode.startswith("mesh")
            with tempfile.TemporaryDirectory() as store:
                if meshed:
                    init_distributed(f"file://{store}/store", 1, 0,
                                     device=dev.type)
                try:
                    kw = {"mesh": make_mesh()} if meshed else {"device": dev}
                    t0 = time.perf_counter()
                    enhance_batch(paths, flagship, tmp / f"b_{mode}",
                                  progress=False, **kw)
                    t1 = time.perf_counter()
                    enhance_volume_stream(tmp / "w5.nc", cfg5,
                                          tmp / f"w5_{mode}.nc", **kw)
                    t2 = time.perf_counter()
                finally:
                    if meshed:
                        dist.destroy_process_group()
            walls[mode] = (t1 - t0, t2 - t1)
        for i, p in enumerate(paths):
            a = load_image(tmp / "b_mesh" / p.name, dtype="raw")
            _require(np.array_equal(a, load_image(tmp / "b_one" / p.name,
                                                  dtype="raw")),
                     f"enhance_batch(mesh=) {p.name} differs")
            _require(np.array_equal(a, _unpng(results["served"][i])),
                     f"enhance_batch {p.name} differs from the server's")
        w_one, _ = load_volume(tmp / "w5_one.nc")
        w_mesh, _ = load_volume(tmp / "w5_mesh.nc")
        _require(np.array_equal(w_one, w_mesh),
                 "enhance_volume_stream(mesh=) differs")
        print("data-parallel (e) NCCL world 1: enhance_batch 64 PNG files "
              + ", ".join(f"{m} {64 / w[0]:.1f}" for m, w in walls.items())
              + " files/s; enhance_volume_stream w5 512^3 int16 .nc "
              + ", ".join(f"{m} {512 / w[1]:.1f}" for m, w in walls.items())
              + f" z-slices/s | outputs bit-equal with and without the mesh "
              f"| {card}")
    return counts


def _device_timers_phase(dev: torch.device, card: str, repo: Path) -> None:
    """Phase 12: the device-resident timers (runner.time_pipeline_device,
    time_latency_device: ``inner`` chained iterations of the chain in one
    CUDA graph, timed by its replays). BASELINE w2, w3 (b8 1024^2), w4
    (b64 int16), w5, w7, w8 and w9 at benchmarks/workloads.py's shapes and
    batches with inner 8, w5 also at b8 1024^2 (K1's tiles of 128^2 split
    over blocks: the arrival counters reset inside the captured work),
    configs/xray_adapthist_skimage.yaml at b32 512^2 (K1 bins, K6a, K6,
    K4), and w1 (b1) and presets.latency_config at inner 64 through the
    one-slice program. For each: two replays of the captured loop each
    bit-equal to the eager body run ``inner`` times from the same input,
    exactly the hand kernels of its path recorded at capture (a multiple
    of inner of each); then the graph figure from two calls, the event-timed
    time_pipeline / time_latency figure, profile_pipeline's busy share,
    the graph pool's peak and the card, on one line."""
    from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
    from mies_tpu_torch.pipeline.presets import flagship_config, latency_config
    from mies_tpu_torch.pipeline.runner import (
        _capture_device_loop,
        profile_pipeline,
        time_latency,
        time_latency_device,
        time_pipeline,
        time_pipeline_device,
    )

    clahe = ("clahe", {"clip_limit": 2.0, "grid_size": GRID,
                       "convention": "opencv"})
    w1 = [("equalize_hist", {}), ("adjust_gamma", {"gamma": 0.8})]
    w3 = [("unsharp_mask", {"radius": 1.5, "amount": 1.0}),
          ("gaussian_blur", {"sigma": 1.5})]
    w4 = [("window_hu", {"center": 40.0, "width": 400.0}),
          ("median_blur", {"kernel_size": 3}),
          ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                              "sigma_space": 1.5})]
    w5 = [(s.op, s.kwargs()) for s in flagship_config().stages]
    w7 = [("median_blur", {"kernel_size": 3}),
          ("top_hat", {"kernel_size": 7, "shape": "ellipse"}),
          ("rescale_intensity", {"out_range": (0.0, 1.0)})]
    w8 = [("anisotropic_diffusion", {"niter": 6, "kappa": 0.05, "gamma": 0.2}),
          ("musica", {"levels": 5, "p": 0.6, "gain": 1.5})]
    w9 = [("srad", {"niter": 15, "dt": 0.15}), clahe]
    lut = {"tile_luts", "clahe_apply_lut"}
    skimage = [(s.op, s.kwargs()) for s in load_config(
        repo / "configs" / "xray_adapthist_skimage.yaml").stages]
    batched = (
        ("w2", [clahe], 512, 32, np.float32, lut),
        ("w3", w3, 1024, 8, np.float32, {"unsharp_gauss"}),
        ("w4", w4, 512, 64, np.int16, {"bilateral"}),
        ("w5", w5, 512, 32, np.float32, lut | {"bilateral", "unsharp_quant"}),
        ("w5 1024^2", w5, 1024, 8, np.float32,
         lut | {"bilateral", "unsharp_quant"}),
        ("w7", w7, 512, 32, np.float32, set()),
        ("w8", w8, 512, 32, np.float32, {"perona_malik"}),
        ("w9", w9, 512, 32, np.float32, lut | {"srad"}),
        ("skimage yaml", skimage, 512, 32, np.float32,
         {"tile_hists_bins", "skimage_maps", "skimage_apply",
          "unsharp_quant"}),
    )
    latency = (
        ("w1", w1, set()),
        ("latency_config", [(s.op, s.kwargs()) for s in
                            latency_config().stages], lut | {"bilateral"}),
    )

    def check_graph(label, cfg, shape, inner, dtype, kernels):
        """Two replays == the eager loop bit for bit, the kernels recorded
        at capture; returns the graph pool's peak bytes and the launches
        recorded."""
        loop = _capture_device_loop(cfg, shape, inner, dtype, dev,
                                    "chip_smoke phase 12")
        loop.graph.replay()
        first = loop.y.clone()
        loop.graph.replay()
        eager = loop.eager()
        torch.cuda.synchronize()
        _require(torch.equal(first, eager) and torch.equal(loop.y, eager),
                 f"{label}: a graph replay differs from the eager loop")
        _require(set(loop.launches) == kernels and all(
            n >= inner and n % inner == 0 for n in loop.launches.values()),
            f"{label}: captured launches {loop.launches}, want each of "
            f"{sorted(kernels)} a multiple of {inner}")
        return loop.peak_bytes, dict(loop.launches)

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    for label, stages, size, b, dtype, kernels in batched:
        cfg = PipelineConfig.make(stages, name=label)
        peak, launches = check_graph(label, cfg, (b, size, size), 8, dtype,
                                     kernels)
        g = [time_pipeline_device(cfg, (size, size), b, inner=8, repeats=16,
                                  dtype=dtype, device=dev) for _ in range(2)]
        if dtype == np.int16:
            a = rng.integers(-1000, 2000, (b, size, size), dtype=np.int16)
        else:
            a = rng.random((b, size, size), dtype=np.float32)
        inp = torch.from_numpy(a).to(dev)
        t = time_pipeline(cfg, device=dev, batch=inp)
        prof = profile_pipeline(cfg, device=dev, batch=inp)
        print(f"device timers {label} b{b} {size}^2 {np.dtype(dtype).name}: "
              f"graph x8 {g[0]['slices_per_sec']:.1f}, "
              f"{g[1]['slices_per_sec']:.1f} slices/s "
              f"({g[0]['ms_per_batch']:.4f}, {g[1]['ms_per_batch']:.4f} "
              f"ms/batch) | event-timed {t['slices_per_sec']:.1f} slices/s "
              f"({t['ms_per_batch']:.4f} ms/batch) | graph/event "
              f"{g[0]['slices_per_sec'] / t['slices_per_sec']:.2f}x | busy "
              f"{prof['busy_share']:.1%} (device "
              f"{prof['device_ms_per_call']:.4f} ms/call) | graph pool peak "
              f"{peak / 2**20:.1f} MiB | captured {launches} | 2 replays == "
              f"eager x8 | {card}")
    for label, stages, kernels in latency:
        cfg = PipelineConfig.make(stages, name=label)
        peak, launches = check_graph(label, cfg, (SIZE, SIZE), 64,
                                     np.float32, kernels)
        g = [time_latency_device(cfg, (SIZE, SIZE), inner=64, repeats=32,
                                 device=dev) for _ in range(2)]
        t = time_latency(cfg, (SIZE, SIZE), device=dev)
        img = torch.from_numpy(rng.random((1, SIZE, SIZE), dtype=np.float32)
                               ).to(dev)
        prof = profile_pipeline(cfg, device=dev, batch=img)
        print(f"device timers {label} b1 {SIZE}^2 latency: graph x64 p50 "
              f"{g[0]['p50_ms']:.4f}, {g[1]['p50_ms']:.4f} ms, p95 "
              f"{g[0]['p95_ms']:.4f}, {g[1]['p95_ms']:.4f} ms | event-timed "
              f"p50 {t['p50_ms']:.4f} ms, p95 {t['p95_ms']:.4f} ms | "
              f"event/graph {t['p50_ms'] / g[0]['p50_ms']:.2f}x | busy "
              f"{prof['busy_share']:.1%} (device "
              f"{prof['device_ms_per_call']:.4f} ms/call) | graph pool peak "
              f"{peak / 2**20:.1f} MiB | captured {launches} | 2 replays == "
              f"eager x64 | {card}")
    print(f"device timers: {len(batched) + len(latency)} chains captured, "
          f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.kernels import bilateral as KB
    from mies_tpu_torch.kernels import clahe as KC
    from mies_tpu_torch.kernels import clahe3d as K3D
    from mies_tpu_torch.kernels import diffusion as KD
    from mies_tpu_torch.kernels import fused as KF
    from mies_tpu_torch.kernels import nlmeans as KN
    from mies_tpu_torch.kernels import tv as KT
    from mies_tpu_torch.kernels import unsharp_gauss as KU
    from mies_tpu_torch.ops import filters as F
    from mies_tpu_torch.ops import frequency as FQ
    from mies_tpu_torch.ops import histogram as H
    from mies_tpu_torch.ops import intensity as I
    from mies_tpu_torch.ops import restoration as R
    from mies_tpu_torch.ops import ridges as RG
    from mies_tpu_torch.ops import volume3d as V
    from mies_tpu_torch.ops import wavelet as WV
    from mies_tpu_torch.parallel import (
        batch_spatial_shard_apply,
        init_distributed,
        make_mesh,
        spatial_shard_apply,
    )
    from mies_tpu_torch.pipeline.compiler import (
        OP_REGISTRY,
        _ingest,
        _quantize_u8,
        compile_pipeline,
        compile_volume_pipeline,
    )
    from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
    from mies_tpu_torch.pipeline.presets import flagship_config, latency_config
    from mies_tpu_torch.pipeline.runner import (
        _profile,
        make_batch,
        profile_pipeline,
        profile_volume,
        time_latency,
        time_pipeline,
        time_volume,
    )

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
          f"({'compiled' if compiled else 'up to date'}, "
          f"{len(_build._sources())} sources) -> {_build.LIBRARY.name}")

    # -- 3. each kernel against its plain version, main-path shapes ------
    x = torch.from_numpy(_xray_batch(BATCH, SIZE, SIZE, seed=0)).to(dev)
    npx = x.numel()
    th, tw = SIZE // GRID[0], SIZE // GRID[1]
    rec, rec_at, rec_dev = {}, {}, {}

    def device_ms(fn) -> float:
        """Device ms per call of fn() by torch.profiler over 20 calls: the
        kernels' own time, without the host time between back-to-back
        launches that CUDA events around the calls also hold."""
        return _profile(lambda _: fn(), None, 20, dev)["device_ms_per_call"]

    def record(key, err, kernel, plain, nbytes, ops, library=None,
               plain_iters=20, at=f"[{BATCH},{SIZE},{SIZE}]", profiled=False):
        bound_ms, bound_by = _bound(nbytes, ops)
        rec[key] = {"max_abs_err": err, "ms": _ms(kernel),
                    "plain_ms": _ms(plain, plain_iters), "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library}
        rec_at[key] = at
        if profiled:
            rec_dev[key] = device_ms(kernel)

    # K1, float mode: 4 B read per pixel; level quantize (4 ops) + one count
    hk, hp = KC.tile_hists(x, GRID), KC.tile_hists_plain(x, GRID)
    err = (hk - hp).abs().max().item()
    _require(torch.equal(hk, hp), f"K1 counts differ by up to {err}")
    tile_id = (torch.arange(SIZE, device=dev)[:, None] // th * GRID[1]
               + torch.arange(SIZE, device=dev)[None, :] // tw)
    key = ((torch.arange(BATCH, device=dev)[:, None, None] * GRID[0] * GRID[1]
            + tile_id) * 256 + H._levels(x)).reshape(-1)
    record("K1", err, lambda: KC.tile_hists(x, GRID),
           lambda: KC.tile_hists_plain(x, GRID),
           4 * npx + 4 * hk.numel(), 5 * npx,
           _index_add_ms(key, hk.numel()), profiled=True)

    # K1 to the OpenCV LUTs: 4 B read per pixel (+ the LUTs written); the
    # counting's 5 ops per pixel and about 20 integer ops per bin for the
    # clip, redistribution, two scans and the rint'ed entry. No one PyTorch
    # call computes it.
    luts = KC.tile_luts(x, GRID, 2.0)
    lp = KC.tile_luts_plain(x, GRID, 2.0)
    err = (luts - lp).abs().max().item()
    _require(torch.equal(luts, lp), f"K1 LUTs differ by up to {err}")
    record("K1L", err, lambda: KC.tile_luts(x, GRID, 2.0),
           lambda: KC.tile_luts_plain(x, GRID, 2.0),
           4 * npx + 4 * luts.numel(), 5 * npx + 20 * luts.numel(),
           profiled=True)

    # K2, u8norm: 4 B in + 4 B out per pixel, 29 f32 ops per pixel
    ck, cp = KC.clahe_apply_lut(x, luts, GRID), KC.clahe_apply_lut_plain(x, luts, GRID)
    err = (ck - cp).abs().max().item()
    _require(torch.equal(ck, cp), f"K2 output differs by up to {err}")
    record("K2", err, lambda: KC.clahe_apply_lut(x, luts, GRID),
           lambda: KC.clahe_apply_lut_plain(x, luts, GRID),
           8 * npx + 4 * luts.numel(), 29 * npx, profiled=True)

    # K2, clip01 on the fraction convention's LUTs: 27 ops per pixel
    fluts = KC.tile_luts(x, GRID, 0.01, "fraction")
    _require(not torch.equal(fluts, torch.round(fluts)), "LUTs not fractional")
    fk = KC.clahe_apply_lut(x, fluts, GRID, "clip01")
    fp = KC.clahe_apply_lut_plain(x, fluts, GRID, "clip01")
    err = (fk - fp).abs().max().item()
    _require(torch.equal(fk, fp), f"K2 clip01 differs by up to {err}")
    record("K2c", err, lambda: KC.clahe_apply_lut(x, fluts, GRID, "clip01"),
           lambda: KC.clahe_apply_lut_plain(x, fluts, GRID, "clip01"),
           8 * npx + 4 * fluts.numel(), 27 * npx, profiled=True)

    # K3: 8 B per pixel; _bilateral_ops(5) per pixel
    bk = KB.bilateral_cuda(ck, 5, 0.1, 1.5, "reflect")
    bp = F.bilateral_blur(ck, 5, 0.1, 1.5, "reflect")
    err = (bk - bp).abs().max().item()
    _require(err <= 2e-6, f"K3 max abs error {err} > 2e-6")
    record("K3", err, lambda: KB.bilateral_cuda(ck, 5, 0.1, 1.5, "reflect"),
           lambda: F.bilateral_blur(ck, 5, 0.1, 1.5, "reflect"),
           8 * npx, _bilateral_ops(5) * npx, profiled=True)

    # K4: 4 B in + 1 B out per pixel; two 13-tap passes (mul + add per
    # tap), the unsharp blend and the quantize
    uk, up = KU.unsharp_quant_cuda(bk, 1.5, 1.0), KU.unsharp_quant_plain(bk, 1.5, 1.0)
    err = (uk.int() - up.int()).abs().max().item()
    _require(torch.equal(uk, up), f"K4 uint8 differs by up to {err} levels")
    _require(torch.equal(KU.unsharp_quant_cuda(bk, 1.5, 1.0, quantize=False),
                         KU.unsharp_quant_plain(bk, 1.5, 1.0, quantize=False)),
             "K4 float32 (quantize=False) is not bit-equal")
    record("K4", err, lambda: KU.unsharp_quant_cuda(bk, 1.5, 1.0),
           lambda: KU.unsharp_quant_plain(bk, 1.5, 1.0),
           5 * npx, (4 * 13 + 8) * npx, profiled=True)

    # the skimage config's kernels: 8x8 regions of 64x64 at 512^2
    ks = H.skimage_kernel_size((SIZE, SIZE), GRID)
    (pr0, _, pc0, _), (nr, nc) = H.skimage_geometry((SIZE, SIZE), ks)
    k_elems, nbins = ks[0] * ks[1], 256
    clim = int(np.clip(0.01 * k_elems, 1, None))
    binned = H._skimage_binned(x, ks, nbins)
    origin, rgrid = (pr0, pc0), (nr, nc)

    sk = KC.tile_hists_bins(binned, origin, rgrid, ks, nbins)
    sp = KC.tile_hists_bins_plain(binned, origin, rgrid, ks, nbins)
    err = (sk - sp).abs().max().item()
    _require(torch.equal(sk, sp), f"K1 bins counts differ by up to {err}")
    win = binned[:, pr0:pr0 + nr * ks[0], pc0:pc0 + nc * ks[1]]
    rid = (torch.arange(win.shape[1], device=dev)[:, None] // ks[0] * nc
           + torch.arange(win.shape[2], device=dev)[None, :] // ks[1])
    bkey = ((torch.arange(BATCH, device=dev)[:, None, None] * nr * nc + rid)
            * nbins + win).reshape(-1)
    record("K1b", err,
           lambda: KC.tile_hists_bins(binned, origin, rgrid, ks, nbins),
           lambda: KC.tile_hists_bins_plain(binned, origin, rgrid, ks, nbins),
           4 * win.numel() + 4 * sk.numel(), win.numel(),
           _index_add_ms(bkey, sk.numel()), profiled=True)

    # K6a: a warp per region; ops counted from this run's phase-3 steps: 16
    # per bin for phases 1-2, the scale and the floor, 8 per bin per sweep
    # step, 2 per bin per scan level
    mk, mp = KC.skimage_maps(sk, clim, k_elems), KC.skimage_maps_plain(sk, clim, k_elems)
    err = (mk - mp).abs().max().item()
    _require(torch.equal(mk, mp), f"K6a maps differ by up to {err}")
    _, steps = H._clip_histogram_skimage(sk, clim, nbins, with_steps=True)
    n_regions = sk.numel() // nbins
    k6a_ops = nbins * (n_regions * (16 + 2 * math.log2(nbins))
                       + 8 * steps.sum().item())
    record("K6a", err, lambda: KC.skimage_maps(sk, clim, k_elems),
           lambda: KC.skimage_maps_plain(sk, clim, k_elems),
           8 * sk.numel(), k6a_ops, plain_iters=3, profiled=True)
    print(f"K6a phase-3 steps per region: max {steps.max().item()}, mean "
          f"{steps.float().mean().item():.2f}, regions with a sweep "
          f"{int((steps > 0).sum().item())} of {n_regions}")

    # K6: 4 B of bins in + 4 B out per output pixel, 16 ops per pixel
    out_hw = (SIZE, SIZE)
    ak = KC.skimage_apply(binned, mk, ks, origin, out_hw)
    ap = KC.skimage_apply_plain(binned, mk, ks, origin, out_hw)
    err = (ak - ap).abs().max().item()
    _require(torch.equal(ak, ap), f"K6 output differs by up to {err}")
    record("K6", err, lambda: KC.skimage_apply(binned, mk, ks, origin, out_hw),
           lambda: KC.skimage_apply_plain(binned, mk, ks, origin, out_hw),
           8 * npx + 4 * mk.numel(), 16 * npx, profiled=True)
    # K6 at nbins 1000 (16 KB of corner quads a block), the same regions
    b1k = H._skimage_binned(x, ks, 1000)
    s1k = KC.tile_hists_bins(b1k, origin, rgrid, ks, 1000)
    m1k = KC.skimage_maps(s1k, clim, k_elems)
    # K6a at nbins 1000: 32 bins a lane
    err = (m1k - KC.skimage_maps_plain(s1k, clim, k_elems)).abs().max().item()
    _require(err == 0, f"K6a at nbins 1000 differs by up to {err}")
    _, steps1k = H._clip_histogram_skimage(s1k, clim, 1000, with_steps=True)
    record("K6an", err, lambda: KC.skimage_maps(s1k, clim, k_elems),
           lambda: KC.skimage_maps_plain(s1k, clim, k_elems), 8 * s1k.numel(),
           1000 * (n_regions * (16 + 2 * math.log2(1000))
                   + 8 * steps1k.sum().item()),
           plain_iters=3, profiled=True)
    ak = KC.skimage_apply(b1k, m1k, ks, origin, out_hw)
    ap = KC.skimage_apply_plain(b1k, m1k, ks, origin, out_hw)
    err = (ak - ap).abs().max().item()
    _require(torch.equal(ak, ap), f"K6 at nbins 1000 differs by up to {err}")
    record("K6n", err, lambda: KC.skimage_apply(b1k, m1k, ks, origin, out_hw),
           lambda: KC.skimage_apply_plain(b1k, m1k, ks, origin, out_hw),
           8 * npx + 4 * m1k.numel(), 16 * npx, profiled=True)
    # the restoration kernels on the inputs their chains give them, at the
    # shipped parameters: NL-means and TV of configs/ct_lowdose_nlm.yaml
    # on the windowed int16 phantom, SRAD of ultrasound_despeckle.yaml on
    # the uint8 phantom, Perona-Malik of w8 (benchmarks/workloads.py) on
    # the X-ray batch. Each is bit-equal or within the reference's own
    # contract (1e-6; TV 2e-6 with equal per-slice stop iterations).
    ct = torch.from_numpy(_ct_batch(BATCH, SIZE, SIZE, seed=1)).to(dev)
    us = torch.from_numpy(_us_batch(BATCH, SIZE, SIZE, seed=2)).to(dev)
    ctw = I.window_hu(ct, 40.0, 400.0)
    usf = _ingest(us)
    nlm = (5, 6, 0.06, 0.04)
    tvp = (0.03, 2e-4, 60)
    srp, pmp = (15, 0.15), (6, 0.05, 0.2, 1)

    def within(got, want, tol, what):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        _require(bool(torch.isfinite(got).all()), f"{what}: not finite")
        _require(err <= tol, f"{what}: max abs error {err} > {tol}")
        return err, bool(torch.equal(got, want))

    equal = {}
    nk = KN.nl_means_cuda(ctw, *nlm)
    err, equal["K11"] = within(nk, R.denoise_nl_means(ctw, *nlm), 1e-6,
                               "K11")
    s_, d_ = nlm[0] + 1 - nlm[0] % 2, nlm[1]
    pairs = len(R.half_shift_table(d_))
    # per pair and pixel: difference and square, the s-wide box along rows
    # and columns, the weight (bias, max, scale, cutoff, exp, select), the
    # two ends' accumulations (2 multiplies, 4 adds)
    record("K11", err, lambda: KN.nl_means_cuda(ctw, *nlm),
           lambda: R.denoise_nl_means(ctw, *nlm), 8 * npx,
           pairs * (14 + 2 * (s_ - 1)) * npx, plain_iters=3)

    tk, tk_iters = KT.denoise_tv_cuda(nk, *tvp, return_iters=True)
    tp, tp_iters = R.tv_chambolle(nk, *tvp)
    err, equal["K12"] = within(tk, tp, 2e-6, "K12")
    _require(torch.equal(tk_iters, tp_iters),
             f"K12 stop iterations {tk_iters.tolist()} != plain "
             f"{tp_iters.tolist()}")
    # 22 operations per pixel and iteration actually run (a stopped
    # slice's steps return at once)
    record("K12", err, lambda: KT.denoise_tv_cuda(nk, *tvp),
           lambda: R.denoise_tv(nk, *tvp), 8 * npx,
           22 * int(tk_iters.sum().item()) * SIZE * SIZE, plain_iters=3)
    print(f"K12 per-slice stop iterations: kernel {tk_iters.tolist()} | "
          f"plain {tp_iters.tolist()}")
    # the chunk boundaries, KT.STEPS steps a launch, on 6 CT and 2 X-ray
    # slices: at 61 steps (one step past a whole chunk) with eps 2e-4 and
    # 1.5e-4 the slices stop at the first (17), a middle (19, 38, 46) and
    # the last step (44) of a chunk of 4 (the plain version on the CPU); at
    # 37 steps the CT slices never stop, at 9 no slice does. Stop iterations
    # equal, out within 2e-6, 3 ceil(max_num_iter / STEPS) launches.
    tb = torch.cat([nk[::6][:6], x[:2]]).contiguous()
    where = dict.fromkeys(range(KT.STEPS), 0)
    never = 0
    for eps, steps in ((2e-4, 61), (1.5e-4, 61), (2e-4, 37), (2e-4, 9)):
        case = f"K12 eps {eps} at {steps} steps"
        want, want_iters = R.tv_chambolle(tb, tvp[0], eps, steps)
        _build.reset_launches()
        got, got_iters = KT.denoise_tv_cuda(tb, tvp[0], eps, steps,
                                            return_iters=True)
        _require(_build.LAUNCHES["tv"] == KT.launches_per_call(steps),
                 f"{case}: {_build.LAUNCHES['tv']} launches")
        _require(torch.equal(got_iters, want_iters),
                 f"{case}: stop iterations {got_iters.tolist()} != plain "
                 f"{want_iters.tolist()}")
        within(got, want, 2e-6, case)
        for n in want_iters.tolist():
            if n < steps:
                where[(n - 1) % KT.STEPS] += 1
            else:
                never += 1
    _require(min(where.values()) > 0 and never > 0,
             f"K12 chunk positions not all met: {where}, {never} never stop")
    print(f"K12 chunk boundaries: {list(tb.shape)}, equal stop iterations "
          f"and 3 ceil(steps / {KT.STEPS}) launches at 61, 37 and 9 steps; "
          f"stops by step of the chunk {where}, {never} slices never stop")

    sk10 = KD.srad_cuda(usf, *srp)
    err, equal["K10"] = within(sk10, R.srad(usf, *srp), 1e-6, "K10")
    _require(equal["K10"], f"K10 differs from R.srad by up to {err}")
    # 42 per pixel and iteration: 4 differences, one conduction (29),
    # the divergence (7) and the update (2)
    record("K10", err, lambda: KD.srad_cuda(usf, *srp),
           lambda: R.srad(usf, *srp), 8 * npx, 42 * srp[0] * npx,
           plain_iters=5)

    # K9 at w8's 6 steps (options 1 and 2), at one step (the band chain's
    # launch) and at 7 (a last launch shorter than KD.PM_STEPS): each
    # bit-equal to the plain version. 18 operations per pixel and step:
    # two differences, two fluxes (6 each), the divergence (2) and the
    # update (2)
    for key, kw in (("K9", pmp), ("K9o2", (*pmp[:3], 2)),
                    ("K9n1", (1, *pmp[1:])), ("K9n7", (7, *pmp[1:]))):
        pk = KD.anisotropic_diffusion_cuda(x, *kw)
        err, equal[key] = within(pk, R.anisotropic_diffusion(x, *kw), 1e-6,
                                 key)
        _require(equal[key], f"{key} differs from R.anisotropic_diffusion "
                             f"by up to {err}")
        record(key, err, lambda kw=kw: KD.anisotropic_diffusion_cuda(x, *kw),
               lambda kw=kw: R.anisotropic_diffusion(x, *kw), 8 * npx,
               18 * kw[0] * npx)
    print(f"K9-K12 bit-equal to their plain versions: {equal}")
    print(f"K9 [{BATCH},{SIZE},{SIZE}] ms per call ({KD.PM_STEPS} steps a "
          f"launch): w8 niter 6 option 1 {rec['K9']['ms']:.4f} (plain "
          f"{rec['K9']['plain_ms']:.4f}), option 2 {rec['K9o2']['ms']:.4f}, "
          f"niter 1 {rec['K9n1']['ms']:.4f}, niter 7 {rec['K9n7']['ms']:.4f}"
          f"; bound {rec['K9']['bound_ms']:.4f} ({rec['K9']['bound_by']}) | "
          f"{card}")

    # the 3-D CLAHE kernels on the X-ray batch as one [32, 512, 512] volume
    # at the grid (4, 8, 8) of w6 and configs/ct_volume_3d.yaml: K1 over the
    # slices summed per z-tile, K8 in both epilogues (opencv integer LUTs,
    # fraction LUTs), and K8s on the skimage path's 8 x 64 x 64 regions
    g3 = (4, 8, 8)
    tz3 = BATCH // g3[0]
    h3 = hk.reshape(g3[0], tz3, GRID[0] * GRID[1], 256).sum(1, dtype=torch.int32)
    # per voxel: level (4), three axis fractions (5 each), seven lerps (4
    # each), the epilogue (u8norm 4, clip01 2). At [32, 512, 512] on the
    # X-ray batch (w6's shape) and at [256, 512, 512] on the windowed CT
    # phantom of configs/ct_volume_3d.yaml (its K8 input), each with the
    # LUTs of its own K1 counts
    ctv = _ct_volume(256, SIZE, SIZE, seed=4, dev=dev)
    ctvw = I.window_hu(ctv, 40.0, 400.0).contiguous()
    hct = KC.tile_hists(ctvw, GRID).reshape(g3[0], ctvw.shape[0] // g3[0],
                                            GRID[0] * GRID[1], 256)
    hct = hct.sum(1, dtype=torch.int32)
    for sfx, vol, h, iters in (("", x, h3, 5), ("v", ctvw, hct, 2)):
        tvox = vol.shape[0] // g3[0] * th * tw
        nvox = vol.numel()
        for key, conv, clip, fin, ops in (("K8", "opencv", 2.0, "u8norm", 51),
                                          ("K8c", "fraction", 0.01, "clip01",
                                           49)):
            key += sfx
            l3 = V.luts_3d(h.float(), clip, tvox, conv).reshape(*g3, 256)
            _require(conv == "opencv" or not torch.equal(l3, torch.round(l3)),
                     "3-D fraction LUTs not fractional")
            ek = K3D.clahe3d_apply_lut(vol, l3, g3, fin)
            ep = K3D.clahe3d_apply_lut_plain(vol, l3, g3, fin)
            err = (ek - ep).abs().max().item()
            _require(torch.equal(ek, ep),
                     f"{key} ({fin}) differs by up to {err}")
            record(key, err,
                   lambda vol=vol, l3=l3, fin=fin: K3D.clahe3d_apply_lut(
                       vol, l3, g3, fin),
                   lambda vol=vol, l3=l3, fin=fin:
                   K3D.clahe3d_apply_lut_plain(vol, l3, g3, fin),
                   8 * nvox + 4 * l3.numel(), ops * nvox, plain_iters=iters,
                   at=str(list(vol.shape)).replace(" ", ""))
    print(f"K8 ms (bound) u8norm / clip01: [{BATCH},{SIZE},{SIZE}] "
          f"{rec['K8']['ms']:.4f} / {rec['K8c']['ms']:.4f} "
          f"({rec['K8']['bound_ms']:.4f}), [256,{SIZE},{SIZE}] "
          f"{rec['K8v']['ms']:.4f} / {rec['K8cv']['ms']:.4f} "
          f"({rec['K8v']['bound_ms']:.4f}); bit-equal | {card}")
    ks3 = V.skimage3d_kernel_size(x.shape, g3)
    pad3, _, ns3 = V.skimage3d_geometry(x.shape, ks3)
    b3 = V._skimage3d_binned(x, ks3, nbins)
    k3e = ks3[0] * ks3[1] * ks3[2]
    sh3 = KC.tile_hists_bins(b3[pad3[0]:pad3[0] + ns3[0] * ks3[0]], pad3[1:],
                             ns3[1:], ks3[1:], nbins)
    sh3 = sh3.reshape(ns3[0], ks3[0], *ns3[1:], nbins).sum(1, dtype=torch.int32)
    m3 = V._edge_pad_maps(KC.skimage_maps(sh3, int(np.clip(0.01 * k3e, 1, None)),
                                          k3e))
    sk3 = K3D.clahe3d_skimage_apply(b3, m3, ks3, pad3, x.shape)
    sp3 = K3D.clahe3d_skimage_apply_plain(b3, m3, ks3, pad3, x.shape)
    err = (sk3 - sp3).abs().max().item()
    _require(torch.equal(sk3, sp3), f"K8s differs by up to {err}")
    # per voxel: three weights (3 each), 8 coefficients (2 each), 8
    # multiplies and 7 adds, the floor
    record("K8s", err, lambda: K3D.clahe3d_skimage_apply(b3, m3, ks3, pad3, x.shape),
           lambda: K3D.clahe3d_skimage_apply_plain(b3, m3, ks3, pad3, x.shape),
           8 * npx + 4 * m3.numel(), 41 * npx, plain_iters=5, profiled=True)
    # K8s at nbins 1000 (32 KB of quads a block), the same regions
    b3k = V._skimage3d_binned(x, ks3, 1000)
    sh3k = KC.tile_hists_bins(b3k[pad3[0]:pad3[0] + ns3[0] * ks3[0]], pad3[1:],
                              ns3[1:], ks3[1:], 1000)
    sh3k = sh3k.reshape(ns3[0], ks3[0], *ns3[1:], 1000).sum(1, dtype=torch.int32)
    m3k = V._edge_pad_maps(KC.skimage_maps(
        sh3k, int(np.clip(0.01 * k3e, 1, None)), k3e))
    sk3 = K3D.clahe3d_skimage_apply(b3k, m3k, ks3, pad3, x.shape)
    sp3 = K3D.clahe3d_skimage_apply_plain(b3k, m3k, ks3, pad3, x.shape)
    err = (sk3 - sp3).abs().max().item()
    _require(torch.equal(sk3, sp3), f"K8s at nbins 1000 differs by up to {err}")
    record("K8sn", err,
           lambda: K3D.clahe3d_skimage_apply(b3k, m3k, ks3, pad3, x.shape),
           lambda: K3D.clahe3d_skimage_apply_plain(b3k, m3k, ks3, pad3, x.shape),
           8 * npx + 4 * m3k.numel(), 41 * npx, plain_iters=5, profiled=True)
    for conv, clip in (("opencv", 2.0), ("fraction", 0.01), ("skimage", 0.01)):
        _require(torch.equal(K3D.clahe3d_volume(x, clip, g3, conv),
                             V.clahe3d(x, clip, g3, conv)),
                 f"clahe3d {conv} on the card differs from the plain op")

    # the 1024^2 mammography shapes, batch 8 (w3): K7, and K3 and K4 where
    # the TPU took its pre-padded kernels (rows 21-22)
    MB, MS = 8, 1024
    xm_np = _xray_batch(MB, MS, MS, seed=3)
    xm = torch.from_numpy(xm_np).to(dev)
    npm, at_m = xm.numel(), f"[{MB},{MS},{MS}]"
    gk, gp = KU.unsharp_gauss_cuda(xm, 1.5, 1.0, 1.5), KU.unsharp_gauss_plain(xm, 1.5, 1.0, 1.5)
    err = (gk - gp).abs().max().item()
    _require(torch.equal(gk, gp), f"K7 differs by up to {err}")
    # per pixel: four 13-tap passes (13 multiplies, 12 adds) and the blend (5)
    record("K7", err, lambda: KU.unsharp_gauss_cuda(xm, 1.5, 1.0, 1.5),
           lambda: KU.unsharp_gauss_plain(xm, 1.5, 1.0, 1.5), 8 * npm,
           105 * npm, at=at_m)
    cm = KC.clahe_cuda(xm, 2.0, GRID)
    bkm = KB.bilateral_cuda(cm, 5, 0.1, 1.5, "reflect")
    err = (bkm - F.bilateral_blur(cm, 5, 0.1, 1.5, "reflect")).abs().max().item()
    _require(err <= 2e-6, f"K3 at 1024^2: max abs error {err} > 2e-6")
    record("K3r", err, lambda: KB.bilateral_cuda(cm, 5, 0.1, 1.5, "reflect"),
           lambda: F.bilateral_blur(cm, 5, 0.1, 1.5, "reflect"), 8 * npm,
           _bilateral_ops(5) * npm, at=at_m)
    ukm, upm = KU.unsharp_quant_cuda(bkm, 1.5, 1.0), KU.unsharp_quant_plain(bkm, 1.5, 1.0)
    err = (ukm.int() - upm.int()).abs().max().item()
    _require(torch.equal(ukm, upm), f"K4 at 1024^2 differs by up to {err} levels")
    record("K4r", err, lambda: KU.unsharp_quant_cuda(bkm, 1.5, 1.0),
           lambda: KU.unsharp_quant_plain(bkm, 1.5, 1.0), 5 * npm,
           (4 * 13 + 8) * npm, at=at_m)

    # the 4096^2 slice of the sharded chain (grid 8x8: tiles of 512^2,
    # counted in strips of 16 rows, 32 blocks a tile): K1 to the LUTs twice
    # (the last block of a tile to arrive builds its LUT; repeated calls
    # give equal LUTs), K1 float and bins, K2 in both epilogues, each equal
    # to its plain version; then K5 at every band of a 4-way row split (two
    # tile rows of 512 per band) against those LUTs, in both epilogues: each
    # band equal to the plain version, the stitched bands equal to K2 on
    # the whole slice
    BS, NBANDS = 4096, 4
    xs = torch.from_numpy(_xray_batch(1, BS, BS, seed=5)).to(dev)
    tile_s, hb_s = (BS // GRID[0], BS // GRID[1]), BS // NBANDS
    hs = KC.tile_hists(xs, GRID)
    _require(torch.equal(hs, KC.tile_hists_plain(xs, GRID)),
             "K1 at 4096^2 (tiles counted in strips of rows) differs from plain")
    ls_plain = KC.tile_luts_plain(xs, GRID, 2.0)
    for call in ("first", "second"):
        _require(torch.equal(KC.tile_luts(xs, GRID, 2.0), ls_plain),
                 f"K1 to the LUTs at 4096^2 ({call} call) differs from plain")
    ks_s = H.skimage_kernel_size((BS, BS), GRID)
    (sr0, _, sc0, _), sreg = H.skimage_geometry((BS, BS), ks_s)
    sbins = H._skimage_binned(xs, ks_s, nbins)
    shs = KC.tile_hists_bins(sbins, (sr0, sc0), sreg, ks_s, nbins)
    _require(torch.equal(
        shs, KC.tile_hists_bins_plain(sbins, (sr0, sc0), sreg, ks_s, nbins)),
        "K1 bins at 4096^2 differs from plain")
    luts_s = {"u8norm": ls_plain,
              "clip01": KC.tile_luts(xs, GRID, 0.01, "fraction")}
    for fin, lt in luts_s.items():
        _require(torch.equal(KC.clahe_apply_lut(xs, lt, GRID, fin),
                             KC.clahe_apply_lut_plain(xs, lt, GRID, fin)),
                 f"K2 {fin} at 4096^2 differs from plain")
    n4 = BS * BS
    # K6 on the skimage regions of 512^2 (blocks in strips of 16 rows)
    k_s = ks_s[0] * ks_s[1]
    sms = KC.skimage_maps(shs, int(np.clip(0.01 * k_s, 1, None)), k_s)
    s_args = (ks_s, (sr0, sc0), (BS, BS))
    ak = KC.skimage_apply(sbins, sms, *s_args)
    ap = KC.skimage_apply_plain(sbins, sms, *s_args)
    err = (ak - ap).abs().max().item()
    _require(torch.equal(ak, ap), f"K6 at 4096^2 differs by up to {err}")
    record("K6x", err, lambda: KC.skimage_apply(sbins, sms, *s_args),
           lambda: KC.skimage_apply_plain(sbins, sms, *s_args),
           8 * n4 + 4 * sms.numel(), 16 * n4, plain_iters=5, at=f"[1,{BS},{BS}]",
           profiled=True)
    dev4096 = {
        "K1L": device_ms(lambda: KC.tile_luts(xs, GRID, 2.0)),
        "K1": device_ms(lambda: KC.tile_hists(xs, GRID)),
        "K2": device_ms(lambda: KC.clahe_apply_lut(xs, ls_plain, GRID))}
    print(f"[1, {BS}, {BS}]: K1 to the LUTs (twice), K1 float and bins "
          f"(regions {ks_s}), K2 u8norm and clip01, K6 equal to their plain "
          f"versions | profiler ms: "
          + "; ".join(f"{k} {v:.4f}" for k, v in dev4096.items()) + f" | {card}")
    bands_s = [xs[:, i * hb_s:(i + 1) * hb_s].contiguous() for i in range(NBANDS)]

    def band_apply(fn, fin):
        return [fn(b, luts_s[fin], GRID, tile_s, i * hb_s, fin)
                for i, b in enumerate(bands_s)]

    k5_err = 0.0
    for fin in luts_s:
        got = band_apply(KC.clahe_apply_lut_band, fin)
        for i, (g, w) in enumerate(zip(got, band_apply(KC.clahe_apply_lut_band_plain, fin))):
            k5_err = max(k5_err, (g - w).abs().max().item())
            _require(torch.equal(g, w), f"K5 {fin} band {i} differs from its plain version")
        _require(torch.equal(torch.cat(got, 1), KC.clahe_apply_lut(xs, luts_s[fin], GRID, fin)),
                 f"K5 {fin}: the stitched bands differ from K2 on the whole slice")
    # one call = the 4 bands: 4 B in + 4 B out per pixel, 29 ops per pixel
    record("K5", k5_err, lambda: band_apply(KC.clahe_apply_lut_band, "u8norm"),
           lambda: band_apply(KC.clahe_apply_lut_band_plain, "u8norm"),
           8 * n4 + 4 * luts_s["u8norm"].numel(), 29 * n4,
           plain_iters=5, at=f"[1,{BS},{BS}] in {NBANDS} bands", profiled=True)
    # ragged: a 3-way split of 6 tile rows of 43 at grid (6, 5) (tiles 43 x
    # 67: reciprocals that are not powers of two)
    rgrid, rtile = (6, 5), (43, 67)
    xr = x[:2, :6 * 43, :5 * 67].contiguous()
    for fin, clip, conv in (("u8norm", 2.0, "opencv"),
                            ("clip01", 0.01, "fraction")):
        lr = KC.tile_luts(xr, rgrid, clip, conv)
        parts = []
        for i in range(3):
            b = xr[:, i * 86:(i + 1) * 86].contiguous()
            parts.append(KC.clahe_apply_lut_band(b, lr, rgrid, rtile, i * 86, fin))
            _require(torch.equal(parts[-1], KC.clahe_apply_lut_band_plain(
                b, lr, rgrid, rtile, i * 86, fin)),
                f"K5 {fin} on [2, 258, 335] band {i} differs from its plain version")
        _require(torch.equal(torch.cat(parts, 1), KC.clahe_apply_lut(xr, lr, rgrid, fin)),
                 f"K5 {fin} on [2, 258, 335]: stitched bands differ from K2")
    print(f"K5: {NBANDS} bands of [1, {BS}, {BS}] at grid {GRID} and 3 bands of "
          f"[2, 258, 335] at grid {rgrid}, u8norm and clip01: each band equal "
          f"to its plain version, the stitched bands equal to K2")

    # K13 on the flagship's own K3 input (the CLAHE output) at [32, 512,
    # 512] and at [8, 1024, 1024]: bit-equal to K3 -> K4, and against the
    # plain unfused tail uint8 within 1 level on < 1e-3 of pixels, f32
    # within 2e-6
    kp = (5, 0.1, 1.5, "reflect", 1.5, 1.0)

    def check_k13(inp, want_u8, want_f32, what):
        worst = {}
        for q, want in ((True, want_u8), (False, want_f32)):
            got = KF.bilateral_unsharp_cuda(inp, *kp, q)
            _require(torch.equal(got, want), f"K13 {what} (quantize={q}) differs from K3 -> K4")
            plain = KF.bilateral_unsharp_plain(inp, *kp, q)
            d = (got.float() - plain.float()).abs()
            if q:
                n_off = int((d > 0).sum().item())
                _require(d.max().item() <= 1 and n_off < 1e-3 * d.numel(),
                         f"K13 {what} uint8: {n_off} pixels off the plain tail")
            else:
                _require(d.max().item() <= 2e-6, f"K13 {what} f32: {d.max().item()} > 2e-6")
            worst["u8" if q else "f32"] = d.max().item()
        return worst

    k13_err = check_k13(ck, uk, KU.unsharp_quant_cuda(bk, 1.5, 1.0, quantize=False),
                        f"[{BATCH},{SIZE},{SIZE}]")
    k13m_err = check_k13(cm, ukm, KU.unsharp_quant_cuda(bkm, 1.5, 1.0, quantize=False),
                         at_m)
    # 4 B in + 1 B out per pixel; K3's 136 and K4's 60 operations per pixel
    record("K13", k13_err["u8"], lambda: KF.bilateral_unsharp_cuda(ck, *kp),
           lambda: KF.bilateral_unsharp_plain(ck, *kp), 5 * npx,
           (_bilateral_ops(5) + 4 * 13 + 8) * npx, profiled=True)
    record("K13m", k13m_err["u8"], lambda: KF.bilateral_unsharp_cuda(cm, *kp),
           lambda: KF.bilateral_unsharp_plain(cm, *kp), 5 * npm,
           (_bilateral_ops(5) + 4 * 13 + 8) * npm, at=at_m, profiled=True)
    print(f"K13: == K3 -> K4 at [{BATCH},{SIZE},{SIZE}] and {at_m}, both quantize "
          f"modes; max abs vs the plain tail {k13_err} / {k13m_err}")
    k3k4 = rec_dev["K3"] + rec_dev["K4"]
    print(f"K13 {rec_dev['K13']:.4f} ms by the profiler against K3 + K4 "
          f"{k3k4:.4f} ({rec_dev['K3']:.4f} + {rec_dev['K4']:.4f}) "
          f"[{BATCH},{SIZE},{SIZE}]; {rec_dev['K13m']:.4f} {at_m} | {card}")

    torch.cuda.synchronize()
    for k, r in rec.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        prof = f" (profiler {rec_dev[k]:.4f} ms)" if k in rec_dev else ""
        print(f"{k} {rec_at[k]}: max_abs_err {r['max_abs_err']} | "
              f"kernel {r['ms']:.4f} ms{prof} | plain {r['plain_ms']:.4f} ms | "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | library "
              f"{lib} | {card}")

    # the ragged edge: 251x333 slices, every border mode of K3, the
    # skimage regions 31x41 (odd region columns, kc % 64 != 0), K9-K12
    r = x[:1, :251, :333].contiguous()
    _require(torch.equal(KC.clahe_cuda(r, 2.0, GRID), H.clahe(r, 2.0, GRID)),
             "K1 (to the LUTs) + K2 on 251x333 differ from the plain CLAHE")
    _require(torch.equal(KC.clahe_cuda(r, 0.01, GRID, "fraction"),
                         H.clahe(r, 0.01, GRID, "fraction")),
             "K1+K2 clip01 (fraction) on 251x333 differ from the plain CLAHE")
    # one ragged axis: cv2 pads both axes (a full tile on the even one);
    # K1 to the LUTs -> K2 against cv2's output hashes, and the fraction
    # convention (the JAX package's pad rule) against its plain version
    for shape, digest in CV2_CLAHE_SHA256.items():
        u = (torch.from_numpy(cv2_noise(shape).astype(np.float32)).to(dev)
             / torch.tensor(255.0, device=dev))  # a true division
        got = KC.clahe_cuda(u[None].contiguous(), 2.0, GRID)
        lv = torch.clamp(torch.round(got[0] * 255.0), 0, 255).to(torch.uint8)
        _require(levels_sha256(lv.cpu().numpy()) == digest,
                 f"K1+K2 on {shape} differ from cv2.createCLAHE "
                 f"({int((got != H.clahe(u[None], 2.0, GRID)).sum())} pixels "
                 f"off the plain CLAHE)")
        _require(torch.equal(KC.clahe_cuda(u[None].contiguous(), 0.01, GRID,
                                           "fraction"),
                             H.clahe(u[None], 0.01, GRID, "fraction")),
                 f"K1+K2 fraction on {shape} differ from the plain CLAHE")
    print(f"K1 (to the LUTs) + K2 opencv equal to cv2.createCLAHE(2.0, (8, 8)) at "
          f"{sorted(CV2_CLAHE_SHA256)} (one ragged axis); fraction equal to "
          f"plain")
    rks = H.skimage_kernel_size(r.shape[-2:], GRID)
    (rp0, _, rq0, _), rreg = H.skimage_geometry(r.shape[-2:], rks)
    rb = H._skimage_binned(r, rks, nbins)
    rh = KC.tile_hists_bins(rb, (rp0, rq0), rreg, rks, nbins)
    _require(torch.equal(rh, KC.tile_hists_bins_plain(rb, (rp0, rq0), rreg,
                                                      rks, nbins)),
             "K1 bins on 251x333 differs from the plain version")
    rclim = int(np.clip(0.01 * rks[0] * rks[1], 1, None))
    rm = KC.skimage_maps(rh, rclim, rks[0] * rks[1])
    _require(torch.equal(rm, KC.skimage_maps_plain(rh, rclim, rks[0] * rks[1])),
             "K6a on 251x333 differs from the plain version")
    _require(torch.equal(
        KC.skimage_apply(rb, rm, rks, (rp0, rq0), r.shape[-2:]),
        KC.skimage_apply_plain(rb, rm, rks, (rp0, rq0), r.shape[-2:])),
        "K6 on 251x333 differs from the plain version")
    _require(torch.equal(KC.clahe_skimage_cuda(r, rks, 0.01),
                         H.clahe(r, 0.01, GRID, "skimage")),
             "skimage path on 251x333 differs from the plain CLAHE")
    # K3 (strips of 128 columns walking 32 rows, pair weights in rings of
    # r + 1 rows) at every k and border, and K4 at its register radii (1.5,
    # 1.0) and a shared-memory one (4.0: r 16), below, across and beyond one
    # strip and run
    worst = 0.0
    for h_, w_ in ((1, 1), (3, 5), (130, 77), (251, 333), (513, 511)):
        t = xm[:2, :h_, :w_].contiguous()
        for mode in ("reflect", "mirror", "nearest"):
            for k in (3, 5, 7, 9):
                e = (KB.bilateral_cuda(t, k, 0.1, 1.5, mode)
                     - F.bilateral_blur(t, k, 0.1, 1.5, mode)).abs().max().item()
                _require(e <= 2e-6, f"K3 {mode} k={k} on {h_}x{w_}: {e} > 2e-6")
                worst = max(worst, e)
        for radius in (1.0, 1.5, 4.0):
            for q in (True, False):
                _require(torch.equal(KU.unsharp_quant_cuda(t, radius, 1.0, quantize=q),
                                     KU.unsharp_quant_plain(t, radius, 1.0, quantize=q)),
                         f"K4 radius {radius} (quantize={q}) on {h_}x{w_} differs "
                         f"from the plain version")
    for mode in ("reflect", "mirror", "nearest"):
        for q in (True, False):
            _require(torch.equal(
                KF.bilateral_unsharp_cuda(r, 5, 0.1, 1.5, mode, 1.5, 1.0, q),
                KU.unsharp_quant_cuda(KB.bilateral_cuda(r, 5, 0.1, 1.5, mode),
                                      1.5, 1.0, quantize=q)),
                f"K13 {mode} (quantize={q}) on 251x333 differs from K3 -> K4")
    rag = {}
    r2 = ctw[:2, :251, :333].contiguous()
    rn = KN.nl_means_cuda(r2, *nlm)
    rag["K11"] = within(rn, R.denoise_nl_means(r2, *nlm), 1e-6,
                        "K11 on 251x333")[0]
    # even s = 4 (runs as 5), d = 0 (no pair: out = u) and s = 9 (the box
    # loops at a runtime s), on the ragged slices; bit-equal flags printed
    k11_eq = {}
    for kw in ((4, 6, 0.06, 0.04), (5, 0, 0.06, 0.04), (9, 3, 0.08, 0.02)):
        e_, k11_eq[f"s{kw[0]} d{kw[1]}"] = within(
            KN.nl_means_cuda(r2, *kw), R.denoise_nl_means(r2, *kw), 1e-6,
            f"K11 s={kw[0]} d={kw[1]} on 251x333")
        rag[f"K11 s{kw[0]} d{kw[1]}"] = e_
    print(f"K11 on 251x333 bit-equal to plain: {k11_eq}")
    rt, rt_iters = KT.denoise_tv_cuda(rn, *tvp, return_iters=True)
    rp, rp_iters = R.tv_chambolle(rn, *tvp)
    rag["K12"] = within(rt, rp, 2e-6, "K12 on 251x333")[0]
    _require(torch.equal(rt_iters, rp_iters),
             f"K12 on 251x333: stop iterations {rt_iters.tolist()} != plain "
             f"{rp_iters.tolist()}")
    ru = usf[:2, :251, :333].contiguous()
    rag["K10"] = within(KD.srad_cuda(ru, *srp), R.srad(ru, *srp), 1e-6,
                        "K10 on 251x333")[0]
    for niter in (pmp[0], 7):
        for opt in (1, 2):
            pm = (niter, *pmp[1:3], opt)
            what = f"K9 niter {niter} option {opt} on 251x333"
            rag[f"K9 niter {niter} option {opt}"], eq = within(
                KD.anisotropic_diffusion_cuda(r, *pm),
                R.anisotropic_diffusion(r, *pm), 1e-6, what)
            _require(eq, f"{what} differs from the plain version")
    rv = x[:12, :96, :160].contiguous()  # tw = 32, gy = 3
    for conv, clip in (("opencv", 2.0), ("fraction", 0.01)):
        _require(torch.equal(K3D.clahe3d_cuda(rv, clip, (3, 3, 5), conv),
                             V.clahe3d(rv, clip, (3, 3, 5), conv)),
                 f"K1+K8 {conv} on [12, 96, 160] differ from the plain op")
    rs = x[:20, :251, :333].contiguous()
    rks3 = V.skimage3d_kernel_size(rs.shape, g3)
    _require(torch.equal(K3D.clahe3d_skimage_cuda(rs, rks3, 0.01),
                         V.clahe3d(rs, 0.01, g3, "skimage")),
             "skimage 3-D path (K1 bins, K6a, K8s) on [20, 251, 333] differs")
    # K8s alone at a width W % 4 != 0 (scalar columns; x0 = 10)
    ru3 = x[:12, :96, :166].contiguous()
    uks3 = V.skimage3d_kernel_size(ru3.shape, g3)
    upad3, _, uns3 = V.skimage3d_geometry(ru3.shape, uks3)
    ub3 = V._skimage3d_binned(ru3, uks3, nbins)
    uk3e = uks3[0] * uks3[1] * uks3[2]
    uh3 = KC.tile_hists_bins(ub3[upad3[0]:upad3[0] + uns3[0] * uks3[0]],
                             upad3[1:], uns3[1:], uks3[1:], nbins)
    uh3 = uh3.reshape(uns3[0], uks3[0], *uns3[1:], nbins).sum(1, dtype=torch.int32)
    um3 = V._edge_pad_maps(KC.skimage_maps(uh3, max(uk3e // 100, 1), uk3e))
    _require(torch.equal(
        K3D.clahe3d_skimage_apply(ub3, um3, uks3, upad3, ru3.shape),
        K3D.clahe3d_skimage_apply_plain(ub3, um3, uks3, upad3, ru3.shape)),
        f"K8s on [12, 96, 166] (regions {uks3}) differs from plain")
    _require(torch.equal(KU.unsharp_gauss_cuda(r, 1.5, 1.0, 1.5),
                         KU.unsharp_gauss_plain(r, 1.5, 1.0, 1.5)),
             "K7 on 251x333 differs from the plain pair")
    torch.cuda.synchronize()
    print(f"ragged volumes: K1+K8 equal on [12, 96, 160] at grid (3, 3, 5) "
          f"(opencv, fraction), skimage 3-D path equal on [20, 251, 333] "
          f"(regions {rks3}), K8s equal on [12, 96, 166] (regions {uks3}); "
          f"K7 equal on 251x333")
    print(f"ragged 251x333: K1+K2 equal (opencv, fraction/clip01), skimage "
          f"regions {rks[0]}x{rks[1]} x {rreg[0]}x{rreg[1]}: K1 bins, K6a, "
          f"K6 and the path equal, K3 max abs {worst} (3 modes x k 3/5/7/9 "
          f"at 1x1, 3x5, 130x77, 251x333, 513x511), K4 equal (radii 1.0, "
          f"1.5, 4.0, both quantize modes, the same shapes), K13 == K3 -> "
          f"K4 (3 modes); max abs {rag}, K12 stop "
          f"iterations {rt_iters.tolist()}"
          f" (plain {rp_iters.tolist()})")

    # -- 4. the slices through the port's entry points ------------------
    def plain_chain(cfg, batch: torch.Tensor) -> torch.Tensor:
        y = _ingest(batch)
        for s in cfg.stages:
            y = OP_REGISTRY[s.op](y, **s.kwargs())
        return _quantize_u8(y)

    def close(out, ref, what):
        d = (out.int() - ref.int()).abs()
        n = int((d > 0).sum().item())
        _require(d.max().item() <= 1 and n < 1e-3 * d.numel(),
                 f"{what}: {n} pixels differ (max {d.max().item()} levels)")
        return n, d.numel()

    def drive(cfg, name, inputs, want):
        """Call the batched chain on each input with the counts set to 0
        just before and read just after; every kernel of the path must
        launch exactly as often as ``want`` says (a name alone: once) and
        no other kernel at all."""
        fn = compile_pipeline(cfg, batched=True)
        want = want if isinstance(want, dict) else dict.fromkeys(want, 1)
        counts = None
        for dtype, inp in inputs:
            _build.reset_launches()
            out = fn(inp)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            expect = {k: want.get(k, 0) for k in counts}
            _require(counts == expect, f"{name} {dtype}: launches {counts}, "
                     f"want {expect}")
            _require(out.shape == inp.shape and out.dtype == torch.uint8,
                     f"{name} {dtype} output {tuple(out.shape)} {out.dtype}")
            n, total = close(out, plain_chain(cfg, inp), f"{name} {dtype}")
            print(f"slice {name} {dtype} {list(inp.shape)}: launches "
                  f"{ {k: v for k, v in counts.items() if v} } | vs plain "
                  f"chain on the card: {n} of {total} pixels differ by 1 level")
        return fn, counts

    x8 = _quantize_u8(x)
    both = (("float32", x), ("uint8", x8))
    cfg = flagship_config()
    fn, launches = drive(cfg, "flagship", both,
                         ("tile_luts", "clahe_apply_lut", "bilateral",
                          "unsharp_quant"))
    kw = cfg.stages[0].kwargs()
    _require(torch.equal(KC.clahe_batched(x, **kw), H.clahe(x, **kw)),
             "CLAHE stage (K1 to the LUTs + K2) differs from the plain CLAHE")
    out = fn(x)
    cpu = compile_pipeline(cfg, batched=True, device="cpu")(x[:2].cpu())
    n, total = close(out[:2].cpu(), cpu, "flagship card vs CPU reference")
    fout = compile_pipeline(cfg, batched=True, quantize=False)(x)
    _require(bool(torch.isfinite(fout).all()) and fout.min().item() >= 0.0
             and fout.max().item() <= 1.0, "float output not finite in [0, 1]")
    _require(torch.equal(compile_pipeline(cfg)(x[1]), out[1]),
             "single-slice output differs from the batched row")
    lat_out = compile_pipeline(latency_config(), batched=True)(x)
    _require(lat_out.shape == x.shape and lat_out.dtype == torch.uint8,
             "latency_config output shape/dtype")
    torch.cuda.synchronize()
    print(f"flagship checks: CLAHE stage == plain, card vs CPU plain chain "
          f"{n} of {total} pixels differ, float output finite in [0,1], "
          f"single == batched row, latency_config runs")
    # the uint8 output's hash, to hold two versions of the chain to each
    # other on the same card
    print(f"flagship uint8 sha256 [{BATCH},{SIZE},{SIZE}] X-ray seed 0: "
          f"{levels_sha256(out.cpu().numpy())}")

    sk_cfg = load_config(repo / "configs" / "xray_adapthist_skimage.yaml")
    sk_fn, sk_launches = drive(sk_cfg, "skimage yaml", both,
                               ("tile_hists_bins", "skimage_maps",
                                "skimage_apply", "unsharp_quant"))
    kw = sk_cfg.stages[0].kwargs()
    _require(torch.equal(KC.clahe_batched(x, **kw), H.clahe(x, **kw)),
             "skimage CLAHE stage (K1 bins + K6a + K6) differs from plain")
    out = sk_fn(x8)
    cpu = compile_pipeline(sk_cfg, batched=True, device="cpu")(x8[:2].cpu())
    n, total = close(out[:2].cpu(), cpu, "skimage card vs CPU reference")
    _require(torch.equal(compile_pipeline(sk_cfg)(x8[1]), out[1]),
             "skimage single-slice output differs from the batched row")
    print(f"skimage checks: CLAHE stage == plain, card vs CPU plain chain "
          f"{n} of {total} pixels differ, single == batched row")

    tail = ("unsharp_mask", {"radius": 1.0, "amount": 0.6})
    fr_cfg = PipelineConfig.make(
        [("clahe", {"clip_limit": 0.01, "grid_size": GRID,
                    "convention": "fraction"}), tail], name="fraction")
    _, fr_launches = drive(fr_cfg, "fraction", both[:1],
                           ("tile_hists", "clahe_apply_lut", "unsharp_quant"))
    ko_cfg = PipelineConfig.make(
        [("clahe", {"clip_limit": 40.0, "grid_size": GRID,
                    "convention": "kornia"}), tail], name="kornia")
    drive(ko_cfg, "kornia (plain torch CLAHE)", both[:1], ("unsharp_quant",))

    # the restoration chains: NL-means one launch, TV three per chunk of
    # KT.STEPS iterations, SRAD one per chunk of KD.STEPS, Perona-Malik one
    # per chunk of KD.PM_STEPS, CLAHE K1 (to the LUTs) and K2 once
    clahe_k = {"tile_luts": 1, "clahe_apply_lut": 1}
    ct_cfg = load_config(repo / "configs" / "ct_lowdose_nlm.yaml")
    ct_fn, ct_launches = drive(ct_cfg, "ct_lowdose_nlm yaml", (("int16", ct),),
                               {"nl_means": 1,
                                "tv": KT.launches_per_call(tvp[2]), **clahe_k})
    out = ct_fn(ct)
    cpu = compile_pipeline(ct_cfg, batched=True, device="cpu")(ct[:2].cpu())
    n, total = close(out[:2].cpu(), cpu, "CT card vs CPU reference")
    _require(torch.equal(compile_pipeline(ct_cfg)(ct[1]), out[1]),
             "CT single-slice output differs from the batched row")
    print(f"CT checks: card vs CPU plain chain {n} of {total} pixels differ, "
          f"single == batched row")
    us_cfg = load_config(repo / "configs" / "ultrasound_despeckle.yaml")
    _, us_launches = drive(us_cfg, "ultrasound_despeckle yaml",
                           (("uint8", us),),
                           {"srad": KD.launches_per_call(srp[0]), **clahe_k})
    # BASELINE w10 (int16 in), w9 and w8 (float32 in), as
    # benchmarks/workloads.py defines them
    w10_cfg = PipelineConfig.make(
        [("window_hu", {"center": 40.0, "width": 400.0}),
         ("denoise_nl_means", {"patch_size": nlm[0], "patch_distance": nlm[1],
                               "h": nlm[2], "sigma": nlm[3]})], name="w10")
    drive(w10_cfg, "w10 window+nl_means", (("int16", ct),), {"nl_means": 1})
    w9_cfg = PipelineConfig.make(
        [("srad", {"niter": srp[0], "dt": srp[1]}),
         ("clahe", {"clip_limit": 2.0, "grid_size": GRID,
                    "convention": "opencv"})], name="w9")
    drive(w9_cfg, "w9 srad+clahe", (("float32", usf),),
          {"srad": KD.launches_per_call(srp[0]), **clahe_k})
    w8_cfg = PipelineConfig.make(
        [("anisotropic_diffusion", {"niter": pmp[0], "kappa": pmp[1],
                                    "gamma": pmp[2]}),
         ("musica", {"levels": 5, "p": 0.6, "gain": 1.5})], name="w8")
    _, w8_launches = drive(w8_cfg, "w8 diffusion+musica", (("float32", x),),
                           {"perona_malik": KD.pm_launches_per_call(pmp[0])})

    # the 1024^2 mammography chains at batch 8: w3 (K7 once, no K4), the
    # uint16 mammogram config (plain Gaussian, then K4) and the flagship
    # (K3 and K4 at the shape where the TPU took its pre-padded kernels)
    xm16 = torch.from_numpy(np.rint(xm_np * 65535.0).astype(np.uint16)).to(dev)
    w3_cfg = PipelineConfig.make(
        [("unsharp_mask", {"radius": 1.5, "amount": 1.0}),
         ("gaussian_blur", {"sigma": 1.5})], name="w3")
    _, w3_launches = drive(w3_cfg, "w3 unsharp+gaussian", (("float32", xm),),
                           {"unsharp_gauss": 1})
    mm_cfg = load_config(repo / "configs" / "mammogram_sharpen.yaml")
    _, mm_launches = drive(mm_cfg, "mammogram_sharpen yaml", (("uint16", xm16),),
                           {"unsharp_quant": 1})
    _, fm_launches = drive(flagship_config(), "flagship 1024^2",
                           (("float32", xm),),
                           ("tile_luts", "clahe_apply_lut", "bilateral",
                            "unsharp_quant"))

    # the chains of the intensity, global-equalization, median, guided and
    # morphology ops (plain PyTorch): K1 to the LUTs, K2 and K4 once each in
    # the two CT configs, K3 once in w4, no hand kernel in the other four;
    # each output equal to its plain chain on the card, single == batched row
    hu64 = torch.from_numpy(_ct_batch(64, SIZE, SIZE, seed=4)).to(dev)
    xm8 = _quantize_u8(xm)
    w1_cfg = PipelineConfig.make(
        [("equalize_hist", {}), ("adjust_gamma", {"gamma": 0.8})], name="w1")
    w4_cfg = PipelineConfig.make(
        [("window_hu", {"center": 40.0, "width": 400.0}),
         ("median_blur", {"kernel_size": 3}),
         ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                             "sigma_space": 1.5})], name="w4")
    w7_cfg = PipelineConfig.make(
        [("median_blur", {"kernel_size": 3}),
         ("top_hat", {"kernel_size": 7, "shape": "ellipse"}),
         ("rescale_intensity", {"out_range": (0.0, 1.0)})], name="w7")
    ct_tail = {"tile_luts": 1, "clahe_apply_lut": 1, "unsharp_quant": 1}
    new_chains = (
        ("histeq_baseline yaml", load_config(repo / "configs" /
                                             "histeq_baseline.yaml"),
         "uint8", x8, {}),
        ("w1 histeq+gamma", w1_cfg, "float32", x[:1], {}),
        ("ct_soft_tissue yaml", load_config(repo / "configs" /
                                            "ct_soft_tissue.yaml"),
         "int16", ct, ct_tail),
        ("ct_guided_denoise yaml", load_config(repo / "configs" /
                                               "ct_guided_denoise.yaml"),
         "int16", ct, ct_tail),
        ("w4 window+median+bilateral", w4_cfg, "int16", hu64, {"bilateral": 1}),
        ("mammo_microcalc_tophat yaml", load_config(
            repo / "configs" / "mammo_microcalc_tophat.yaml"), "uint8", xm8, {}),
        ("w7 median+tophat+rescale", w7_cfg, "float32", x, {}),
    )
    for name, c, dtype, inp, want in new_chains:
        fn, _ = drive(c, name, ((dtype, inp),), want)
        out = fn(inp)
        _require(torch.equal(out, plain_chain(c, inp)),
                 f"{name}: output differs from the plain chain on the card")
        _require(torch.equal(compile_pipeline(c)(inp[-1]), out[-1]),
                 f"{name}: single-slice output differs from the batched row")
    w7_card = levels_sha256(compile_pipeline(w7_cfg, batched=True)(x).cpu()
                            .numpy())
    w7_cpu = levels_sha256(compile_pipeline(w7_cfg, batched=True, device="cpu")(
        x.cpu()).numpy())
    _require(w7_card == w7_cpu, f"w7 uint8 sha256 on the card {w7_card} != "
             f"the CPU plain chain's {w7_cpu}")
    torch.cuda.synchronize()
    print(f"new chains: each equal to its plain chain on the card, single == "
          f"batched row; w7 uint8 sha256 [{BATCH},{SIZE},{SIZE}] X-ray seed 0: "
          f"{w7_card} on the card == the CPU plain chain's")

    # the chains of the frequency, wavelet and ridge ops (plain PyTorch;
    # torch.fft runs cuFFT): K4 once in the homomorphic config, K1 to the
    # LUTs and K2 once in the wavelet config (denoise_wavelet at level 4),
    # no hand kernel in the angiography config. Each output equal to its
    # plain chain on the card; against the CPU plain chain (cuFFT and CUDA's
    # expf / logf round unlike the CPU) and its own single-slice call (a
    # batched FFT plan need not round as one slice's) within 1 level on
    # < 1e-3 of pixels
    ang = torch.from_numpy(_angio_batch(BATCH, SIZE, SIZE, seed=14)).to(dev)
    chains14 = (
        ("xray_homomorphic yaml", load_config(repo / "configs" /
                                              "xray_homomorphic.yaml"),
         "uint8", x8, {"unsharp_quant": 1}),
        ("xray_wavelet_denoise yaml", load_config(
            repo / "configs" / "xray_wavelet_denoise.yaml"), "float32", x,
         clahe_k),
        ("angio_vessel_enhance yaml", load_config(
            repo / "configs" / "angio_vessel_enhance.yaml"), "uint8", ang, {}),
    )
    _require(WV.default_levels((SIZE, SIZE), 4) == 4,
             "db2 at 512^2 should decompose 4 levels")
    for name, c, dtype, inp, want in chains14:
        fn, _ = drive(c, name, ((dtype, inp),), want)
        out = fn(inp)
        _require(torch.equal(out, plain_chain(c, inp)),
                 f"{name}: output differs from the plain chain on the card")
        cpu = compile_pipeline(c, batched=True, device="cpu")(inp[:4].cpu())
        n, total = close(out[:4].cpu(), cpu, f"{name} card vs CPU plain chain")
        single = compile_pipeline(c)(inp[-1])
        n1, total1 = close(single[None], out[-1:], f"{name} single vs batched")
        print(f"{name}: == plain chain on the card; card vs CPU plain chain "
              f"[4,{SIZE},{SIZE}] {n} of {total} pixels differ by 1 level; "
              f"single vs batched row {n1} of {total1}")

    # the other ops of those modules, once each on the card against the CPU
    # (b4 512^2; cycle_spin b2): bounds as stated, hessian off frangi's
    # knife edge (a pixel there may be ~0 on one side and 1 on the other)
    xb = x[:4]
    op_checks = (
        ("butterworth", lambda t: FQ.butterworth(t, 0.02, npad=16), xb, 2e-5),
        ("sato", lambda t: RG.sato(t), xb, 2e-6),
        ("meijering", lambda t: RG.meijering(t), xb, 2e-6),
        ("hessian", lambda t: RG.hessian(t, sigmas=(1.0, 3.0)), xb, 1e-5),
        ("cycle_spin", lambda t: WV.cycle_spin(t, max_shifts=3, wavelet="db2"),
         x[:2], 2e-6),
    )
    for name, op, inp, tol in op_checks:
        card_out = op(inp)
        cpu_out = op(inp.cpu())
        d = (card_out.cpu() - cpu_out).abs()
        off = d > tol
        if name == "hessian":
            a, b = card_out.cpu()[off], cpu_out[off]
            _require(bool((((a == 1.0) & (b.abs() <= 2e-6))
                           | ((b == 1.0) & (a.abs() <= 2e-6))).all()),
                     "hessian: card and CPU differ off the knife edge")
            knife = int(off.sum())
            dmax = d[~off].max().item()
        else:
            _require(not bool(off.any()), f"{name}: card vs CPU max abs "
                     f"{d.max().item():.3g} > {tol}")
            knife, dmax = 0, d.max().item()
        _require(bool(torch.isfinite(card_out).all()), f"{name} not finite")
        print(f"op {name} {list(inp.shape)}: card vs CPU max abs {dmax:.3g} "
              f"(bound {tol})" + (f", {knife} knife-edge pixels" if knife
                                  else ""))

    # the volume chains through compile_volume_pipeline: the stages in plain
    # PyTorch on the card are the reference, as for the slices
    def plain_volume(cfg, vol, quantize=True):
        y = vol
        for s in cfg.stages:
            y = OP_REGISTRY[s.op](y, **s.kwargs())
        return _quantize_u8(y) if quantize else y

    def drive_volume(cfg, name, vol, want, quantize=True):
        """One call of the volume program with the counts set to 0 just
        before and read just after: each kernel of ``want`` exactly once
        and no other kernel."""
        fn = compile_volume_pipeline(cfg, quantize=quantize)
        _build.reset_launches()
        out = fn(vol)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        expect = {k: int(k in want) for k in counts}
        _require(counts == expect, f"{name}: launches {counts}, want {expect}")
        _require(out.shape == vol.shape and out.dtype == (
            torch.uint8 if quantize else torch.float32),
            f"{name} output {tuple(out.shape)} {out.dtype}")
        ref = plain_volume(cfg, vol, quantize)
        if quantize:
            n, total = close(out, ref, name)
            vs = f"{n} of {total} voxels differ by 1 level"
        else:
            _require(torch.equal(out, ref), f"{name}: differs from plain")
            vs = "equal"
        print(f"volume {name} {vol.dtype} {list(vol.shape)}: launches "
              f"{ {k: v for k, v in counts.items() if v} } | vs plain chain "
              f"on the card: {vs}")
        return fn, counts

    ctv_cfg = load_config(repo / "configs" / "ct_volume_3d.yaml")
    ctv_fn, ctv_launches = drive_volume(ctv_cfg, "ct_volume_3d yaml", ctv,
                                        ("tile_hists", "clahe3d_apply"))
    crop = ctv[112:144, 192:320, 192:320].contiguous()
    cpu = compile_volume_pipeline(ctv_cfg, device="cpu")(crop.cpu())
    n, total = close(ctv_fn(crop).cpu(), cpu, "CT volume card vs CPU reference")
    print(f"CT volume checks: card vs CPU plain chain on a [32, 128, 128] "
          f"crop {n} of {total} voxels differ")
    w6_cfg = PipelineConfig.make(
        [("clahe3d", {"clip_limit": 2.0, "grid_size": g3,
                      "convention": "opencv"})], name="w6")
    w6vol = make_batch(w6_cfg, (SIZE, SIZE), BATCH, dev)
    drive_volume(w6_cfg, "w6 clahe3d opencv", w6vol,
                 ("tile_hists", "clahe3d_apply"), quantize=False)
    fr3_cfg = PipelineConfig.make(
        [("clahe3d", {"clip_limit": 0.01, "grid_size": g3,
                      "convention": "fraction"})], name="clahe3d-fraction")
    _, fr3_launches = drive_volume(fr3_cfg, "clahe3d fraction", x,
                                   ("tile_hists", "clahe3d_apply"))
    sk3_cfg = PipelineConfig.make(
        [("clahe3d", {"clip_limit": 0.01, "grid_size": g3,
                      "convention": "skimage"})], name="clahe3d-skimage")
    _, sk3_launches = drive_volume(sk3_cfg, "clahe3d skimage", x,
                                   ("tile_hists_bins", "skimage_maps",
                                    "clahe3d_skimage_apply"))

    # the row-sharded flagship for real: an NCCL process group of one rank on
    # a file:// store in a temporary directory, a 1 x 1 mesh, the 4096^2
    # slice through spatial_shard_apply and a batch of 8 through
    # batch_spatial_shard_apply; each equal to compile_pipeline's uint8
    # output, its launches counted (K1 to the LUTs, K5, K3, K4 once per
    # call) and timed
    xb8 = torch.stack([torch.roll(xs[0], (517 * k, 311 * k), (0, 1))
                       for k in range(8)])
    shard_want = {"tile_luts": 1, "clahe_apply_lut_band": 1, "bilateral": 1,
                  "unsharp_quant": 1}
    sharded = {}
    with tempfile.TemporaryDirectory() as store:
        init_distributed(f"file://{store}/store", 1, 0, device="cuda")
        try:
            mesh = make_mesh(1, 1)
            for name, fn_s, inp in (
                    ("spatial_shard_apply", spatial_shard_apply(cfg, mesh), xs[0]),
                    ("batch_spatial_shard_apply",
                     batch_spatial_shard_apply(cfg, mesh), xb8)):
                _build.reset_launches()
                out_s = fn_s(inp)
                torch.cuda.synchronize()
                counts = dict(_build.LAUNCHES)
                expect = {k: shard_want.get(k, 0) for k in counts}
                _require(counts == expect, f"{name}: launches {counts}, want {expect}")
                ref_fn = compile_pipeline(cfg, batched=inp.dim() == 3)
                _require(out_s.dtype == torch.uint8 and torch.equal(out_s, ref_fn(inp)),
                         f"{name} on {list(inp.shape)} differs from compile_pipeline")
                sharded[name] = (counts, _ms(lambda: fn_s(inp), 10),
                                 _ms(lambda: ref_fn(inp), 10), list(inp.shape))
            shard_prof = _profile(spatial_shard_apply(cfg, mesh), xs[0], 10, dev)
            plain_prof = _profile(compile_pipeline(cfg), xs[0], 10, dev)
        finally:
            dist.destroy_process_group()
    shard_launches = sharded["spatial_shard_apply"][0]
    for name, (counts, ms_s, ms_ref, shp) in sharded.items():
        print(f"sharded {name} {shp} (NCCL, world 1, mesh 1x1): launches "
              f"{ {k: v for k, v in counts.items() if v} } | == compile_pipeline "
              f"| {ms_s:.4f} ms/call (compile_pipeline {ms_ref:.4f} ms) | {card}")
    for label, prof in (("spatial_shard_apply", shard_prof),
                        ("compile_pipeline", plain_prof)):
        print(f"profile {label} [{BS}, {BS}]: device "
              f"{prof['device_ms_per_call']:.4f} ms of {prof['ms_per_call']:.4f} "
              f"ms/call (busy {prof['busy_share']:.1%}), "
              f"{prof['device_launches_per_call']:g} device launches per call"
              f" | top ms: "
              + "; ".join(f"{n[:48]} {v:.4f}" for n, v in
                          list(prof["by_kernel"].items())[:8])
              + " | by host op: " + "; ".join(
                  f"{n} {v:.4f}" for n, v in list(prof["by_op"].items())[:6])
              + f" | {card}")

    # the least time of K1-K5's work on the 4096^2 slice, beside the times
    # the profile above gives them (K1 and K2 as at 512^2: float levels in,
    # 8x8 tiles; K3 k 5, K4 r 6)
    lut4 = GRID[0] * GRID[1] * 256
    print("bounds [1, 4096, 4096]: " + "; ".join(
        f"{k} {ms:.4f} ms ({by})" for k, (ms, by) in (
            ("K1 to the LUTs", _bound(4 * n4 + 4 * lut4, 5 * n4 + 20 * lut4)),
            ("K1", _bound(4 * n4 + 4 * lut4, 5 * n4)),
            ("K2", _bound(8 * n4 + 4 * lut4, 29 * n4)),
            ("K5 (4 bands)", _bound(8 * n4 + 4 * lut4, 29 * n4)),
            ("K3", _bound(8 * n4, _bilateral_ops(5) * n4)),
            ("K4", _bound(5 * n4, (4 * 13 + 8) * n4)))) + f" | {card}")

    # -- 5. timing ----------------------------------------------------------
    tp = time_pipeline(flagship_config(), (SIZE, SIZE), BATCH, device=dev)
    tsk = time_pipeline(sk_cfg, (SIZE, SIZE), BATCH, device=dev)
    # 200 samples: the p95 has 10 samples beyond it
    lat = time_latency(flagship_config(), (SIZE, SIZE), repeats=200, device=dev)
    lat2 = time_latency(latency_config(), (SIZE, SIZE), repeats=200, device=dev)
    tct = time_pipeline(ct_cfg, device=dev, batch=ct)
    # the other restoration chains timed once each (one run of 10 calls)
    once = {"iters": 10, "warmup": 2, "repeats": 1, "device": dev}
    tus = time_pipeline(us_cfg, batch=us, **once)
    tw10 = time_pipeline(w10_cfg, batch=ct, **once)
    tw9 = time_pipeline(w9_cfg, batch=usf, **once)
    tw8 = time_pipeline(w8_cfg, batch=x, **once)
    tw3 = time_pipeline(w3_cfg, batch=xm, **once)
    tmm = time_pipeline(mm_cfg, batch=xm16, **once)
    tfm = time_pipeline(flagship_config(), batch=xm, **once)
    tnew = [(name, dtype, c, inp, time_pipeline(c, batch=inp, **once))
            for name, c, dtype, inp, _ in (*new_chains, *chains14)]
    vonce = {"iters": 10, "warmup": 2, "repeats": 1, "device": dev}
    tw6 = time_volume(w6_cfg, vol=w6vol, quantize=False, **vonce)
    tctv = time_volume(ctv_cfg, vol=ctv, **vonce)
    tsk3 = time_volume(sk3_cfg, vol=x, **vonce)
    torch.cuda.synchronize()
    for label, t in (("flagship", tp), ("skimage yaml", tsk),
                     ("ct_lowdose_nlm yaml int16", tct),
                     ("ultrasound_despeckle yaml uint8", tus),
                     ("w10 window+nl_means int16", tw10),
                     ("w9 srad+clahe float32", tw9),
                     ("w8 diffusion+musica float32", tw8),
                     ("w3 unsharp+gaussian float32", tw3),
                     ("mammogram_sharpen yaml uint16", tmm),
                     ("flagship 1024^2 float32", tfm),
                     *[(f"{name} {dtype}", t) for name, dtype, _, _, t in tnew]):
        print(f"throughput {label} b{t['batch_size']} {t['shape'][0]}^2: "
              f"{t['slices_per_sec']:.1f} slices/s | {t['ms_per_batch']:.4f} "
              f"ms/batch | {card}")
    for label, t in (("w6 clahe3d opencv float32", tw6),
                     ("ct_volume_3d yaml int16", tctv),
                     ("clahe3d skimage float32", tsk3)):
        print(f"throughput {label} {t['shape']}: {t['z_slices_per_sec']:.1f} "
              f"z-slices/s | {t['ms_per_volume']:.4f} ms/volume | {card}")
    print(f"latency flagship b1 {SIZE}^2 (200 x 32 calls): p50 "
          f"{lat['p50_ms']:.4f} ms | p95 "
          f"{lat['p95_ms']:.4f} ms | latency_config p50 {lat2['p50_ms']:.4f} "
          f"ms p95 {lat2['p95_ms']:.4f} ms | {card}")
    profiles = [(label, profile_pipeline(c, (SIZE, SIZE), BATCH, device=dev,
                                         batch=inp))
                for label, c, inp in (
                    ("flagship", flagship_config(), None),
                    ("skimage yaml", sk_cfg, None),
                    ("ct_lowdose_nlm yaml", ct_cfg, ct),
                    ("ultrasound_despeckle yaml", us_cfg, us),
                    ("w9", w9_cfg, usf), ("w8", w8_cfg, x),
                    ("w3", w3_cfg, xm), ("mammogram_sharpen yaml", mm_cfg, xm16),
                    ("flagship 1024^2", flagship_config(), xm),
                    *[(name, c, inp) for name, _, c, inp, _ in tnew])]
    profiles += [
        ("w6 volume", profile_volume(w6_cfg, vol=w6vol, quantize=False,
                                     device=dev)),
        ("ct_volume_3d yaml", profile_volume(ctv_cfg, vol=ctv, device=dev)),
        ("clahe3d skimage volume", profile_volume(sk3_cfg, vol=x, device=dev))]
    for label, prof in profiles:
        top = "; ".join(f"{name[:48]} {ms:.4f}" for name, ms in
                        list(prof["by_kernel"].items())[:8])
        ops = "; ".join(f"{name} {ms:.4f}" for name, ms in
                        list(prof["by_op"].items())[:8])
        batch = f"b{prof['batch_size']} " if "batch_size" in prof else ""
        print(f"profile {label} {batch}{prof['shape']}: device "
              f"{prof['device_ms_per_call']:.4f} ms of "
              f"{prof['ms_per_call']:.4f} ms/call (busy "
              f"{prof['busy_share']:.1%}), {len(prof['by_kernel'])} device "
              f"ops, {prof['device_launches_per_call']:g} device launches "
              f"per call | top ms: {top} | by host op: {ops} | {card}")
    # the chains of the frequency, wavelet and ridge ops, one line each
    for name, dtype, _, _, t in tnew[-len(chains14):]:
        prof = dict(profiles)[name]
        print(f"chain {name} {dtype} b{t['batch_size']} {t['shape'][0]}^2: "
              f"{t['slices_per_sec']:.1f} slices/s, {t['ms_per_batch']:.4f} "
              f"ms/batch | device {prof['device_ms_per_call']:.4f} ms of "
              f"{prof['ms_per_call']:.4f} ms/call, "
              f"{prof['device_launches_per_call']:g} launches per call, busy "
              f"{prof['busy_share']:.1%} | {card}")

    # the fused tail's A/B on the flagship at b32 512^2: MIES_TPU_FUSE_TAIL
    # off, on, on, off in one run, each by time_pipeline; then one call with
    # it on (K1 to the LUTs, K2, K13 once each, equal to the default chain)
    # and its device profile
    ab = {"off": [], "on": []}
    for tag in ("off", "on", "on", "off"):
        os.environ.pop("MIES_TPU_FUSE_TAIL", None)
        if tag == "on":
            os.environ["MIES_TPU_FUSE_TAIL"] = "1"
        ab[tag].append(time_pipeline(cfg, (SIZE, SIZE), BATCH, device=dev)["ms_per_batch"])
    os.environ["MIES_TPU_FUSE_TAIL"] = "1"
    try:
        fused_fn = compile_pipeline(cfg, batched=True)
        _build.reset_launches()
        fused_out = fused_fn(x)
        torch.cuda.synchronize()
        fused_launches = dict(_build.LAUNCHES)
        fused_prof = profile_pipeline(cfg, (SIZE, SIZE), BATCH, device=dev, batch=x)
    finally:
        os.environ.pop("MIES_TPU_FUSE_TAIL", None)
    want_f = {"tile_luts": 1, "clahe_apply_lut": 1, "bilateral_unsharp": 1}
    _require(fused_launches == {k: want_f.get(k, 0) for k in fused_launches},
             f"fused-tail flagship launches {fused_launches}, want {want_f}")
    _require(torch.equal(fused_out, compile_pipeline(cfg, batched=True)(x)),
             "fused-tail flagship output differs from the default chain")
    print(f"fused tail A/B flagship b{BATCH} {SIZE}^2 (ms/batch, off on on off): "
          f"off {ab['off']} | on {ab['on']} | outputs equal | launches with it on "
          f"{ {k: v for k, v in fused_launches.items() if v} } | device "
          f"{fused_prof['device_ms_per_call']:.4f} ms of "
          f"{fused_prof['ms_per_call']:.4f} ms/call (busy "
          f"{fused_prof['busy_share']:.1%}) | top ms: "
          + "; ".join(f"{n[:48]} {v:.4f}" for n, v in
                      list(fused_prof["by_kernel"].items())[:4]) + f" | {card}")

    # K10 and K7, and the chains they lie on
    busy = {label: prof["busy_share"] for label, prof in profiles}
    print(f"K10 {rec['K10']['ms']:.4f} ms ({us_launches['srad']} launches "
          f"per ultrasound call), K7 {rec['K7']['ms']:.4f} ms | ultrasound "
          f"{tus['slices_per_sec']:.1f} slices/s (busy "
          f"{busy['ultrasound_despeckle yaml']:.1%}), w9 "
          f"{tw9['slices_per_sec']:.1f} (busy {busy['w9']:.1%}), w3 "
          f"{tw3['slices_per_sec']:.1f} (busy {busy['w3']:.1%}) | {card}")

    # K3 and K4, and the chains they lie on
    dev_ms = {label: prof["device_ms_per_call"] for label, prof in profiles}
    print(f"K3 {rec['K3']['ms']:.4f} ms [{BATCH},{SIZE},{SIZE}], "
          f"{rec['K3r']['ms']:.4f} ms {at_m} | K4 {rec['K4']['ms']:.4f} ms, "
          f"{rec['K4r']['ms']:.4f} ms | device ms (busy): flagship "
          f"{dev_ms['flagship']:.4f} ({busy['flagship']:.1%}), flagship 1024^2 "
          f"{dev_ms['flagship 1024^2']:.4f} ({busy['flagship 1024^2']:.1%}), "
          f"skimage {dev_ms['skimage yaml']:.4f} ({busy['skimage yaml']:.1%}), "
          f"mammogram {dev_ms['mammogram_sharpen yaml']:.4f} "
          f"({busy['mammogram_sharpen yaml']:.1%}), sharded 4096^2 "
          f"{shard_prof['device_ms_per_call']:.4f} "
          f"({shard_prof['busy_share']:.1%}) | {card}")

    # K1, K2 and K5, and the chains they lie on
    print(f"K1 to the LUTs {rec['K1L']['ms']:.4f} ms (profiler "
          f"{rec_dev['K1L']:.4f}), K1 float {rec['K1']['ms']:.4f} "
          f"({rec_dev['K1']:.4f}), K1 bins {rec['K1b']['ms']:.4f} "
          f"({rec_dev['K1b']:.4f}), K2 {rec['K2']['ms']:.4f} "
          f"({rec_dev['K2']:.4f}), K2 clip01 {rec['K2c']['ms']:.4f} "
          f"({rec_dev['K2c']:.4f}) [{BATCH},{SIZE},{SIZE}]; K5 4 bands "
          f"{rec['K5']['ms']:.4f} ({rec_dev['K5']:.4f}) [1,{BS},{BS}] | "
          f"device ms, launches per call (busy): " + ", ".join(
              f"{label} {prof['device_ms_per_call']:.4f}, "
              f"{prof['device_launches_per_call']:g} ({prof['busy_share']:.1%})"
              for label, prof in [*profiles, ("sharded 4096^2", shard_prof)]
              if label in ("flagship", "flagship 1024^2", "ct_lowdose_nlm yaml",
                           "ultrasound_despeckle yaml", "w9", "sharded 4096^2"))
          + f" | {card}")

    # K6 and K8s, and the chains they lie on
    def in_chain(label, kernel):
        return sum(ms for name, ms in dict(profiles)[label]["by_kernel"].items()
                   if kernel in name)

    print(f"K6a {rec['K6a']['ms']:.4f} ms (profiler {rec_dev['K6a']:.4f}; in "
          f"the skimage chain {in_chain('skimage yaml', 'skimage_maps_kernel'):.4f}, "
          f"in the volume "
          f"{in_chain('clahe3d skimage volume', 'skimage_maps_kernel'):.4f}), "
          f"nbins 1000 {rec['K6an']['ms']:.4f} ({rec_dev['K6an']:.4f}) | "
          f"bounds {rec['K6a']['bound_ms']:.4f}, {rec['K6an']['bound_ms']:.4f} "
          f"| {card}")
    print(f"K6 {rec['K6']['ms']:.4f} ms (profiler {rec_dev['K6']:.4f}; in the "
          f"skimage chain {in_chain('skimage yaml', 'skimage_apply_kernel'):.4f}) "
          f"[{BATCH},{SIZE},{SIZE}], nbins 1000 {rec['K6n']['ms']:.4f} "
          f"({rec_dev['K6n']:.4f}), {rec['K6x']['ms']:.4f} ({rec_dev['K6x']:.4f}) "
          f"[1,{BS},{BS}]; K8s {rec['K8s']['ms']:.4f} ({rec_dev['K8s']:.4f}; "
          f"in the volume {in_chain('clahe3d skimage volume', 'clahe3d_skimage_apply'):.4f}), "
          f"nbins 1000 {rec['K8sn']['ms']:.4f} ({rec_dev['K8sn']:.4f}) "
          f"[{BATCH},{SIZE},{SIZE}] | bounds {rec['K6']['bound_ms']:.4f}, "
          f"{rec['K6x']['bound_ms']:.4f}, {rec['K8s']['bound_ms']:.4f} | "
          f"device ms, launches per call (busy): skimage "
          f"{dev_ms['skimage yaml']:.4f}, "
          f"{dict(profiles)['skimage yaml']['device_launches_per_call']:g} "
          f"({busy['skimage yaml']:.1%}), clahe3d skimage volume "
          f"{dev_ms['clahe3d skimage volume']:.4f}, "
          f"{dict(profiles)['clahe3d skimage volume']['device_launches_per_call']:g} "
          f"({busy['clahe3d skimage volume']:.1%}) | {card}")

    # -- 6. files: load -> enhance -> save (w5, DICOM, the CLI) ----------
    _files_phase(dev, card, repo)

    # -- 7. volume ops: the volume registry at full width ----------------
    p7_launches = _volume_ops_phase(dev, card, repo)
    # K1 and K8 launch on the CT volume config's path and on chain (a)'s
    vol_launches = {k: ctv_launches[k] + p7_launches[k] for k in ctv_launches}

    # -- 8. the z-sharded volume path -------------------------------------
    zs_launches, zsf_launches = _zshard_phase(dev, card, repo, record)

    # -- 9. the rest of the 2-D registry ---------------------------------
    p9_launches = _registry2d_phase(dev, card, record, rec)

    # -- 10. the metric suite and the learned denoiser -------------------
    p10 = _eval_models_phase(dev, card, repo)
    # K1 to the LUTs, K2 and K4 launch on the flagship's path, on the
    # evaluated flagship's and on the learned chain's; K3 on the first two
    launches = {k: launches[k] + p10["sharded_evaluate"][k]
                + p10["learned"][k] for k in launches}

    # -- 11. serving and deployment --------------------------------------
    # K1 to the LUTs, K2, K3 and K4 launch once a served flagship request
    p11 = _serving_phase(dev, card, repo)
    launches = {k: launches[k] + p11[k] for k in launches}

    # -- 12. the device-resident timers (CUDA graphs) ---------------------
    _device_timers_phase(dev, card, repo)

    # name, record, counter, the run whose launches count, source, TPU kernel
    sources = (
        ("tile_luts", "K1L", launches, "mies_tpu_torch/csrc/clahe.cu",
         "mies_tpu/kernels/clahe.py:923"),
        ("tile_hists", "K1", vol_launches, "mies_tpu_torch/csrc/clahe.cu",
         "mies_tpu/kernels/clahe.py:923"),
        ("tile_hists_bins", "K1b", sk_launches, "mies_tpu_torch/csrc/clahe.cu",
         "mies_tpu/kernels/clahe.py:923"),
        ("clahe_apply_lut", "K2", launches, "mies_tpu_torch/csrc/clahe.cu",
         "mies_tpu/kernels/clahe.py:242"),
        ("clahe_apply_lut", "K2c", fr_launches, "mies_tpu_torch/csrc/clahe.cu",
         "mies_tpu/kernels/clahe.py:242"),
        ("bilateral", "K3", launches, "mies_tpu_torch/csrc/bilateral.cu",
         "mies_tpu/kernels/bilateral.py:106"),
        ("unsharp_quant", "K4", launches, "mies_tpu_torch/csrc/unsharp.cu",
         "mies_tpu/kernels/unsharp_gauss.py:159"),
        ("skimage_maps", "K6a", sk_launches,
         "mies_tpu_torch/csrc/clahe_skimage.cu",
         "mies_tpu/ops/histogram.py:602"),
        ("skimage_maps", "K6an", sk_launches,
         "mies_tpu_torch/csrc/clahe_skimage.cu",
         "mies_tpu/ops/histogram.py:602"),
        ("skimage_apply", "K6", sk_launches,
         "mies_tpu_torch/csrc/clahe_skimage.cu",
         "mies_tpu/kernels/clahe.py:1271"),
        ("skimage_apply", "K6n", sk_launches,
         "mies_tpu_torch/csrc/clahe_skimage.cu",
         "mies_tpu/kernels/clahe.py:1271"),
        ("skimage_apply", "K6x", sk_launches,
         "mies_tpu_torch/csrc/clahe_skimage.cu",
         "mies_tpu/kernels/clahe.py:1271"),
        ("perona_malik", "K9", w8_launches, "mies_tpu_torch/csrc/diffusion.cu",
         "mies_tpu/kernels/diffusion.py:52"),
        ("srad", "K10", us_launches, "mies_tpu_torch/csrc/diffusion.cu",
         "mies_tpu/kernels/diffusion.py:145"),
        ("nl_means", "K11", ct_launches, "mies_tpu_torch/csrc/nlmeans.cu",
         "mies_tpu/kernels/nlmeans.py:160"),
        ("tv", "K12", ct_launches, "mies_tpu_torch/csrc/tv.cu",
         "mies_tpu/kernels/tv.py:55"),
        ("unsharp_gauss", "K7", w3_launches,
         "mies_tpu_torch/csrc/unsharp_gauss.cu",
         "mies_tpu/kernels/unsharp_gauss.py:58"),
        ("clahe3d_apply", "K8", vol_launches, "mies_tpu_torch/csrc/clahe3d.cu",
         "mies_tpu/kernels/clahe.py:348"),
        ("clahe3d_apply", "K8c", fr3_launches, "mies_tpu_torch/csrc/clahe3d.cu",
         "mies_tpu/kernels/clahe.py:348"),
        ("clahe3d_apply", "K8v", vol_launches, "mies_tpu_torch/csrc/clahe3d.cu",
         "mies_tpu/kernels/clahe.py:348"),
        ("clahe3d_apply", "K8cv", fr3_launches,
         "mies_tpu_torch/csrc/clahe3d.cu", "mies_tpu/kernels/clahe.py:348"),
        ("clahe3d_skimage_apply", "K8s", sk3_launches,
         "mies_tpu_torch/csrc/clahe3d.cu", "mies_tpu/kernels/clahe.py:1062"),
        ("clahe3d_skimage_apply", "K8sn", sk3_launches,
         "mies_tpu_torch/csrc/clahe3d.cu", "mies_tpu/kernels/clahe.py:1062"),
        ("bilateral", "K3r", fm_launches, "mies_tpu_torch/csrc/bilateral.cu",
         "mies_tpu/kernels/bilateral.py:48"),
        ("unsharp_quant", "K4r", mm_launches, "mies_tpu_torch/csrc/unsharp.cu",
         "mies_tpu/kernels/unsharp_gauss.py:134"),
        ("clahe_apply_lut_band", "K5", shard_launches,
         "mies_tpu_torch/csrc/clahe.cu", "mies_tpu/kernels/clahe.py:1149"),
        ("bilateral_unsharp", "K13", fused_launches,
         "mies_tpu_torch/csrc/fused.cu", "mies_tpu/kernels/fused.py:43"),
        ("bilateral_unsharp", "K13m", fused_launches,
         "mies_tpu_torch/csrc/fused.cu", "mies_tpu/kernels/fused.py:43"),
        ("clahe3d_apply_band", "K8z", zs_launches,
         "mies_tpu_torch/csrc/clahe3d.cu", "mies_tpu/parallel/volume_shard.py:99"),
        ("clahe3d_apply_band", "K8zc", zsf_launches,
         "mies_tpu_torch/csrc/clahe3d.cu", "mies_tpu/parallel/volume_shard.py:99"),
        ("bilateral", "K3d", p9_launches, "mies_tpu_torch/csrc/bilateral.cu",
         "mies_tpu/kernels/bilateral.py:106"),
    )
    names = {"K1b": "tile_hists_bins", "K2c": "clahe_apply_lut[clip01]",
             "K2": "clahe_apply_lut[u8norm]", "K8": "clahe3d_apply[u8norm]",
             "K8c": "clahe3d_apply[clip01]",
             "K8v": "clahe3d_apply[u8norm,256x512x512]",
             "K8cv": "clahe3d_apply[clip01,256x512x512]",
             "K6n": "skimage_apply[nbins1000]",
             "K6an": "skimage_maps[nbins1000]",
             "K13m": "bilateral_unsharp[8x1024x1024]",
             "K6x": "skimage_apply[1x4096x4096]",
             "K8sn": "clahe3d_skimage_apply[nbins1000]",
             "K3r": "bilateral[8x1024x1024]",
             "K4r": "unsharp_quant[8x1024x1024]",
             "K8z": "clahe3d_apply_band[u8norm]",
             "K8zc": "clahe3d_apply_band[clip01]",
             "K3d": "bilateral[denoise_bilateral,k7,edge]"}
    kernels = []
    for counter, k, counts, src, rep in sources:
        _require(counts[counter] >= 1, f"{k} never launched on its path")
        kernels.append({"name": names.get(k, counter), "route": "cuda",
                        "source": src, "replaces": rep,
                        "launches": counts[counter], **rec[k]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
