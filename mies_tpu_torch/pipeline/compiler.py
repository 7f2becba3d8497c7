"""Compile a PipelineConfig into one callable on [B, H, W] tensors.

The port of ``mies_tpu.pipeline.compiler`` for the ops ported so far.
PyTorch runs eagerly, so "compiling" binds each stage's parameters once;
there is no trace, no cache of programs and no input donation. The chain
runs on the input tensor's device: on a CUDA tensor the batched stages
launch the hand-written kernels of ``mies_tpu_torch.kernels``, on a CPU
tensor they run their plain PyTorch versions.

Batched chains on the card:
  flagship: ingest (uint8 / uint16 -> float [0, 1])
    -> clahe opencv (K1, LUT build, K2) -> bilateral_blur (K3)
    -> unsharp_mask + uint8 quantize as one kernel (K4, the tail peephole);
  configs/xray_adapthist_skimage.yaml: ingest
    -> clahe skimage (K1 bins, K6a, K6) -> unsharp + quantize (K4).
The fraction convention runs K1 and K2 (clip01), kornia plain torch.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from mies_tpu_torch.kernels.bilateral import bilateral_batched
from mies_tpu_torch.kernels.clahe import clahe_batched
from mies_tpu_torch.kernels.unsharp_gauss import (
    unsharp_quant_cuda,
    unsharp_quant_supported,
)
from mies_tpu_torch.ops import filters as F
from mies_tpu_torch.ops import histogram as H
from mies_tpu_torch.pipeline.config import PipelineConfig, validate

# Every op a config can name in the port. Signature: fn(img, **params),
# plain PyTorch on [..., H, W].
OP_REGISTRY: dict[str, Callable] = {
    "clahe": H.clahe,
    "bilateral_blur": F.bilateral_blur,
    "unsharp_mask": F.unsharp_mask,
}

# Ops with a batched kernel path: fn([B, H, W], **params).
_BATCHED_OPS: dict[str, Callable] = {
    "clahe": clahe_batched,
    "bilateral_blur": bilateral_batched,
}


def _check_ported(cfg: PipelineConfig) -> None:
    """Fail at chain-build time for a config the port cannot run (one
    built in code has not been through load_config's checks), including
    the clahe op's own argument rules."""
    validate(cfg)
    for s in cfg.stages:
        if s.op == "clahe":
            kw = s.kwargs()
            H.check_convention(kw.get("convention", "opencv"),
                               kw.get("nbins", H.NBINS))


def _bind_batched_stage(s) -> Callable:
    fn = _BATCHED_OPS.get(s.op, OP_REGISTRY[s.op])
    return functools.partial(fn, **s.kwargs())


def _try_fuse_unsharp_quant(cfg: PipelineConfig, quantize: bool):
    """Peephole: a trailing unsharp_mask('nearest', clip=True) runs as ONE
    kernel (K4) with the uint8 quantize folded in. Decided from the config
    alone. Returns (prefix_stages, fused_fn | None)."""
    if not cfg.stages or cfg.stages[-1].op != "unsharp_mask":
        return cfg.stages, None
    bk = cfg.stages[-1].kwargs()
    if bk.get("mode", "nearest") != "nearest" or not bk.get("clip", True):
        return cfg.stages, None
    radius = float(bk.get("radius", 1.0))
    truncate = float(bk.get("truncate", 4.0))
    if not unsharp_quant_supported(radius, truncate):
        return cfg.stages, None
    fused = functools.partial(
        unsharp_quant_cuda, radius=radius, amount=float(bk.get("amount", 1.0)),
        truncate=truncate, quantize=quantize,
    )
    return cfg.stages[:-1], fused


def build_batched_chain(
    cfg: PipelineConfig, quantize: bool | None = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch-level chain [B, H, W] -> [B, H, W].

    When ``quantize`` is not None the chain also owns the final uint8
    conversion (quantize=True), which lets the unsharp tail fuse with it.
    """
    _check_ported(cfg)
    stages, fused_tail = (
        _try_fuse_unsharp_quant(cfg, bool(quantize)) if quantize is not None
        else (cfg.stages, None)
    )
    bound = [_bind_batched_stage(s) for s in stages]

    def chain(batch: torch.Tensor) -> torch.Tensor:
        x = _ingest(batch)
        for fn in bound:
            x = fn(x)
        if fused_tail is not None:
            return fused_tail(x)
        return _quantize_u8(x) if quantize else x

    return chain


def build_chain(cfg: PipelineConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """One-slice chain [H, W] -> [H, W] float: the batched chain on a
    batch of one."""
    bchain = build_batched_chain(cfg)
    return lambda img: bchain(img[None])[0]


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8 (round-half-even like cv2/np.rint, clipped)."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def _ingest(x: torch.Tensor) -> torch.Tensor:
    """Normalize integer inputs to the float [0, 1] convention on the
    input's device (uint8 / 255, uint16 / 65535, by true division — a
    tensor divisor, since CUDA torch multiplies by the reciprocal of a
    Python scalar); floating inputs become float32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / torch.full((), 255.0, device=x.device)
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / torch.full((), 65535.0, device=x.device)
    if x.is_floating_point():
        return x.to(torch.float32).contiguous()
    return x


def compile_pipeline(
    cfg: PipelineConfig, batched: bool = False, quantize: bool = True
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Config -> callable on the input tensor's device.

    batched=False: input [H, W] (or [C, H, W] per-channel); batched=True:
    input [B, H, W] (or [B, C, H, W], channels folded into the batch).
    quantize=True ends the chain in uint8.
    """
    bchain = build_batched_chain(cfg, quantize=quantize)

    def run(x: torch.Tensor) -> torch.Tensor:
        if batched and x.dim() == 4:
            b, c = x.shape[:2]
            out = bchain(x.reshape(b * c, *x.shape[2:]))
            return out.reshape(b, c, *out.shape[1:])
        if batched or x.dim() == 3:
            return bchain(x)
        return bchain(x[None])[0]

    return run
