"""A whole chain in plain PyTorch, from raw slices to uint8.

ingest (uint8 / 255 and uint16 / 65535 by true division; int16
Hounsfield units pass to window_hu; floats are cast) -> each stage of the
config, from ``ops/<op>.py`` -> clip(rint(x * 255), 0, 255) as uint8. The
chain runs in blocks of slices, so that it fits beside the pool: every
stage held here works slice by slice.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch

OPS_DIR = Path(__file__).resolve().parent / "ops"
BLOCK = 16  # slices a block


@functools.lru_cache(maxsize=None)
def load_op(op: str, ops_dir: Path = OPS_DIR):
    path = Path(ops_dir) / f"{op}.py"
    if not path.is_file():
        raise ValueError(f"no reference stage for op {op!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_ref_{op}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stages_of(config: dict) -> list[tuple[str, dict]]:
    """(op, params) of each stage of a configuration file's program."""
    out = []
    for entry in config["program"]["pipeline"]:
        entry = dict(entry)
        out.append((entry.pop("op"), entry))
    return out


def ingest(raw: torch.Tensor, dtype) -> torch.Tensor:
    scale = {torch.uint8: 255.0, torch.uint16: 65535.0}.get(raw.dtype)
    if scale is not None:
        return raw.to(dtype) / torch.full((), scale, dtype=dtype,
                                          device=raw.device)
    if raw.is_floating_point():
        return raw.to(dtype)
    return raw


def ingest_operations(shape, io_dtype: torch.dtype) -> int:
    b, h, w = shape
    return b * h * w if io_dtype in (torch.uint8, torch.uint16) else 0


def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def quantize_operations(shape) -> int:
    b, h, w = shape
    return 3 * b * h * w  # scale, round, clamp


def run(stages, raw: torch.Tensor, dtype=torch.float32, ops_dir=OPS_DIR,
        block: int = BLOCK) -> tuple[torch.Tensor, dict]:
    """uint8 output of the chain on ``raw`` [B, H, W], computed in
    ``dtype``, and what the stages recorded (per slice, over the batch)."""
    mods = [(load_op(op, Path(ops_dir)), params) for op, params in stages]
    outs, info = [], {}
    with torch.no_grad():
        for i in range(0, raw.shape[0], block):
            x = ingest(raw[i:i + block], dtype)
            for mod, params in mods:
                x = mod.apply(x, dtype, info, **params)
            outs.append(quantize(x))
    return torch.cat(outs), {k: torch.cat(v) for k, v in info.items()}


def operations(stages, shape, io_dtype, info, ops_dir=OPS_DIR) -> int:
    """The chain's float operations for a batch of ``shape``: ingest,
    every stage at its own count, the uint8 quantize."""
    total = ingest_operations(shape, io_dtype) + quantize_operations(shape)
    for op, params in stages:
        total += load_op(op, Path(ops_dir)).operations(shape, info, **params)
    return total
