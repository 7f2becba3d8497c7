"""Ahead-of-time pipeline export: a chain as one portable artifact.

The port of ``mies_tpu.pipeline.export``: ``torch.export`` takes the place
of ``jax.export``. The chain is traced once into an ``ExportedProgram``,
which loads and runs without the config system, the op registry or a
re-bind: a deployment host calls one artifact with one function in it.
Every hand kernel of the chain is recorded as its ``torch.ops.mies`` custom
op (``kernels._build.register_op``), so the artifact launches the same
kernels on the card as the eager chain, and their plain versions on the CPU.

Format (``.mies``), the reference's container: 8-byte magic ``MIESEXP1`` +
u32 little-endian JSON header length + JSON header (config dict, input
spec, platform) + the blob, here the bytes of ``torch.export.save``. The
header is readable without torch.

Platform note: the chain's shapes and device are fixed when it is traced,
so an artifact exported on the card (``platforms: ["cuda"]``) runs there
and one exported on the CPU runs on the CPU; ``load_exported`` checks and
reports this. A ``.mies`` written by ``mies_tpu`` holds a ``jax.export``
blob, which this loader refuses.

Tracing reads the module caches of the ops (``functools.lru_cache``'d
kernels, pads and tables): a tensor built while tracing is a fake tensor,
and a cache that kept one would poison the next export and the eager
chain. So the chain runs once eagerly on zeros of the input spec before it
is traced (every cache the trace reads then holds real tensors), and any
cache that was filled during the trace is cleared after it.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import struct
import sys
import zipfile
from pathlib import Path

import torch

_MAGIC = b"MIESEXP1"
_DTYPES = {"float32": torch.float32, "uint8": torch.uint8,
           "uint16": torch.uint16, "int16": torch.int16}


class _Chain(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _module_caches() -> list:
    """Every ``functools`` cache of the port's loaded modules."""
    caches = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("mies_tpu_torch"):
            continue
        for value in vars(mod).values():
            if hasattr(value, "cache_info") and hasattr(value, "cache_clear"):
                caches.append(value)
    return caches


@contextlib.contextmanager
def _caches_kept_real():
    """Clear, after the block, each module cache that missed inside it:
    what it stored there may be a fake tensor of the trace."""
    caches = _module_caches()
    before = {id(c): c.cache_info().misses for c in caches}
    try:
        yield
    finally:
        for c in caches:
            if c.cache_info().misses != before[id(c)]:
                c.cache_clear()


def _trace(fn, example: torch.Tensor):
    with _caches_kept_real():
        return torch.export.export(_Chain(fn), (example,), strict=False)


def _stage_fns(cfg, volume: bool):
    """(op name, bound stage) of each stage, as the chains bind them."""
    from mies_tpu_torch.pipeline.compiler import (
        _bind_batched_stage,
        _volume_registry,
    )

    if volume:
        reg = _volume_registry()
        return [(s.op, functools.partial(reg[s.op], **s.kwargs()))
                for s in cfg.stages]
    return [(s.op, _bind_batched_stage(s)) for s in cfg.stages]


def _failing_stage(cfg, volume: bool, example: torch.Tensor) -> str:
    """The first stage that does not trace on its own input (each stage's
    input computed eagerly), or '' when each one does."""
    from mies_tpu_torch.pipeline.compiler import _ingest

    x = example if volume else _ingest(example.reshape(-1, *example.shape[-2:]))
    for i, (op, fn) in enumerate(_stage_fns(cfg, volume)):
        try:
            _trace(fn, x)
        except Exception:  # noqa: BLE001 - any trace failure names the stage
            return f"stage {i} ({op!r})"
        x = fn(x)
    return ""


def export_pipeline(
    cfg,
    path: str | Path,
    shape: tuple[int, ...] = (512, 512),
    batch_size: int | None = None,
    quantize: bool = True,
    volume: bool = False,
    input_dtype: str = "float32",
    device="cuda",
) -> Path:
    """Serialize the chain for ``shape`` (and an optional leading batch
    axis) on ``device`` into a ``.mies`` artifact; returns the path.

    volume=True exports the [Z, H, W] volume program
    (``compile_volume_pipeline``); ``shape`` is then the full 3-D grid and
    batch_size must be None. With a batch_size the batched chain
    (``build_batched_chain``) on [B, H, W]; without, the single-slice
    program on [H, W] (ingest -> chain -> quantize, as
    ``compile_pipeline``).

    input_dtype picks the traced input spec: the chain's ingest takes raw
    integers (uint8 / uint16 normalize on the device; int16 HU passes
    through to window_hu), so 'uint8' is the spec for PNG / X-ray serving
    and 'int16' for CT chains; 'float32' callers pre-normalize on the host.
    A chain that cannot be traced is refused with a ValueError naming its
    stage. ``device="cuda"`` (the default) traces the chain on the card and
    raises RuntimeError where there is none; ``device="cpu"`` the plain
    chain.
    """
    from mies_tpu_torch.pipeline.compiler import (
        build_batched_chain,
        compile_volume_pipeline,
        resolve_device,
    )

    dev = resolve_device(device)
    if volume:
        if batch_size is not None:
            raise ValueError("volume exports take no batch axis")
        if len(shape) != 3:
            raise ValueError("volume exports need a (Z, H, W) shape")
        fn = compile_volume_pipeline(cfg, quantize=quantize, device=dev)
        in_shape = tuple(shape)
    elif batch_size is not None:
        fn = build_batched_chain(cfg, quantize=quantize, device=dev)
        in_shape = (batch_size, *shape)
    else:
        bchain = build_batched_chain(cfg, quantize=quantize, device=dev)

        def fn(img):
            return bchain(img[None])[0]
        in_shape = tuple(shape)
    if input_dtype not in _DTYPES:
        raise ValueError(
            f"input_dtype must be one of {sorted(_DTYPES)}, got "
            f"{input_dtype!r}")
    example = torch.zeros(in_shape, dtype=_DTYPES[input_dtype], device=dev)
    with torch.no_grad():
        fn(example)  # warm every module cache with real tensors
        try:
            ep = _trace(fn, example)
        except Exception as e:  # noqa: BLE001 - reported with its stage
            where = _failing_stage(cfg, volume, example)
            raise ValueError(
                f"export of {cfg.name!r}: {where or 'the chain'} cannot be "
                f"traced by torch.export ({type(e).__name__}: "
                f"{str(e).splitlines()[0] if str(e) else ''})"
            ) from e
    header = {
        "config": cfg.to_dict(),
        "input_shape": list(in_shape),
        "input_dtype": input_dtype,
        "quantize": quantize,
        "volume": volume,
        "platforms": [dev.type],
    }
    ep.example_inputs = None  # the zeros would ride in the archive
    blob = io.BytesIO()
    torch.export.save(ep, blob)
    hj = json.dumps(header).encode()
    out = Path(path)
    out.write_bytes(_MAGIC + struct.pack("<I", len(hj)) + hj + blob.getvalue())
    return out


def _read_header(path: str | Path) -> tuple[dict, int]:
    """Parse the magic + JSON header with bounded reads; returns
    (header, blob_offset). One parser: the format lives here."""
    p = Path(path)
    with open(p, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:8] != _MAGIC:
            raise ValueError(f"{p}: not a mies export (bad magic)")
        n = struct.unpack("<I", head[8:12])[0]
        hj = f.read(n)
    if len(hj) < n:
        raise ValueError(f"{p}: corrupt artifact (truncated header)")
    try:
        return json.loads(hj), 12 + n
    except ValueError as e:
        raise ValueError(f"{p}: corrupt artifact (bad header JSON)") from e


def read_export_header(path: str | Path) -> dict:
    """The artifact's JSON header (config, shapes, platform), readable
    without torch (12 bytes + the header; the blob is never touched)."""
    return _read_header(path)[0]


def load_exported(path: str | Path, device="cuda"):
    """Deserialize a ``.mies`` artifact -> (callable, header).

    The callable (the ``ExportedProgram``'s module) takes one tensor of the
    exported shape and dtype on the artifact's device and returns the
    chain's output; no config system or re-bind is involved. Refused: an
    artifact of another platform than ``device``'s, and a blob that is not
    a ``torch.export`` archive (what a ``mies_tpu`` export holds)."""
    import mies_tpu_torch.kernels  # noqa: F401 (registers the mies ops)
    from mies_tpu_torch.pipeline.compiler import resolve_device

    header, off = _read_header(path)
    backend = resolve_device(device).type
    plats = [p.lower() for p in header.get("platforms", [])]
    if plats and backend not in plats:
        raise ValueError(
            f"{path}: exported for platform(s) {plats}, but the current "
            f"backend is {backend!r} — re-export on this platform "
            f"(the chain specializes its kernels at trace time)"
        )
    blob = io.BytesIO(Path(path).read_bytes()[off:])
    if not zipfile.is_zipfile(blob):
        raise ValueError(
            f"{path}: the blob is not a torch.export archive (an artifact "
            f"written by mies_tpu holds a jax.export program) — re-export "
            f"with mies_tpu_torch"
        )
    blob.seek(0)
    ep = torch.export.load(blob)
    return ep.module(), header
