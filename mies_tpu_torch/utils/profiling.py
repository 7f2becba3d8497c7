"""Tracing and profiling on the card: the port of
``mies_tpu.utils.profiling`` with the reference's six names.

* ``device_sync`` waits for the card to finish the work behind a tensor;
* ``time_fn`` times a callable on the card by CUDA events (no card ->
  RuntimeError, as the runner's timing harnesses);
* ``trace(dir)`` records a ``torch.profiler`` trace of the block (host ops
  and, on the card, its kernels) as a Chrome trace, ``dir/trace.json``;
* ``strict_numerics`` raises on the first non-finite floating output of a
  PyTorch op inside the block, naming the op;
* ``stage_costs`` counts each stage's operations and bytes;
* ``enable_compilation_cache`` builds the hand kernels into their
  persistent build directory and returns it: the port's only compile
  cache (PyTorch runs eagerly; a later process loads the built library in
  milliseconds instead of running nvcc).
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
from pathlib import Path
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def enable_compilation_cache() -> str:
    """Build the kernel library unless it is current (``nvcc``; raises
    without it) and return its build directory, ``kernels/_build.BUILD_DIR``."""
    from mies_tpu_torch.kernels import _build

    _build.build()
    return str(_build.BUILD_DIR)


def device_sync(y) -> None:
    """Wait until the card has computed ``y`` (a tensor, or the first of a
    tuple or list of them); nothing to wait for on the CPU."""
    t = y[0] if isinstance(y, (tuple, list)) else y
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_fn(fn: Callable, *args, iters: int = 16, repeats: int = 5) -> dict:
    """Median device time per call of ``fn(*args)`` on the card: CUDA
    events around ``iters`` back-to-back calls, the median of ``repeats``
    such runs after two warm-up calls. Returns {'ms_per_call',
    'calls_per_sec'}."""
    from mies_tpu_torch.pipeline.runner import _cuda_device

    dev = _cuda_device("cuda")
    with torch.cuda.device(dev):
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize(dev)
        runs = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
    per_call = sorted(runs)[len(runs) // 2]
    return {"ms_per_call": per_call, "calls_per_sec": 1e3 / per_call}


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record the block with ``torch.profiler`` (the card's kernels too
    where there is one) and write a Chrome / Perfetto trace to
    ``log_dir/trace.json`` (default: ``mies_tpu_torch_trace`` under the
    temporary directory); yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "mies_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


# ops that return uninitialized memory: a hand kernel's output is allocated
# so, and filled by a launch this mode does not see
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided"})


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"strict_numerics: {func} produced a non-finite value "
                    f"(shape {tuple(t.shape)})")
        return out


@contextlib.contextmanager
def strict_numerics():
    """Debug mode: raise FloatingPointError on the first NaN or Inf that a
    PyTorch op inside the block produces, naming the op. Each check reads
    the output back on the host (test and debug only). A hand kernel's
    output is checked where the next PyTorch op reads it; the custom ops
    (``torch.ops.mies``) are checked themselves."""
    with _NonFiniteCheck():
        yield


class _Costs(TorchDispatchMode):
    """Counts of the ops dispatched inside: ``bytes`` of their tensor inputs
    and outputs, ``ops`` of the ops the flop counter does not count (a
    ``mies`` op its kernel's ``kernels._build.OPERATIONS``; any other one
    per output element)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        from mies_tpu_torch.kernels import _build

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if func.namespace == "mies":
            self.ops += float(_build.OPERATIONS[func._opname](*args))
        elif func.overloadpacket not in flop_registry:
            self.ops += sum(t.numel() for t in outs)
        return out


def stage_costs(cfg, shape=(512, 512), batch_size: int = 32,
                volume_depth: int = 32, device="cuda") -> list[dict]:
    """Per-stage operations ("flops"), bytes and their ratio, counted by
    running each bound stage once on zeros on ``device``.

    These are counts of the port's own ops, not XLA's cost analysis (the
    reference's figures): each stage, bound as the chain binds it
    (``compiler._bind_batched_stage``; a volume-only op through the volume
    registry on [volume_depth, H, W] instead of [batch_size, H, W]), runs
    under a dispatch mode with every hand kernel routed through its
    ``torch.ops.mies`` op. ``bytes`` sums the tensor inputs and outputs of
    every dispatched op; ``flops`` is ``torch.utils.flop_counter``'s count
    for matrix products and convolutions, each ``mies`` op's operations
    (the counts of its bound in PERF.md section 6) and one per output
    element of every other op. A stage that fails records its error.
    Returns one {"op", "flops", "bytes", "intensity"} or {"op", "error"}
    per stage."""
    from torch.utils.flop_counter import FlopCounterMode

    from mies_tpu_torch.kernels import _build
    from mies_tpu_torch.pipeline.compiler import (
        VOLUME_ONLY_OPS,
        _bind_batched_stage,
        _volume_registry,
        resolve_device,
    )

    dev = resolve_device(device)
    out = []
    for s in cfg.stages:
        try:
            if s.op in VOLUME_ONLY_OPS:
                fn = functools.partial(_volume_registry()[s.op], **s.kwargs())
                x = torch.zeros((volume_depth, *shape), device=dev)
            else:
                fn = _bind_batched_stage(s)
                x = torch.zeros((batch_size, *shape), device=dev)
            with torch.no_grad(), _build.through_ops(), \
                    FlopCounterMode(display=False) as flop_counter:
                with _Costs() as costs:
                    fn(x)
            flops = flop_counter.get_total_flops() + costs.ops
            out.append({
                "op": s.op, "flops": float(flops), "bytes": float(costs.bytes),
                "intensity": flops / costs.bytes if costs.bytes else
                float("nan"),
            })
        except Exception as e:  # noqa: BLE001 - recorded per stage
            out.append({"op": s.op, "error": f"{type(e).__name__}: {e}"})
    return out
