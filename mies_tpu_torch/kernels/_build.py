"""Build, load and launch the port's hand-written CUDA kernels.

Each ``mies_tpu_torch/csrc/*.cu`` (with the ``csrc/*.cuh`` headers it
includes) compiles to an object with its own ``nvcc``, all started
together, and one more ``nvcc`` links them into
``mies_tpu_torch/_build/libmies_kernels.so`` (a plain C interface, no
PyTorch headers, so the build takes seconds), at first use, and again
whenever the hash of the sources and headers changes. The library is
loaded with ``ctypes``.

No ``--use_fast_math``: it would turn the explicit ``_rn`` arithmetic of
the kernels into approximations (breaking their bit-exactness) and
``expf`` in K3 and K9-K11 into ``__expf``. Without ``nvcc``, or when the
build fails, this raises ``RuntimeError`` with the compiler's output:
there is no plain fallback for a tensor on the card.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``launch`` raises if that is not 0 and otherwise adds one to the kernel's
count in ``LAUNCHES`` — the only place a count moves (under a lock: the
server launches from several handler threads).

``register_op`` makes a wrapper a ``torch.library`` custom op in the
``mies`` namespace, for ``torch.export`` only: while export traces
(``exporting()``) a wrapper calls ``torch.ops.mies.<name>``, which the
tracer keeps as one opaque node whose shape and dtype come from the op's
fake; the eager path calls the wrappers directly (a custom op's dispatch
costs tens of microseconds of host time a call). The op's implementation
is the wrapper itself, so the artifact launches the hand kernel on a CUDA
tensor and runs the plain version on a CPU tensor. ``through_ops()`` routes
eager calls through the ops too, so that a ``TorchDispatchMode`` sees each
kernel as one call (``utils.profiling.stage_costs`` counts them so).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libmies_kernels.so"
# where nvcc is looked for after PATH: $CUDA_HOME, $CUDA_PATH, then these
CUDA_HOMES = ("/usr/local/cuda",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to an int)
_SIGNATURES = {
    "mies_tile_hists": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mies_tile_hists_bins": (_P, _P, *(_I,) * 10, _P),
    "mies_tile_luts_opencv": (_P, _P, _P, *(_I,) * 8, _F, _P),
    "mies_apply_lut": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    "mies_apply_lut_band": (_P, _P, _P, *(_I,) * 7, _F, _F, _I, _I, _P),
    "mies_skimage_maps": (_P, _P, _I, _I, _I, _F, _P),
    "mies_skimage_apply": (_P, _P, _P, *(_I,) * 18, _P),
    "mies_bilateral": (_P, _P, _I, _I, _I, _I, _P, _F, _I, _P),
    "mies_unsharp": (_P, _P, _I, _I, _I, _P, _I, _F, _I, _P),
    "mies_nl_means": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "mies_tv_chunk": (*(_P,) * 7, _I, _I, _I, _I, _I, _F, _I, _P),
    "mies_tv_energy": (*(_P,) * 6, _I, _I, _I, _I, _F, _F, _F, _P),
    "mies_perona_malik": (_P, _P, *(_I,) * 5, _F, _F, _I, _P),
    "mies_srad": (_P, _P, *(_I,) * 7, _F, _F, _F, _F, _P),
    "mies_clahe3d_apply": (_P, _P, _P, *(_I,) * 9, _F, _F, _F, *(_I,) * 5,
                           _P),
    "mies_clahe3d_apply_band": (_P, _P, _P, *(_I,) * 9, _F, _F, _F,
                                *(_I,) * 8, _P),
    "mies_clahe3d_skimage_apply": (_P, _P, _P, *(_I,) * 21, _P),
    "mies_unsharp_gauss": (_P, _P, _I, _I, _I, _P, _I, _P, _I, _F, _P),
    "mies_bilateral_unsharp": (_P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _I, _F,
                               _I, _P),
}

# launches per kernel wrapper since the last reset_launches()
LAUNCHES = {"tile_hists": 0, "tile_hists_bins": 0, "tile_luts": 0,
            "clahe_apply_lut": 0, "clahe_apply_lut_band": 0,
            "skimage_maps": 0, "skimage_apply": 0,
            "bilateral": 0, "unsharp_quant": 0, "bilateral_unsharp": 0,
            "nl_means": 0, "tv": 0, "srad": 0, "perona_malik": 0,
            "clahe3d_apply": 0, "clahe3d_apply_band": 0,
            "clahe3d_skimage_apply": 0,
            "unsharp_gauss": 0}

# mies op name -> operations of one call, fn(*the op's arguments): the
# counts the bounds in PERF.md section 6 take (utils.profiling.stage_costs)
OPERATIONS: dict = {}

_THROUGH_OPS = contextvars.ContextVar("mies_through_ops", default=False)
_lib: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             *CUDA_HOMES)
    for home in filter(None, homes):
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "mies_tpu_torch CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """The flags', sources' and headers' hash: a header edit rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> bool:
    """Compile csrc/*.cu into LIBRARY unless it is current; returns
    whether it compiled."""
    digest = _digest()
    stamp = LIBRARY.with_suffix(".sha256")
    if LIBRARY.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return False
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        lib = Path(tmp) / LIBRARY.name
        _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, LIBRARY)
    stamp.write_text(digest)
    return True


def _run_all(cmds: list[list[str]]) -> None:
    """Start every command at once, wait for all of them, and raise with
    the compiler's output if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(proc.args)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream (the
    stream is appended to ``args``) and count one launch of ``name``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} ({name}) did not launch: CUDA error {rc}")
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def exporting() -> bool:
    """Whether ``torch.export`` is tracing (or ``through_ops`` is on): the
    wrappers then call their ``torch.ops.mies`` op instead of launching."""
    return _THROUGH_OPS.get() or torch.compiler.is_exporting()


@contextlib.contextmanager
def through_ops():
    """Route the wrappers' eager calls through their ``torch.ops.mies`` ops
    inside the block."""
    token = _THROUGH_OPS.set(True)
    try:
        yield
    finally:
        _THROUGH_OPS.reset(token)


def _shares_storage(out: torch.Tensor, args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.untyped_storage().data_ptr()
               == out.untyped_storage().data_ptr() for a in args)


def register_op(name: str, wrapper, schema: str, fake, ops):
    """Register ``wrapper`` as the custom op ``mies::<name>`` of ``schema``
    (its arguments in the wrapper's order) with ``fake(*args)`` giving the
    output's shape and dtype and ``ops(*args)`` the operations of a call
    (``OPERATIONS``). An op's output may not alias an input, so where the
    wrapper returns its input (zero iterations) the op copies it."""
    def impl(*args):
        token = _THROUGH_OPS.set(False)  # the wrapper runs its own body
        try:
            out = wrapper(*args)
        finally:
            _THROUGH_OPS.reset(token)
        return out.clone() if _shares_storage(out, args) else out

    op = torch.library.custom_op(f"mies::{name}", impl, mutates_args=(),
                                 device_types=("cpu", "cuda"), schema=schema)
    op.register_fake(fake)
    OPERATIONS[name] = ops
    return op


def check_tensor(t: torch.Tensor, what: str, ndim: int = 3,
                 dtype: torch.dtype = torch.float32) -> None:
    """The kernels take contiguous ``dtype`` tensors of rank ``ndim`` on
    the CPU (plain version) or a CUDA device (kernel); raise otherwise."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: device {t.device} is neither cpu nor cuda")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
