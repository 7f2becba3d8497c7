"""HTTP inference serving on the card: a resident enhancement endpoint.

The port of ``mies_tpu.serve``, with the reference's routes, status codes,
headers and refusals. The CLI pays process start-up and the first call's
costs (the kernel build, the allocator) per invocation; clinical
integrations (PACS hooks, modality gateways) want a resident process that
holds the chain and answers over HTTP. This is that front end: stdlib only
(``http.server``), one process, the same decode -> chain -> encode path as
``pipeline.runner.enhance_image``:

  GET  /healthz            liveness + backend (the device type) + the
                           shapes served so far
  GET  /config             the active pipeline config (JSON)
  POST /enhance            body = image bytes (PNG/JPEG/TIFF/DICOM);
                           responds image/png (uint8). The input format
                           is taken from Content-Type or ``?filename=``
                           (DICOM needs one of them; PNG/JPEG/TIFF
                           sniff fine either way). ``?metrics=psnr,ssim``
                           adds an ``X-Mies-Metrics`` JSON header
                           computed against the (windowed) input.

PyTorch runs eagerly and binds a chain's stages when it is built, so the
server builds its chain once, at start-up, and keeps it; ``--warmup HxW``
runs it once on that uint8 shape before the socket serves (the first
call's nvcc build, allocator growth and cuDNN search happen then, not in
the first request). Requests are served from a threading server: each
handler thread launches on the device's current stream, and the GIL
serializes the host work. Artifact mode serves one exported program
(``pipeline.export``) instead of the config's chain.

Every request's decode and encode (host clock) and chain (CUDA events on
the card, the host clock on the CPU) milliseconds are kept in
``server.state.timings`` (the last 4,096 requests).
"""

from __future__ import annotations

import io
import json
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from mies_tpu_torch.pipeline.config import PipelineConfig

_SUFFIX_BY_TYPE = {
    "image/png": ".png",
    "image/jpeg": ".jpg",
    "image/tiff": ".tif",
    "application/dicom": ".dcm",
}


class _State:
    """What the handler threads share: the config, the chain built once on
    ``device`` (or the artifact's program and header), the shapes served
    and the per-request timings."""

    def __init__(self, cfg: PipelineConfig, device: torch.device,
                 artifact_fn=None, artifact_header: dict | None = None):
        from mies_tpu_torch.pipeline.compiler import compile_pipeline

        self.cfg = cfg
        self.device = device
        self.artifact_fn = artifact_fn
        self.artifact_header = artifact_header
        self.chain = (compile_pipeline(cfg, device=device)
                      if artifact_fn is None else None)
        self.shapes: set = set()
        self.timings: deque = deque(maxlen=4096)
        self.lock = threading.Lock()

    def run(self, img: np.ndarray) -> tuple[np.ndarray, float]:
        """The chain (or the artifact) on one decoded image -> (uint8 on the
        host, the chain's milliseconds)."""
        from mies_tpu_torch.pipeline.compiler import _to_device

        fn = self.chain if self.artifact_fn is None else self.artifact_fn
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = fn(_to_device(img, self.device))
            end.record()
            out = y.cpu().numpy()  # synchronizes
            return out, start.elapsed_time(end)
        t0 = time.perf_counter()
        out = fn(_to_device(img, self.device)).numpy()
        return out, (time.perf_counter() - t0) * 1e3


def validate_servable_artifact(header: dict) -> None:
    """Start-up gate: only single-slice [H, W] quantizing artifacts are
    servable; a batched / volume / float-output export would otherwise
    start a healthy-looking server that 400s every request."""
    shape = header.get("input_shape", [])
    if header.get("volume") or len(shape) != 2:
        raise ValueError(
            f"artifact takes input shape {shape}; serving needs a "
            f"single-slice [H, W] program — re-export with --batch 1 "
            f"(and without --volume)"
        )
    if not header.get("quantize", True):
        raise ValueError(
            "artifact was exported with quantize=False (float output — "
            "not PNG-encodable); re-export with quantization"
        )
    if header.get("input_dtype", "float32") not in (
            "float32", "uint8", "uint16", "int16"):
        raise ValueError(
            f"unsupported artifact input_dtype "
            f"{header.get('input_dtype')!r}")


def _decode(state: _State, body: bytes, suffix: str) -> np.ndarray:
    """The request body's raw integer pixels (``io.image.load_image``
    dtype='raw', the config's io.channels policy)."""
    from mies_tpu_torch.io.image import load_image

    with tempfile.NamedTemporaryFile(suffix=suffix or ".png") as f:
        f.write(body)
        f.flush()
        return load_image(f.name, dtype="raw",
                          channels=state.cfg.io_dict().get("channels"))


def _encode_png(out: np.ndarray) -> bytes:
    from PIL import Image

    if out.ndim == 3:  # [C, H, W] per-channel -> interleaved RGB-ish
        arr = np.moveaxis(out, 0, -1)
        out = arr[..., :3] if arr.shape[-1] >= 3 else arr[..., 0]
    buf = io.BytesIO()
    Image.fromarray(out).save(buf, format="PNG")
    return buf.getvalue()


def _artifact_input(state: _State, raw: np.ndarray) -> np.ndarray:
    """The artifact's input from the decoded pixels. Artifact mode serves
    ONE exported program: the input must decode to the artifact's exact
    [H, W] spec (fixed-modality PACS deployments); a mismatch is a 400
    with the expected shape, never a silent resize. Ingest follows the
    chain's contract: raw integer pixels go to the device and normalize
    in the program (uint8 / uint16 artifacts; int16 HU feeds window_hu)."""
    hdr = state.artifact_header
    want = tuple(hdr["input_shape"])
    want_dtype = hdr.get("input_dtype", "float32")
    if want_dtype == str(raw.dtype):
        img = raw  # in-program ingest (the exported chain normalizes)
    elif want_dtype == "float32":
        if raw.dtype == np.uint8:
            img = raw.astype(np.float32) / 255.0
        elif raw.dtype == np.uint16:
            img = raw.astype(np.float32) / 65535.0
        else:
            raise ValueError(
                f"int16 HU input needs an int16-spec artifact "
                f"(re-export with input_dtype='int16'); this artifact "
                f"takes float32"
            )
    else:
        raise ValueError(
            f"artifact expects {want_dtype} input, this file decodes "
            f"to {raw.dtype} — re-export for this modality"
        )
    if img.shape != want:
        raise ValueError(
            f"artifact expects shape {list(want)}, got {list(img.shape)} "
            f"(artifact mode serves one fixed program; re-export for "
            f"this modality's shape)"
        )
    return np.ascontiguousarray(img)


def _metrics(state: _State, body: bytes, suffix: str, out: np.ndarray,
             metric_names: list[str]) -> dict:
    """``?metrics=``: the port's ``eval`` metrics of the output against
    the input's uint8 form (``eval.report.reference_u8``)."""
    from mies_tpu_torch.eval.metrics import evaluate
    from mies_tpu_torch.eval.report import reference_u8

    with tempfile.NamedTemporaryFile(suffix=suffix or ".png") as f:
        f.write(body)
        f.flush()
        ref = reference_u8(f.name, state.cfg)
    if ref.shape != out.shape:
        raise ValueError(
            f"metrics need a shape-preserving chain (input "
            f"{ref.shape} vs output {out.shape})"
        )
    names, dev = tuple(metric_names), state.device
    if out.ndim == 3:  # per-channel: mean over C
        m = [evaluate(ref[c], out[c], names, device=dev)
             for c in range(out.shape[0])]
        return {k: float(np.mean([mi[k] for mi in m])) for k in m[0]}
    return evaluate(ref, out, names, device=dev)


def _enhance_bytes(state: _State, body: bytes, suffix: str,
                   metric_names: list[str]) -> tuple[bytes, dict | None]:
    """Decode -> the chain (or the artifact) -> PNG bytes (+ metrics)."""
    if state.artifact_fn is not None and metric_names:
        raise ValueError(
            "metrics are unavailable in artifact mode "
            "(the artifact carries no reference path)"
        )
    t0 = time.perf_counter()
    img = _decode(state, body, suffix)
    if state.artifact_fn is not None:
        img = _artifact_input(state, img)
    t1 = time.perf_counter()
    out, chain_ms = state.run(img)
    metrics = (_metrics(state, body, suffix, out, metric_names)
               if metric_names else None)
    t3 = time.perf_counter()
    png = _encode_png(out)
    t4 = time.perf_counter()
    with state.lock:
        state.shapes.add(out.shape[-2:])
        state.timings.append({"decode_ms": (t1 - t0) * 1e3,
                              "chain_ms": chain_ms,
                              "encode_ms": (t4 - t3) * 1e3})
    return png, metrics


DEFAULT_MAX_BODY_BYTES = 256 * 2**20  # largest clinical single-slice ask


def make_server(
    cfg: PipelineConfig, host: str = "127.0.0.1", port: int = 8080,
    artifact_fn=None, artifact_header: dict | None = None,
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
    request_timeout: float | None = 60.0,
    device="cuda",
) -> ThreadingHTTPServer:
    """Build (not start) the serving HTTPServer for ``cfg`` on ``device``
    ("cuda" by default: no card -> RuntimeError; "cpu" serves the plain
    chain). The chain is built here, once; ``server.state`` holds it.

    ``max_body_bytes`` caps POST bodies: an oversized request is a 413
    rejected from its Content-Length alone, BEFORE any body byte is
    read, so a hostile or buggy client cannot make the server allocate
    arbitrary host memory. ``request_timeout`` is the per-connection
    socket timeout (socketserver's handler timeout): a stalled client
    cannot pin a worker thread forever."""
    from mies_tpu_torch.pipeline.compiler import resolve_device

    state = _State(cfg, resolve_device(device), artifact_fn, artifact_header)

    class Handler(BaseHTTPRequestHandler):
        timeout = request_timeout  # connection.settimeout in setup()

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                with state.lock:
                    shapes = sorted(map(list, state.shapes))
                self._json(200, {
                    "status": "ok",
                    "backend": state.device.type,
                    "pipeline": state.cfg.name,
                    "mode": (
                        "artifact" if state.artifact_fn is not None
                        else "jit"
                    ),
                    "compiled_shapes": shapes,
                })
            elif path == "/config":
                self._json(200, state.cfg.to_dict())
            else:
                self._json(404, {"error": f"no route {path!r}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/enhance":
                self._json(404, {"error": f"no route {url.path!r}"})
                return
            q = parse_qs(url.query)
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "invalid Content-Length"})
                return
            if n <= 0:
                self._json(400, {"error": "empty body"})
                return
            if n > max_body_bytes:
                # refuse BEFORE reading: the body never gets allocated.
                # The unread body makes the connection unusable for
                # keep-alive, so close it.
                self.close_connection = True
                self._json(413, {
                    "error": f"body of {n} bytes exceeds the "
                             f"{max_body_bytes}-byte limit (configure "
                             f"with --max-body-mb)"
                })
                return
            body = self.rfile.read(n)
            fname = q.get("filename", [""])[0]
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            suffix = (
                Path(fname).suffix.lower()
                or _SUFFIX_BY_TYPE.get(ctype.strip().lower(), "")
            )
            metric_names = [
                m for ms in q.get("metrics", []) for m in ms.split(",") if m
            ]
            try:
                png, metrics = _enhance_bytes(state, body, suffix,
                                              metric_names)
            except Exception as e:  # noqa: BLE001 - per-request isolation
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            if metrics is not None:
                self.send_header("X-Mies-Metrics", json.dumps(metrics))
            self.end_headers()
            self.wfile.write(png)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.state = state
    return srv


def serve(
    config_path: str | Path | None = None,
    host: str = "127.0.0.1",
    port: int = 8080,
    warmup: tuple[int, int] | None = None,
    artifact: str | Path | None = None,
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
    device="cuda",
) -> None:
    """Blocking entry: load the config (or a .mies artifact), build the
    kernels (on the card) and the chain, optionally warm it, serve."""
    from mies_tpu_torch.pipeline.compiler import resolve_device
    from mies_tpu_torch.pipeline.config import load_config
    from mies_tpu_torch.utils.profiling import (
        device_sync,
        enable_compilation_cache,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        enable_compilation_cache()
    if artifact is not None:
        from mies_tpu_torch.pipeline.config import from_dict
        from mies_tpu_torch.pipeline.export import load_exported

        fn, header = load_exported(artifact, device=dev)
        validate_servable_artifact(header)
        cfg = from_dict(header["config"])
        srv = make_server(cfg, host, port,
                          artifact_fn=fn, artifact_header=header,
                          max_body_bytes=max_body_bytes, device=dev)
        announce = {
            "serving": f"http://{host}:{srv.server_address[1]}",
            "pipeline": cfg.name,
            "mode": "artifact",
            "input_shape": header["input_shape"],
            "input_dtype": header.get("input_dtype", "float32"),
        }
        return _run_server(srv, announce)
    if config_path is None:
        raise ValueError("serve needs a config path or an artifact")
    cfg = load_config(config_path)
    srv = make_server(cfg, host, port, max_body_bytes=max_body_bytes,
                      device=dev)
    if warmup is not None:
        # requests ingest RAW integer pixels (uint8 PNGs, uint16 16-bit,
        # int16 DICOM): warm the uint8 signature, the common one
        h, w = warmup
        device_sync(srv.state.chain(np.zeros((h, w), np.uint8)))
    return _run_server(srv, {
        "serving": f"http://{host}:{srv.server_address[1]}",
        "pipeline": cfg.name,
    })


def _run_server(srv: ThreadingHTTPServer, announce: dict) -> None:
    print(json.dumps(announce), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
