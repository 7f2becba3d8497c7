"""File entry points (load -> enhance -> save) and the throughput,
latency and device-time harnesses on the card (CUDA events,
``torch.profiler``).

The entry points have the reference's signatures and return values
(``mies_tpu/pipeline/runner.py``) plus ``device``: they run on the card
("cuda", the default; no card -> RuntimeError) unless the caller passes
``device="cpu"`` (the plain chain):

  enhance_image          one 2-D file -> uint8 (and optionally a file)
  enhance_batch          many files -> an output directory; resumable
                         through the run manifest, per-item fault
                         isolation, bucketed by (shape, dtype)
  enhance_volume         an in-memory [Z, H, W] volume, slab by slab
  enhance_volume_stream  disk to disk with O(slab) host memory (BASELINE
                         w5: a 512^3 int16 .nc through
                         ``presets.flagship_volume_config``)

On the card each of them feeds the chain through ``_DevicePipe``: a ring
of ``max_in_flight`` pinned host staging buffers per (shape, dtype),
allocated once; a host-to-device copy stream, the chain on the current
stream and a device-to-host stream, ordered by CUDA events, so the copy
of slab k+1 and the write-back of slab k-1 overlap the chain on slab k,
and the host reads and decodes the next slab meanwhile. A slab's output
is synchronized only when it is drained to the writer; a staging buffer
is reused only after its copy's event completed. Since every op's
statistics are per image, nothing pads: a short last slab or batch runs
as it is.

The timing harness:

    python -m mies_tpu_torch.pipeline.runner configs/xray_adapthist_skimage.yaml

prints one JSON line: the config's batched throughput at b32 512^2 on
seeded slices of the config's ``io.dtype`` (and, with --profile, its
device time by kernel and busy share). With ``--volume Z`` the config runs
as a volume program (``compile_volume_pipeline``) on one seeded
[Z, 512, 512] volume, reported in z-slices/s:

    python -m mies_tpu_torch.pipeline.runner configs/ct_volume_3d.yaml --volume 256

``time_pipeline_device`` and ``time_latency_device`` (the reference's
``fori_loop`` timers) time the chain ``inner`` times in one CUDA graph,
without the host's per-call dispatch.

A measurement needs a CUDA device: asked for any other device, or run
where there is no card, these raise instead of timing the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import queue
import sys
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from mies_tpu_torch.io.image import load_image, save_image
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.pipeline.compiler import (
    build_batched_chain,
    compile_pipeline,
    compile_volume_pipeline,
    resolve_device,
)
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
from mies_tpu_torch.pipeline.manifest import RunManifest

# stages whose output slice shape differs from their input's: the
# streamed output's header is sized from the input before any slab runs
SHAPE_CHANGERS = frozenset({"resize", "center_crop", "rot90"})


def _progress(it: Iterable, total: int, unit: str, enabled: bool) -> Iterable:
    """``tqdm`` over ``it`` when progress is asked for and tqdm is
    installed; without tqdm, one plain line per item on stderr."""
    if not enabled:
        return it
    try:
        from tqdm import tqdm
    except ImportError:
        return _plain_progress(it, total, unit)
    return tqdm(it, total=total, unit=unit)


def _plain_progress(it: Iterable, total: int, unit: str) -> Iterator:
    for i, item in enumerate(it, 1):
        yield item
        print(f"{unit} {i}/{total}", file=sys.stderr, flush=True)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One staging place of the ring: a host input buffer (pinned on the
    card), a host output buffer, and the events of its last copy in and
    its last copy out."""

    def __init__(self, cap: int, item_shape: tuple, dtype: np.dtype,
                 cuda: bool) -> None:
        self.host_in = torch.empty((cap, *item_shape), dtype=_torch_dtype(dtype),
                                   pin_memory=cuda)
        self.host_in_np = self.host_in.numpy()
        self.host_out: torch.Tensor | None = None
        self.h2d = torch.cuda.Event() if cuda else None
        self.d2h = torch.cuda.Event() if cuda else None
        self.busy = False


class _DevicePipe:
    """Feed host arrays through the batched chain ``fn`` with at most
    ``depth`` batches in flight, handing each output, in submission
    order, to ``consume(tag, uint8 array)``. The array handed over is a
    view of a staging buffer, valid only during the call.

    On the card: ``depth`` pinned input and output buffers per (item
    shape, dtype), allocated once; each input is copied into its slot's
    pinned buffer, sent with ``non_blocking`` on the copy stream, the
    chain waits on that copy's event, its output comes back with
    ``non_blocking`` on the write-back stream into the slot's pinned
    output, whose event is synchronized only when the slot is drained.
    On the CPU the chain runs at once on the staged tensor.
    """

    def __init__(self, fn: Callable, dev: torch.device, depth: int,
                 consume: Callable[[object, np.ndarray], None]) -> None:
        if depth < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {depth}")
        self.fn, self.dev, self.depth, self.consume = fn, dev, depth, consume
        self.cuda = dev.type == "cuda"
        self.rings: dict[tuple, tuple[list[_Slot], list[int]]] = {}
        self.queue: deque = deque()  # (slot, n, tag), oldest first
        if self.cuda:
            self.compute = torch.cuda.current_stream(dev)
            self.h2d_stream = torch.cuda.Stream(dev)
            self.d2h_stream = torch.cuda.Stream(dev)

    def _slot(self, cap: int, item_shape: tuple, dtype: np.dtype) -> _Slot:
        key = (item_shape, dtype.str)
        if key not in self.rings:
            self.rings[key] = ([], [0])
        ring, nxt = self.rings[key]
        if len(ring) < self.depth:
            ring.append(_Slot(cap, item_shape, dtype, self.cuda))
            return ring[-1]
        slot = ring[nxt[0] % self.depth]
        nxt[0] += 1
        while slot.busy:  # its last output is still queued: drain to it
            self._drain_one()
        return slot

    def submit(self, items: np.ndarray | Sequence[np.ndarray], tag,
               cap: int) -> None:
        """Stage ``items`` (an array [n, ...] or n arrays of one shape and
        dtype, n <= cap) and launch the chain on them."""
        first = items[0]
        n = len(items)
        if n > cap:
            raise ValueError(f"{n} items exceed the staging capacity {cap}")
        while len(self.queue) >= self.depth:
            self._drain_one()
        # staged in native byte order (np.copyto swaps a big-endian input)
        slot = self._slot(cap, tuple(first.shape),
                          np.dtype(first.dtype).newbyteorder("="))
        if slot.h2d is not None:
            slot.h2d.synchronize()  # its last copy in has left the buffer
        if isinstance(items, np.ndarray):
            np.copyto(slot.host_in_np[:n], items)
        else:
            for i, a in enumerate(items):
                np.copyto(slot.host_in_np[i], a)
        host = slot.host_in[:n]
        if not self.cuda:
            out = self.fn(host)
            slot.host_out = out
        else:
            with torch.cuda.stream(self.h2d_stream):
                x = torch.empty(host.shape, dtype=host.dtype, device=self.dev)
                x.copy_(host, non_blocking=True)
                slot.h2d.record(self.h2d_stream)
            with torch.cuda.stream(self.compute):
                self.compute.wait_event(slot.h2d)
                x.record_stream(self.compute)
                y = self.fn(x)
                ready = torch.cuda.Event()
                ready.record(self.compute)
            del x
            if (slot.host_out is None or slot.host_out.dtype != y.dtype
                    or tuple(slot.host_out.shape[1:]) != tuple(y.shape[1:])
                    or slot.host_out.shape[0] < n):
                slot.host_out = torch.empty((cap, *y.shape[1:]),
                                            dtype=y.dtype, pin_memory=True)
            with torch.cuda.stream(self.d2h_stream):
                self.d2h_stream.wait_event(ready)
                slot.host_out[:n].copy_(y, non_blocking=True)
                y.record_stream(self.d2h_stream)
                slot.d2h.record(self.d2h_stream)
        slot.busy = True
        self.queue.append((slot, n, tag))

    def _drain_one(self) -> None:
        slot, n, tag = self.queue.popleft()
        if slot.d2h is not None:
            slot.d2h.synchronize()
        slot.busy = False
        self.consume(tag, slot.host_out[:n].numpy())

    def flush(self) -> None:
        while self.queue:
            self._drain_one()


def enhance_image(
    input_path: str | Path,
    cfg: PipelineConfig,
    output_path: str | Path | None = None,
    device="cuda",
) -> np.ndarray:
    """Enhance one 2-D image file; returns (and optionally saves) uint8.

    Multi-channel inputs follow the config's ``io.channels`` policy
    ('gray' | 'per-channel'); per-channel outputs are [C, H, W]. The raw
    integer pixels go to ``device`` and are normalized there by the
    chain's ingest.
    """
    dev = resolve_device(device)
    img = load_image(input_path, dtype="raw",
                     channels=cfg.io_dict().get("channels"))
    fn = compile_pipeline(cfg, device=dev)
    out = fn(img).cpu().numpy()
    if output_path is not None:
        save_image(output_path, out)
    return out


def enhance_batch(
    input_paths: Sequence[str | Path],
    cfg: PipelineConfig,
    output_dir: str | Path,
    batch_size: int = 32,
    resume: bool = True,
    progress: bool = True,
    mesh=None,
    device="cuda",
) -> RunManifest:
    """Enhance many images; resumable, per-item fault isolation.

    Files are decoded a batch ahead (a one-thread prefetcher over an
    8-thread decode pool) while the card runs the batch before; each
    batch is bucketed by (shape, dtype), so mixed sizes run as separate
    groups. The manifest records each completed output under the
    config's ``cache_key()`` (equal to the reference's, so a run the JAX
    package began resumes here), and a re-run processes only the
    remainder. Outputs keep their input's file name.

    With a ``mesh`` (``parallel.make_mesh`` over every rank of the process
    group; every rank calls this) each (shape, dtype) group is padded with
    copies of its last image to a multiple of the mesh's size and split
    over the ranks (``_MeshFeed``): the mesh's first rank decodes, sends
    each rank its part, gathers the outputs, saves them, keeps the
    manifest and returns it; the other ranks return None. ``batch_size``
    must divide by the mesh's size.
    """
    feed = None
    if mesh is not None:
        from mies_tpu_torch.parallel.sharding import shard_pipeline

        if cfg.io_dict().get("channels") == "per-channel":
            raise ValueError(
                "enhance_batch: io.channels='per-channel' with a device "
                "mesh is not supported yet (the sharded program shards "
                "[B, H, W]); run without a mesh"
            )
        if batch_size % mesh.size():
            raise ValueError(
                f"batch_size {batch_size} must divide by the mesh's "
                f"{mesh.size()} devices"
            )
        feed = _MeshFeed(shard_pipeline(cfg, mesh), mesh)
        if not feed.is_root:
            feed.follow()
            return None
    try:
        return _enhance_batch(input_paths, cfg, output_dir, batch_size,
                              resume, progress, feed, device)
    finally:
        if feed is not None:
            feed.close()


def _enhance_batch(input_paths, cfg: PipelineConfig, output_dir,
                   batch_size: int, resume: bool, progress: bool, feed,
                   device) -> RunManifest:
    """``enhance_batch`` on this process: through ``feed`` (the mesh's
    first rank) or the ``_DevicePipe`` on ``device``."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    manifest = RunManifest(output_dir / "manifest.jsonl", cfg.cache_key())

    paths = [Path(p) for p in input_paths]
    todo = manifest.pending([str(p) for p in paths]) if resume else [str(p) for p in paths]
    todo_paths = [Path(p) for p in todo]
    if not todo_paths:
        return manifest

    channels = cfg.io_dict().get("channels")

    def try_load(p):
        try:
            # raw integer pixels: normalized on the card by the chain's
            # ingest (a quarter of float32's host-to-device bytes)
            return load_image(p, dtype="raw", channels=channels)
        except Exception as e:  # corrupt input: recorded, the run goes on
            return e

    def load_chunk(chunk):
        imgs, ok_paths = [], []
        for p, res in zip(chunk, decode_pool.map(try_load, chunk)):
            if isinstance(res, Exception):
                manifest.mark_failed(str(p), f"load: {res}")
            else:
                imgs.append(res)
                ok_paths.append(p)
        return imgs, ok_paths

    def finish(ok_paths, out):
        for i, p in enumerate(ok_paths):
            dst = output_dir / p.name
            try:
                save_image(dst, out[i])
                manifest.mark_done(str(p), output=str(dst))
            except Exception as e:  # one unwritable output fails one item
                manifest.mark_failed(str(p), f"save: {e}")

    if feed is None:
        dev = resolve_device(device)
        # three batches in flight: decode, the card and the saves overlap
        pipe = _DevicePipe(compile_pipeline(cfg, batched=True, device=dev),
                           dev, 3, finish)
        submit, flush = pipe.submit, pipe.flush
    else:
        def submit(gimgs, gpaths, cap):
            finish(gpaths, feed.submit(np.stack(gimgs)))
        flush = None
    chunks = [todo_paths[s : s + batch_size]
              for s in range(0, len(todo_paths), batch_size)]
    with ThreadPoolExecutor(max_workers=8) as decode_pool, \
            ThreadPoolExecutor(max_workers=1) as prefetcher:
        next_fut = prefetcher.submit(load_chunk, chunks[0])
        for ci in _progress(range(len(chunks)), len(chunks), "batch", progress):
            imgs, ok_paths = next_fut.result()
            if ci + 1 < len(chunks):
                next_fut = prefetcher.submit(load_chunk, chunks[ci + 1])
            groups: dict[tuple, tuple[list, list]] = {}
            for arr, p in zip(imgs, ok_paths):
                g = groups.setdefault((arr.shape, arr.dtype.str), ([], []))
                g[0].append(arr)
                g[1].append(p)
            for gimgs, gpaths in groups.values():
                submit(gimgs, gpaths, cap=batch_size)
        if flush is not None:
            flush()
    return manifest


def enhance_volume(
    volume: np.ndarray,
    cfg: PipelineConfig,
    slab_size: int = 16,
    max_in_flight: int = 4,
    progress: bool = False,
    mesh=None,
    device="cuda",
) -> np.ndarray:
    """Run a [Z, H, W] volume through the batched chain slab by slab,
    at most ``max_in_flight`` slabs on the card at once; returns the
    uint8 [Z, ...] result.

    With a ``mesh`` (``parallel.make_mesh`` over every rank of the process
    group; every rank calls this), each slab is split over the mesh's
    ranks: the first rank of the mesh holds ``volume`` (the others may
    pass None), sends each rank its part of every slab, each rank runs the
    chain on its own slices on its own device, and the first rank gathers
    the parts and returns the whole output; the others return None.
    ``slab_size`` must divide by the mesh's size."""
    if mesh is not None:
        return _enhance_volume_mesh(volume, cfg, slab_size, progress, mesh)
    dev = resolve_device(device)
    fn = compile_pipeline(cfg, batched=True, device=dev)
    outs: list[np.ndarray] = []
    pipe = _DevicePipe(fn, dev, max_in_flight,
                       lambda _, out: outs.append(out.copy()))
    starts = range(0, volume.shape[0], slab_size)
    for k in _progress(starts, len(starts), "slab", progress):
        pipe.submit(volume[k : k + slab_size], None, cap=slab_size)
    pipe.flush()
    return np.concatenate(outs, axis=0)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as uint8 [..., bytes per row] (NCCL has
    no int16 or uint16)."""
    return t.contiguous().view(torch.uint8)


def _enhance_volume_mesh(volume, cfg: PipelineConfig, slab_size: int,
                         progress: bool, mesh) -> np.ndarray | None:
    """``enhance_volume`` with a mesh: slab k's part i (its slices
    [k + i s/n, k + (i + 1) s/n)) runs the batched chain on the mesh's
    i-th rank (row-major coordinates, ``parallel.sharding.shard_index``),
    as the reference's batch-sharded slab program splits it."""
    from mies_tpu_torch.parallel.sharding import shard_pipeline

    if slab_size % mesh.size():
        raise ValueError(
            f"slab_size {slab_size} must divide by the mesh's {mesh.size()} "
            f"devices"
        )
    return run_sharded(volume, shard_pipeline(cfg, mesh), slab_size, mesh,
                       progress)


class _MeshFeed:
    """Groups of items through ``fn`` on every rank of ``mesh`` (a mesh over
    the whole process group), driven by the mesh's first rank (the root).

    The root calls ``submit(items)`` for each group ([k, ...], one shape
    and dtype) and ``close()`` at the end; every other rank calls
    ``follow()``, which serves the root's groups until it closes. A group
    is padded with copies of its last item to a multiple of the mesh's
    size n, its header (shape, dtype) broadcast, part i of it scattered to
    the mesh's i-th rank (row-major coordinates,
    ``parallel.sharding.shard_index``), ``fn`` run on every rank's part on
    its own device, and the outputs gathered on the root, which returns
    them (those of the padding dropped)."""

    def __init__(self, fn: Callable, mesh) -> None:
        import torch.distributed as dist

        from mies_tpu_torch.parallel.mesh import mesh_device

        self.n = mesh.size()
        if self.n != dist.get_world_size():
            raise ValueError(f"the mesh has {self.n} of the process group's "
                             f"{dist.get_world_size()} ranks; give it all")
        self.fn, self.dev = fn, mesh_device(mesh)
        self.ranks = mesh.mesh.flatten().tolist()  # the rank of each part
        self.root = self.ranks[0]
        self.is_root = dist.get_rank() == self.root

    def _head(self, head):
        import torch.distributed as dist

        box = [head]
        dist.broadcast_object_list(box, src=self.root)
        return box[0]

    def _step(self, shape, dtype: np.dtype, items) -> np.ndarray | None:
        import torch.distributed as dist

        part = shape[0] // self.n
        mine = torch.empty((part, *shape[1:]), dtype=_torch_dtype(dtype),
                           device=self.dev)
        parts = None
        if self.is_root:
            group = torch.from_numpy(np.ascontiguousarray(items, dtype)
                                     ).to(self.dev).split(part)
            parts = [_as_bytes(group[self.ranks.index(r)])
                     for r in range(self.n)]
        dist.scatter(_as_bytes(mine), parts, src=self.root)
        y = self.fn(mine).contiguous()
        got = ([torch.empty_like(y) for _ in range(self.n)] if self.is_root
               else None)
        dist.gather(y, got, dst=self.root)
        if self.is_root:
            return torch.cat([got[r] for r in self.ranks]).cpu().numpy()
        return None

    def submit(self, items: np.ndarray) -> np.ndarray:
        items = np.asarray(items)
        k, pad = len(items), -len(items) % self.n
        if pad:
            items = np.concatenate([items, np.repeat(items[-1:], pad, 0)])
        # staged in native byte order (a .nc volume is big-endian)
        dtype = items.dtype.newbyteorder("=")
        self._head((items.shape, dtype.str))
        out = self._step(items.shape, dtype, items)
        # an unpadded group keeps fn's own length (a z-resampled volume)
        return out[:k] if pad else out

    def follow(self) -> None:
        while (head := self._head(None)) is not None:
            self._step(head[0], np.dtype(head[1]), None)

    def close(self) -> None:
        if self.is_root:
            self._head(None)


def run_sharded(volume, fn: Callable, slab_size: int, mesh,
                progress: bool = False) -> np.ndarray | None:
    """Run a [Z, H, W] volume through ``fn`` on every rank of ``mesh`` (a
    mesh over the whole process group; every rank calls this): the mesh's
    first rank holds ``volume`` (the others may pass None), cuts it into
    slabs of ``slab_size`` slices, sends the mesh's i-th rank part i of
    every slab (``_MeshFeed``), each rank runs ``fn`` on its part on its own
    device, and the first rank gathers the parts' outputs and returns the
    whole output; the others return None. ``enhance_volume(mesh=)`` runs
    the batched chain so; ``enhance-volume --mode 3d --data-parallel`` one
    slab of the whole volume through ``parallel.volume_shard_apply``."""
    feed = _MeshFeed(fn, mesh)
    if not feed.is_root:
        feed.follow()
        return None
    try:
        volume = np.asarray(volume)
        starts = range(0, volume.shape[0], slab_size)
        outs = [feed.submit(volume[k:k + slab_size])
                for k in _progress(starts, len(starts), "slab", progress)]
    finally:
        feed.close()
    return np.concatenate(outs, axis=0)


# the streamed volume's read buffers: one is filled while the other is staged
READ_BUFFERS = 2


def _read_ahead(reader, slab_size: int) -> Iterator[np.ndarray]:
    """The slabs of ``reader`` (an ``io.volume.SlabReader``), read on a
    worker thread into ``READ_BUFFERS`` buffers of [slab_size, H, W]
    allocated before the first read. Each slab yielded is a view of one
    buffer (``buf[:n]`` for a short last slab), valid until the next slab
    is asked for: asking hands that buffer back to the reader. So the
    disk read and decode of slab k+1 overlap the staging and the write of
    slab k, and the host holds ``READ_BUFFERS`` input slabs whatever the
    threads' timing. Closing the generator stops the reader."""
    z, *hw = reader.meta.shape
    free: queue.Queue = queue.Queue()
    for _ in range(READ_BUFFERS):
        free.put(np.empty((slab_size, *hw), reader.dtype))
    full: queue.Queue = queue.Queue()
    stop = threading.Event()

    def read() -> None:
        try:
            for k in range(0, z, slab_size):
                buf = free.get()
                if stop.is_set():
                    return
                n = min(slab_size, z - k)
                reader.read_into(k, buf[:n])
                full.put((buf, n))
            full.put(None)
        except BaseException as e:  # raised again on the caller's thread
            full.put(e)

    worker = threading.Thread(target=read, name="slab-reader", daemon=True)
    worker.start()
    try:
        while (item := full.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            buf, n = item
            yield buf[:n]
            free.put(buf)
    finally:
        stop.set()
        free.put(None)  # wakes a reader waiting for a buffer
        worker.join()


def enhance_volume_stream(
    source: str | Path,
    cfg: PipelineConfig,
    output: str | Path,
    slab_size: int = 16,
    max_in_flight: int = 4,
    var_name: str | None = None,
    progress: bool = False,
    mesh=None,
    device="cuda",
):
    """Disk-to-disk volume enhancement with O(slab) host memory.

    Reads [slab, H, W] chunks lazily (classic .nc via mmap, .npy memmap,
    HDF5 per chunk, or a DICOM series: ``io.volume.open_volume_reader``),
    one slab ahead on a reader thread, keeps ``max_in_flight`` slabs on
    the card, and appends each finished uint8 slab to ``output``
    (streaming NetCDF-3, .npy memmap, or a DICOM directory). The whole
    volume is never resident on the host. Returns the input VolumeMeta.

    Host memory, fixed before the first read: the reader fills
    ``READ_BUFFERS`` = 2 input slabs in place, one copy from the file's
    mapping each, and a buffer goes back to it only once
    ``_DevicePipe.submit`` has copied its slab into a staging slot (the
    pinned ring on the card, the staged tensor on the CPU) or the mesh
    has sent it. The outputs are written from the staging ring's own
    buffers. So the numpy side holds 2 input slabs plus a constant
    (the output file's header, a DICOM writer's one slice), whatever
    the threads' timing; a DICOM series adds its decode pool's 8 workers,
    each holding one file's bytes and one decoded slice, and a mesh the
    copy of a last slab padded to the mesh's size. The staging ring (up
    to ``max_in_flight`` slabs in and out) is torch memory, pinned on the
    card.

    With a ``mesh`` (every rank calls this) each slab is split over the
    mesh's ranks (``_MeshFeed``): the mesh's first rank reads the slabs,
    gathers their outputs, writes them and returns the VolumeMeta; the
    others return None. ``slab_size`` must divide by the mesh's size.
    """
    # the output header is written with the INPUT's (Z, H, W) before any
    # slab computes: stages that change the slice shape would corrupt it
    bad = [s.op for s in cfg.stages if s.op in SHAPE_CHANGERS]
    if bad:
        raise ValueError(
            f"enhance_volume_stream cannot run shape-changing stages "
            f"{bad}: the streamed output header is sized from the input; "
            f"use enhance_volume (in-memory) for this chain"
        )
    feed = None
    if mesh is not None:
        from mies_tpu_torch.parallel.sharding import shard_pipeline

        if slab_size % mesh.size():
            raise ValueError(
                f"slab_size {slab_size} must divide by the mesh's "
                f"{mesh.size()} devices"
            )
        feed = _MeshFeed(shard_pipeline(cfg, mesh), mesh)
        if not feed.is_root:
            feed.follow()
            return None
    try:
        return _stream(source, cfg, output, slab_size, max_in_flight,
                       var_name, progress, feed, device)
    finally:
        if feed is not None:
            feed.close()


def _stream(source, cfg: PipelineConfig, output, slab_size: int,
            max_in_flight: int, var_name, progress: bool, feed, device):
    """``enhance_volume_stream`` on this process: through ``feed`` (the
    mesh's first rank) or the ``_DevicePipe`` on ``device``."""
    from mies_tpu_torch.io.volume import open_volume_reader, open_volume_writer

    if feed is None:
        dev = resolve_device(device)
        fn = compile_pipeline(cfg, batched=True, device=dev)
    with open_volume_reader(source, var_name=var_name) as reader:
        meta = reader.meta
        writer = open_volume_writer(output, meta.shape, np.uint8)
        slabs = _read_ahead(reader, slab_size)
        try:
            if feed is None:
                pipe = _DevicePipe(fn, dev, max_in_flight,
                                   lambda _, out: writer.append(out))
                submit, flush = pipe.submit, pipe.flush
            else:
                def submit(slab, tag, cap):
                    writer.append(feed.submit(slab))
                flush = None
            nslabs = -(-meta.shape[0] // slab_size)
            for slab in _progress(slabs, nslabs, "slab", progress):
                submit(slab, None, cap=slab_size)
            if flush is not None:
                flush()
        except BaseException:
            # release the output file; its "volume incomplete" refusal
            # would hide the error that stopped the stream
            with contextlib.suppress(ValueError):
                writer.close()
            raise
        finally:
            slabs.close()  # stops the reader before its file closes
    writer.close()
    return meta


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


# ---------------------------------------------------------------------------
# Device-resident timers: the chain ``inner`` times in one CUDA graph
# ---------------------------------------------------------------------------


def requantize_hu(y: torch.Tensor) -> torch.Tensor:
    """The int16 loop's carry: a float [0, 1] batch back to full-range
    Hounsfield units, ``round(y * 3000 - 1000)`` half to even (as
    ``jnp.round``)."""
    return torch.round(y * 3000.0 - 1000.0).to(torch.int16)


def _device_loop_body(cfg: PipelineConfig, dtype, dev) -> Callable:
    """One iteration of the device timers' loop on a float32 [B, H, W]
    carry: the batched chain, for int16 ingest run from ``requantize_hu``
    of the carry (so its ``window_hu`` ingest is timed too).

    The chain is ``build_batched_chain(cfg, quantize=False)``: the same
    float values as the reference's ``quantize=None`` loop (K4's float
    epilogue is bit-equal to the plain unsharp_mask), with a trailing
    unsharp_mask on K4 as in the chain that ``compile_pipeline`` serves.
    """
    np_dtype = np.dtype(dtype)
    if np_dtype not in (np.dtype(np.float32), np.dtype(np.int16)):
        raise ValueError(
            f"the device timers support float32 and int16 ingest, got "
            f"{np_dtype}")
    chain = build_batched_chain(cfg, quantize=False, device=dev)
    if np_dtype == np.int16:
        return lambda y: chain(requantize_hu(y))
    return chain


def _check_carry(cfg: PipelineConfig, dtype, shape, timer: str) -> None:
    """Refuse a chain whose output cannot be the next iteration's input
    (float32 of the input's [H, W]), with the config named. Probed on one
    CPU slice of the real extent (the plain chain), before any device
    work: a chain that resizes to that very extent passes, as under the
    reference's ``jax.eval_shape``."""
    probe = torch.zeros((1, *shape[-2:]), dtype=torch.float32)
    with torch.no_grad():
        out = _device_loop_body(cfg, dtype, torch.device("cpu"))(probe)
    if tuple(out.shape) != tuple(probe.shape) or out.dtype != torch.float32:
        raise ValueError(
            f"{timer} needs a chain whose float32 output keeps the input's "
            f"extent (the graph's carry): {cfg.name!r} maps "
            f"{list(probe.shape)}/float32 -> {list(out.shape)}/{out.dtype}")


def _stage_at_fault(exc: BaseException) -> str | None:
    """The stage a chain was running when ``exc`` was raised: the
    ``stage`` local of the chain's frame in its traceback, or in the
    traceback of the exception it was raised while handling."""
    while exc is not None:
        stage = None
        for frame, _ in traceback.walk_tb(exc.__traceback__):
            if frame.f_code.co_qualname == "build_batched_chain.<locals>.chain":
                stage = frame.f_locals.get("stage", stage)
        if stage is not None:
            return stage
        exc = exc.__cause__ or exc.__context__
    return None


@dataclasses.dataclass
class _DeviceLoop:
    """``inner`` chained iterations of ``body`` from the static input
    ``x`` captured as one CUDA graph, whose replay writes ``y``.
    ``launches`` counts the hand kernels recorded by the capture (all
    ``inner`` iterations; a replay counts nothing) and ``peak_bytes`` the
    device memory the capture allocated at its peak (the graph's pool)."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    y: torch.Tensor
    body: Callable
    inner: int
    launches: dict
    peak_bytes: int
    device_name: str

    def eager(self) -> torch.Tensor:
        """The same ``inner`` iterations run eagerly from ``x``."""
        y = self.x
        for _ in range(self.inner):
            y = self.body(y)
        return y

    def replay_ms(self, repeats: int) -> list[float]:
        """Device ms per iteration of ``repeats`` replays, each between
        two CUDA events (after one replay not timed)."""
        samples = []
        with torch.cuda.device(self.x.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.graph.replay()
            for _ in range(repeats):
                start.record()
                self.graph.replay()
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / self.inner)
        return samples


def _capture_device_loop(cfg: PipelineConfig, shape: tuple, inner: int,
                         dtype, device, timer: str) -> _DeviceLoop:
    """The device timers' program: the loop body on ``shape`` ([B, H, W],
    or [H, W] for the single-slice chain) warmed up 3 times eagerly on a
    side stream (every cached pad, table and kernel handle is then built:
    a cache miss under capture would copy from pageable host memory, which
    capture refuses), then ``inner`` chained iterations captured as one
    CUDA graph. The input is the reference's ``default_rng(0)`` draw."""
    dev = _cuda_device(device)
    _check_carry(cfg, dtype, shape, timer)
    bbody = _device_loop_body(cfg, dtype, dev)
    body = bbody if len(shape) == 3 else (lambda img: bbody(img[None])[0])
    x = torch.from_numpy(np.random.default_rng(0).random(
        shape, dtype=np.float32)).to(dev)
    with torch.cuda.device(dev), torch.no_grad():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            y = x
            for _ in range(3):
                y = body(y)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del y
        graph = torch.cuda.CUDAGraph()
        before = dict(_build.LAUNCHES)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        try:
            with torch.cuda.graph(graph):
                y = x
                for _ in range(inner):
                    y = body(y)
        except Exception as e:  # noqa: BLE001 - re-raised with its stage
            stage = _stage_at_fault(e)
            where = f"stage {stage!r}" if stage else "the chain"
            raise RuntimeError(
                f"{timer}: {where} of {cfg.name!r} cannot be captured in a "
                f"CUDA graph ({type(e).__name__}: "
                f"{str(e).splitlines()[0] if str(e) else ''})") from e
        peak = torch.cuda.max_memory_allocated(dev) - base
    launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                if n > before[k]}
    return _DeviceLoop(graph, x, y, body, inner, launches, peak,
                       torch.cuda.get_device_name(dev))


def time_pipeline_device(
    cfg: PipelineConfig,
    shape: tuple[int, int] = (512, 512),
    batch_size: int = 32,
    inner: int = 16,
    repeats: int = 16,
    dtype=np.float32,
    device="cuda",
) -> dict:
    """Device batched throughput: ``inner`` chained iterations of the
    batched chain (each feeding the next) captured as ONE CUDA graph,
    timed over ``repeats`` replays between CUDA events, per iteration;
    the median. A replay is one launch, so the host's per-call dispatch,
    which the event-timed ``time_pipeline`` counts whenever the host
    leaves the card waiting, is not in this figure.

    The carry is the chain's float [0, 1] output; with
    ``dtype=np.int16`` each iteration first re-quantizes it to int16 HU
    (``requantize_hu``) and runs the whole chain from its ``window_hu``.
    Raises RuntimeError on any device but a CUDA one, ValueError (naming
    the config) for a chain whose output is not float32 of the input's
    extent, checked before any device work, and RuntimeError naming the
    stage for a chain that cannot be captured (a host read inside a
    stage, such as Canny's or TV 3-D's ``.item()``): it never times the
    eager loop instead. ``captured_launches`` counts the hand kernels at
    capture, for all ``inner`` iterations; ``graph_peak_bytes`` is the
    device memory the capture held at its peak."""
    loop = _capture_device_loop(cfg, (batch_size, *shape), inner, dtype,
                                device, "time_pipeline_device")
    samples = sorted(loop.replay_ms(repeats))
    per_batch = samples[len(samples) // 2]
    return {
        "slices_per_sec": batch_size / (per_batch / 1000.0),
        "p50_ms_per_slice": per_batch / batch_size,
        "ms_per_batch": per_batch,
        "batch_size": batch_size,
        "shape": list(shape),
        "inner": inner,
        "program": f"cuda graph x{inner} (no per-call dispatch)",
        "captured_launches": loop.launches,
        "graph_peak_bytes": loop.peak_bytes,
        "device": loop.device_name,
    }


def time_latency_device(
    cfg: PipelineConfig,
    shape: tuple[int, int] = (512, 512),
    inner: int = 64,
    repeats: int = 32,
    device="cuda",
) -> dict:
    """Device single-slice latency: ``inner`` chained iterations of the
    one-slice chain (``build_chain``'s [H, W] -> [H, W], float32 ingest)
    in ONE CUDA graph, ``repeats`` replays between CUDA events; p50/p95
    of the per-iteration ms. Against ``time_latency``'s p95 it tells the
    card's jitter from the host's. Refuses what ``time_pipeline_device``
    refuses, and counts the same way."""
    loop = _capture_device_loop(cfg, tuple(shape), inner, np.float32,
                                device, "time_latency_device")
    samples = loop.replay_ms(repeats)
    return {
        **_percentiles_ms(samples),
        "inner": inner,
        "shape": list(shape),
        "program": f"cuda graph x{inner} (no per-call dispatch)",
        "captured_launches": loop.launches,
        "graph_peak_bytes": loop.peak_bytes,
        "device": loop.device_name,
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
