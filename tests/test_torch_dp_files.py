"""The data-parallel file drivers and the sharpness row bands on the CPU.

``runner.enhance_batch(mesh=)`` and ``runner.enhance_volume_stream(mesh=)``
in gloo worlds of 2 and 4 (one spawn each): the outputs and the manifests
bit-equal to the world of one (run in this process) and to the run without
a mesh; the reference's refusals on every rank. ``sharpness`` in row
bands at [2, 64, 96] and [2, 67, 93] (uneven bands) in the same worlds,
bit-equal to ``compile_pipeline``.
"""

from __future__ import annotations

import json
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mies_tpu_torch.io.image import load_image, save_image
from mies_tpu_torch.io.volume import load_volume, save_volume
from mies_tpu_torch.parallel import (
    batch_spatial_shard_apply,
    init_distributed,
    make_mesh,
)
from mies_tpu_torch.pipeline import runner
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
from mies_tpu_torch.pipeline.presets import flagship_config

REPO = Path(__file__).resolve().parent.parent
CT = REPO / "configs" / "ct_soft_tissue.yaml"
SPAWN_TIMEOUT_S = 240
BATCH = 4
SLAB = 4
SHARP = {
    "sharpness": [("sharpness", {"factor": 2.0})],
    "sharpness_chain": [("gaussian_blur", {"sigma": 0.8}),
                        ("sharpness", {"factor": 1.7}),
                        ("unsharp_mask", {"radius": 1.0})],
}
SHAPES = [(2, 64, 96), (2, 67, 93)]


def _files(root: Path) -> list[Path]:
    """Nine uint8 PNGs of 24 x 32, four 16-bit PNGs of 20 x 28 and one
    corrupt file, interleaved."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(13):
        p = root / f"f{i:02d}.png"
        if i % 3 == 1 and i < 12:
            save_image(p, rng.integers(0, 65536, (20, 28), dtype=np.uint16))
        else:
            save_image(p, rng.integers(0, 256, (24, 32), dtype=np.uint8))
        paths.append(p)
    bad = root / "bad.png"
    bad.write_bytes(b"not a png")
    return paths[:6] + [bad] + paths[6:]


def _volume(path: Path) -> Path:
    vol = np.random.default_rng(1).integers(-500, 1500, (11, 24, 16),
                                            dtype=np.int16)
    save_volume(path, vol)
    return path


def _sharp_input(shape) -> np.ndarray:
    return np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)


def _bands(h: int, n: int) -> list[tuple[int, int]]:
    edges = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(h), n)])
    return list(zip(edges[:-1], edges[1:]))


def _error_of(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _run_files(out: Path, inputs: Path, rank: int) -> None:
    """The two drivers with a mesh over the whole world (every rank)."""
    mesh = make_mesh()
    if rank == 0:
        _files(inputs)
    dist.barrier()
    paths = sorted(inputs.glob("f*.png"))
    paths = paths[:6] + [inputs / "bad.png"] + paths[6:]
    man = runner.enhance_batch(paths, flagship_config(), out / "batch",
                               batch_size=BATCH, progress=False, mesh=mesh)
    assert (man is None) == (rank != 0)
    if rank == 0:
        _volume(inputs / "ct.nc")
    dist.barrier()
    meta = runner.enhance_volume_stream(inputs / "ct.nc", load_config(CT),
                                        out / "stream.nc", slab_size=SLAB,
                                        mesh=mesh)
    assert (meta is None) == (rank != 0)


def _worker(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        init_distributed(f"file://{store}", world, rank, device="cpu")
        _run_files(out_dir, out_dir / "in", rank)
        line = make_mesh(data=1, space=world)
        i = line.get_local_rank("space")
        for name, stages in SHARP.items():
            fn = batch_spatial_shard_apply(PipelineConfig.make(stages), line)
            for shape in SHAPES:
                a, b = _bands(shape[1], world)[i]
                band = np.ascontiguousarray(_sharp_input(shape)[:, a:b])
                np.save(out_dir / f"{name}_{shape[1]}_{rank}.npy",
                        fn(band).numpy())
        per_channel = PipelineConfig.make(
            [("adjust_gamma", {"gamma": 0.9})], io={"channels": "per-channel"})
        rejections = {
            "batch_size": _error_of(lambda: runner.enhance_batch(
                [], flagship_config(), out_dir / "x", batch_size=2 * world + 1,
                mesh=make_mesh())),
            "per_channel": _error_of(lambda: runner.enhance_batch(
                [], per_channel, out_dir / "x", mesh=make_mesh())),
            "slab_size": _error_of(lambda: runner.enhance_volume_stream(
                out_dir / "none.nc", flagship_config(), out_dir / "y.nc",
                slab_size=2 * world + 1, mesh=make_mesh())),
        }
        (out_dir / f"rejections_{rank}.json").write_text(json.dumps(rejections))
        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _spawn(world: int, out: Path) -> Path:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(out / "store"), str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f.read_text() for f in sorted(out.glob("error_*.txt"))]
    assert not hung, f"ranks still running after {SPAWN_TIMEOUT_S} s: {hung}"
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return out


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    out = tmp_path_factory.mktemp("world1")
    init_distributed(f"file://{out}/store", 1, 0, device="cpu")
    try:
        _run_files(out, out / "in", 0)
    finally:
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(params=[2, 4])
def world(request, world2, world4):
    return request.param, {2: world2, 4: world4}[request.param]


def _records(out: Path) -> set:
    """The batch manifest's records, paths relative to the run's own
    input and output directories."""
    recs = set()
    for line in (out / "batch" / "manifest.jsonl").read_text().splitlines():
        rec = json.loads(line)
        rec["item"] = Path(rec["item"]).name
        if "output" in rec:
            rec["output"] = Path(rec["output"]).relative_to(out).as_posix()
        if "error" in rec:
            rec["error"] = rec["error"].replace(str(out), "<run>")
        recs.add(json.dumps(rec, sort_keys=True))
    return recs


def test_world_of_one_equals_the_run_without_a_mesh(world1, tmp_path):
    paths = _files(tmp_path / "in")
    man = runner.enhance_batch(paths, flagship_config(), tmp_path / "batch",
                               batch_size=BATCH, progress=False, device="cpu")
    assert man.done_count == 13 and list(man.failures) == [
        str(tmp_path / "in" / "bad.png")]
    for p in paths:
        if p.name != "bad.png":
            np.testing.assert_array_equal(
                load_image(world1 / "batch" / p.name, dtype="raw"),
                load_image(tmp_path / "batch" / p.name, dtype="raw"))
    assert _records(world1) == _records(tmp_path)
    runner.enhance_volume_stream(_volume(tmp_path / "ct.nc"), load_config(CT),
                                 tmp_path / "stream.nc", slab_size=SLAB,
                                 device="cpu")
    np.testing.assert_array_equal(load_volume(world1 / "stream.nc")[0],
                                  load_volume(tmp_path / "stream.nc")[0])


def test_enhance_batch_outputs_and_manifest_equal_the_world_of_one(world,
                                                                   world1):
    n, out = world
    names = sorted(p.name for p in (world1 / "batch").glob("*.png"))
    assert len(names) == 13
    assert sorted(p.name for p in (out / "batch").glob("*.png")) == names
    for name in names:
        np.testing.assert_array_equal(
            load_image(out / "batch" / name, dtype="raw"),
            load_image(world1 / "batch" / name, dtype="raw"))
    assert _records(out) == _records(world1)


def test_enhance_volume_stream_equals_the_world_of_one(world, world1):
    n, out = world
    got, _ = load_volume(out / "stream.nc")
    want, _ = load_volume(world1 / "stream.nc")
    assert got.shape == (11, 24, 16)
    np.testing.assert_array_equal(got, want)


def test_resume_skips_the_done_items(world1, tmp_path):
    """A re-run with the mesh of one resumes the manifest: nothing redone."""
    import shutil

    shutil.copytree(world1 / "batch", tmp_path / "batch")
    before = (tmp_path / "batch" / "manifest.jsonl").read_text()
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        paths = sorted((world1 / "in").glob("f*.png"))
        man = runner.enhance_batch(paths, flagship_config(),
                                   tmp_path / "batch", batch_size=BATCH,
                                   progress=False, mesh=make_mesh())
    finally:
        dist.destroy_process_group()
    assert man.done_count == 13
    assert (tmp_path / "batch" / "manifest.jsonl").read_text() == before


@pytest.mark.parametrize("case,match", [
    ("batch_size", "must divide by the mesh's"),
    ("per_channel", "io.channels='per-channel' with a device mesh"),
    ("slab_size", "slab_size"),
])
def test_data_parallel_refusals_on_every_rank(world, case, match):
    n, out = world
    for r in range(n):
        msg = json.loads((out / f"rejections_{r}.json").read_text())[case]
        assert match in msg, msg


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(SHARP))
def test_sharpness_bands_equal_compile_pipeline(world, name, shape):
    n, out = world
    got = np.concatenate([np.load(out / f"{name}_{shape[1]}_{r}.npy")
                          for r in range(n)], axis=1)
    want = compile_pipeline(PipelineConfig.make(SHARP[name]), batched=True,
                            device="cpu")(_sharp_input(shape)).numpy()
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, want)
