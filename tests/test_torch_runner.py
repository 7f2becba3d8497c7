"""The port's file entry points (``mies_tpu_torch.pipeline.runner``:
enhance_image, enhance_batch, enhance_volume, enhance_volume_stream) on
the CPU: each gives exactly the uint8 of ``compile_pipeline(cfg,
batched=True, device="cpu")`` on the decoded arrays; resume (also from a
manifest the JAX package's enhance_batch wrote), per-item fault
isolation, mixed sizes, per-channel inputs, the streamed outputs, a
short last slab, O(slab) host memory, and the refusals. The tests marked
``cuda`` run them on the card (the ``cuda_device`` fixture skips
them without one); this file imports jax and Pillow only inside the tests
that need them, so on a card without either they run as
``python -m pytest tests/test_torch_runner.py --noconftest -m cuda``.
"""

from __future__ import annotations

import builtins
import sys
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from pytest import skip

from mies_tpu_torch.io.dicom import write_dicom
from mies_tpu_torch.io.image import load_image, save_image
from mies_tpu_torch.io.volume import load_volume, save_volume
from mies_tpu_torch.pipeline import runner
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
from mies_tpu_torch.pipeline.manifest import RunManifest
from mies_tpu_torch.pipeline.presets import flagship_config, flagship_volume_config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
CT = REPO / "configs" / "ct_soft_tissue.yaml"
SHARPEN = """name: gauss-sharpen
pipeline:
  - {op: gaussian_blur, sigma: 1.0}
  - {op: unsharp_mask, radius: 1.5, amount: 1.0}
"""


def _chain(cfg, x: np.ndarray) -> np.ndarray:
    return compile_pipeline(cfg, batched=True, device="cpu")(
        np.array(x)).numpy()


def _ct_volume(z=20, h=40, w=56, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(-1000, 2000, (z, h, w),
                                                dtype=np.int16)


def _save_png(path: Path, a: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(a).save(path)


def _read_png(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def _pngs(d: Path, n: int, shape=(40, 56), seed=1, rgb=False,
          prefix="img") -> list[Path]:
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        a = rng.integers(0, 256, (*shape, 3) if rgb else shape, dtype=np.uint8)
        p = d / f"{prefix}{i:02d}.png"
        _save_png(p, a)
        paths.append(p)
    return paths


def _sharpen_cfg(tmp_path) -> PipelineConfig:
    p = tmp_path / "sharpen.yaml"
    p.write_text(SHARPEN)
    return load_config(p)


# ---------------------------------------------------------------------------
# enhance_image
# ---------------------------------------------------------------------------

def test_enhance_image_png_equals_chain(tmp_path):
    cfg = _sharpen_cfg(tmp_path)
    (src,) = _pngs(tmp_path / "in", 1)
    out = runner.enhance_image(src, cfg, tmp_path / "out.png", device="cpu")
    ref = _chain(cfg, load_image(src, dtype="raw")[None])[0]
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(_read_png(tmp_path / "out.png"), ref)


def test_enhance_image_dicom_equals_chain(tmp_path):
    cfg = load_config(CT)
    px = _ct_volume(1)[0]
    write_dicom(tmp_path / "ct.dcm", px, rescale_intercept=0.0)
    out = runner.enhance_image(tmp_path / "ct.dcm", cfg, tmp_path / "o.dcm",
                               device="cpu")
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, _chain(cfg, px[None])[0])
    np.testing.assert_array_equal(load_image(tmp_path / "o.dcm", dtype="raw"), out)


def test_enhance_image_per_channel(tmp_path):
    cfg = PipelineConfig.make([("gaussian_blur", {"sigma": 1.0})],
                              io={"channels": "per-channel"})
    (src,) = _pngs(tmp_path / "in", 1, rgb=True)
    out = runner.enhance_image(src, cfg, device="cpu")
    chw = load_image(src, dtype="raw", channels="per-channel")
    assert out.shape == chw.shape
    np.testing.assert_array_equal(out, _chain(cfg, chw[None])[0])


# ---------------------------------------------------------------------------
# enhance_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_enhance_batch_equals_chain_and_resumes(tmp_path, batch_size):
    cfg = _sharpen_cfg(tmp_path)
    paths = _pngs(tmp_path / "in", 7)
    out_dir = tmp_path / "out"
    m = runner.enhance_batch(paths, cfg, out_dir, batch_size=batch_size,
                             progress=False, device="cpu")
    assert m.done_count == 7 and not m.failures
    ref = _chain(cfg, np.stack([load_image(p, dtype="raw") for p in paths]))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(_read_png(out_dir / p.name),
                                      ref[i])
    lines = (out_dir / "manifest.jsonl").read_text().splitlines()
    assert len(lines) == 7
    again = runner.enhance_batch(paths, cfg, out_dir, batch_size=batch_size,
                                 progress=False, device="cpu")
    assert again.done_count == 7
    assert (out_dir / "manifest.jsonl").read_text().splitlines() == lines


def test_enhance_batch_isolates_a_corrupt_input(tmp_path):
    cfg = _sharpen_cfg(tmp_path)
    paths = _pngs(tmp_path / "in", 4)
    bad = tmp_path / "in" / "broken.png"
    bad.write_bytes(b"\x89PNG garbage")
    m = runner.enhance_batch([paths[0], bad, *paths[1:]], cfg, tmp_path / "out",
                             batch_size=2, progress=False, device="cpu")
    assert m.done_count == 4
    assert list(m.failures) == [str(bad)]
    assert m.failures[str(bad)].startswith("load:")
    # a re-run retries only the failure
    bad.unlink()
    _save_png(bad, np.zeros((40, 56), np.uint8))
    m2 = runner.enhance_batch([paths[0], bad, *paths[1:]], cfg, tmp_path / "out",
                              batch_size=2, progress=False, device="cpu")
    assert m2.done_count == 5 and not m2.failures


def test_enhance_batch_mixed_sizes_and_dtypes(tmp_path):
    cfg = _sharpen_cfg(tmp_path)
    small = _pngs(tmp_path / "a", 3, shape=(24, 40), seed=2, prefix="small")
    large = _pngs(tmp_path / "b", 2, shape=(40, 56), seed=3, prefix="large")
    p16 = tmp_path / "c" / "deep.png"
    p16.parent.mkdir()
    _save_png(p16, np.random.default_rng(4).integers(
        0, 65536, (24, 40), dtype=np.uint16))
    paths = [small[0], large[0], p16, small[1], large[1], small[2]]
    out = tmp_path / "out"
    m = runner.enhance_batch(paths, cfg, out, batch_size=4, progress=False,
                             device="cpu")
    assert m.done_count == 6 and not m.failures
    for p in paths:
        ref = _chain(cfg, load_image(p, dtype="raw")[None])[0]
        np.testing.assert_array_equal(_read_png(out / p.name), ref)


def test_enhance_batch_per_channel(tmp_path):
    cfg = PipelineConfig.make([("gaussian_blur", {"sigma": 1.0})],
                              io={"channels": "per-channel"})
    paths = _pngs(tmp_path / "in", 3, rgb=True)
    out = tmp_path / "out"
    runner.enhance_batch(paths, cfg, out, batch_size=2, progress=False,
                         device="cpu")
    for p in paths:
        chw = load_image(p, dtype="raw", channels="per-channel")
        ref = _chain(cfg, chw[None])[0].transpose(1, 2, 0)
        np.testing.assert_array_equal(_read_png(out / p.name), ref)


def test_enhance_batch_dicom_ct(tmp_path):
    cfg = load_config(CT)
    vol = _ct_volume(5)
    d = tmp_path / "in"
    d.mkdir()
    paths = []
    for i, sl in enumerate(vol):
        paths.append(d / f"s{i}.dcm")
        write_dicom(paths[-1], sl, rescale_slope=1.0, rescale_intercept=-1024.0)
    m = runner.enhance_batch(paths, cfg, tmp_path / "out", batch_size=2,
                             progress=False, device="cpu")
    assert m.done_count == 5
    decoded = np.stack([load_image(p, dtype="raw") for p in paths])
    ref = _chain(cfg, decoded)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(
            load_image(tmp_path / "out" / p.name, dtype="raw"), ref[i])


def test_cache_keys_equal_the_reference_on_every_shipped_config():
    import mies_tpu

    assert len(CONFIGS) == 14
    for path in CONFIGS:
        assert (load_config(path).cache_key()
                == mies_tpu.load_config(path).cache_key()), path.name


def test_enhance_batch_resumes_a_manifest_the_jax_package_wrote(tmp_path):
    import mies_tpu
    import mies_tpu.pipeline.runner as jrunner

    cfg_path = tmp_path / "sharpen.yaml"
    cfg_path.write_text(SHARPEN)
    paths = _pngs(tmp_path / "in", 5)
    out = tmp_path / "out"
    jm = jrunner.enhance_batch(paths[:3], mies_tpu.load_config(cfg_path), out,
                               batch_size=4, progress=False)
    assert jm.done_count == 3
    lines = (out / "manifest.jsonl").read_text().splitlines()
    jax_outputs = {p.name: (out / p.name).read_bytes() for p in paths[:3]}
    m = runner.enhance_batch(paths, load_config(cfg_path), out, batch_size=4,
                             progress=False, device="cpu")
    assert m.done_count == 5 and not m.failures
    new = (out / "manifest.jsonl").read_text().splitlines()
    assert new[:3] == lines and len(new) == 5  # only the two new files ran
    assert {p.name: (out / p.name).read_bytes() for p in paths[:3]} == jax_outputs
    assert RunManifest(out / "manifest.jsonl",
                       load_config(cfg_path).cache_key()).done_count == 5


# ---------------------------------------------------------------------------
# enhance_volume and enhance_volume_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slab", [1, 7, 8, 32])
def test_enhance_volume_equals_chain(slab):
    cfg = flagship_volume_config()
    vol = _ct_volume()
    out = runner.enhance_volume(vol, cfg, slab_size=slab, device="cpu")
    np.testing.assert_array_equal(out, _chain(cfg, vol))


def test_enhance_volume_takes_a_big_endian_volume():
    cfg = flagship_volume_config()
    vol = _ct_volume(z=9)
    out = runner.enhance_volume(vol.astype(">i2"), cfg, slab_size=4, device="cpu")
    np.testing.assert_array_equal(out, _chain(cfg, vol))


@pytest.mark.parametrize("out_suffix", [".nc", ".npy", ""])
@pytest.mark.parametrize("in_suffix", [".nc", ".npy", "dicom-dir", ".h5nc"])
def test_enhance_volume_stream_equals_chain(tmp_path, in_suffix, out_suffix):
    import h5py

    cfg = flagship_volume_config()
    vol = _ct_volume()
    if in_suffix == "dicom-dir":
        src = tmp_path / "series"
        src.mkdir()
        for i, sl in enumerate(vol):  # file names against slice order
            write_dicom(src / f"x{19 - i:02d}.dcm", sl, slice_location=float(i),
                        rescale_intercept=0.0)
    elif in_suffix == ".h5nc":
        src = tmp_path / "in.nc"
        with h5py.File(src, "w") as f:
            f.create_dataset("ct", data=vol, chunks=(3, 20, 28),
                             compression="gzip")
    else:
        src = tmp_path / f"in{in_suffix}"
        save_volume(src, vol)
    dst = tmp_path / f"out{out_suffix}"
    meta = runner.enhance_volume_stream(src, cfg, dst, slab_size=8, device="cpu")
    assert tuple(meta.shape) == vol.shape
    got, _ = load_volume(dst)
    # a DICOM series reads back as int16 (the series reader's contract)
    assert got.dtype == (np.int16 if out_suffix == "" else np.uint8)
    assert got.shape == vol.shape
    np.testing.assert_array_equal(got, _chain(cfg, vol))


def test_short_last_slab_equals_the_padded_slab(tmp_path):
    """No padding: a short last slab gives the slices that the same slab
    padded to the slab size (the reference's single-program form) gives."""
    cfg = flagship_volume_config()
    vol = _ct_volume(z=20)
    save_volume(tmp_path / "in.nc", vol)
    runner.enhance_volume_stream(tmp_path / "in.nc", cfg, tmp_path / "o.nc",
                                 slab_size=8, device="cpu")
    got, _ = load_volume(tmp_path / "o.nc")
    last = vol[16:]
    padded = np.concatenate([last, np.repeat(last[-1:], 4, axis=0)])
    np.testing.assert_array_equal(got[16:], _chain(cfg, padded)[:4])
    np.testing.assert_array_equal(got[16:], _chain(cfg, last))


@pytest.mark.parametrize("op", ["resize", "center_crop", "rot90"])
def test_stream_refuses_shape_changers(tmp_path, op):
    cfg = PipelineConfig.make([("window_hu", {"center": 40.0, "width": 400.0}),
                               (op, {})])
    save_volume(tmp_path / "in.nc", _ct_volume(z=4))
    with pytest.raises(ValueError, match="shape-changing"):
        runner.enhance_volume_stream(tmp_path / "in.nc", cfg,
                                     tmp_path / "o.nc", device="cpu")
    assert not (tmp_path / "o.nc").exists()


def test_stream_host_memory_is_o_slab(tmp_path):
    """tracemalloc's peak while streaming a [64, 128, 128] int16 .nc at
    slab 8 stays under half the volume's bytes."""
    cfg = flagship_volume_config()
    vol = _ct_volume(z=64, h=128, w=128)
    save_volume(tmp_path / "in.nc", vol)
    runner.enhance_volume_stream(tmp_path / "in.nc", cfg, tmp_path / "warm.nc",
                                 slab_size=8, device="cpu")
    tracemalloc.start()
    try:
        runner.enhance_volume_stream(tmp_path / "in.nc", cfg, tmp_path / "o.nc",
                                     slab_size=8, device="cpu")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < vol.nbytes / 2, (peak, vol.nbytes)
    got, _ = load_volume(tmp_path / "o.nc")
    np.testing.assert_array_equal(got[:8], _chain(cfg, vol[:8]))


def test_progress_without_tqdm_prints_plain_lines(tmp_path, monkeypatch, capsys):
    real_import = builtins.__import__

    def no_tqdm(name, *args, **kwargs):
        if name == "tqdm":
            raise ImportError("no tqdm")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "tqdm", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    cfg = flagship_volume_config()
    vol = _ct_volume(z=10)
    save_volume(tmp_path / "in.nc", vol)
    runner.enhance_volume_stream(tmp_path / "in.nc", cfg, tmp_path / "o.nc",
                                 slab_size=4, progress=True, device="cpu")
    err = capsys.readouterr().err.splitlines()
    assert err == ["slab 1/3", "slab 2/3", "slab 3/3"]
    out = runner.enhance_volume(vol, cfg, slab_size=5, progress=True,
                                device="cpu")
    np.testing.assert_array_equal(out, _chain(cfg, vol))


# ---------------------------------------------------------------------------
# Refusals: no card, mesh=
# ---------------------------------------------------------------------------

def test_file_entry_points_without_a_card_raise(tmp_path):
    cfg = flagship_volume_config()
    vol = _ct_volume(z=4)
    save_volume(tmp_path / "in.nc", vol)
    write_dicom(tmp_path / "a.dcm", vol[0])
    calls = [
        lambda: runner.enhance_image(tmp_path / "a.dcm", cfg),
        lambda: runner.enhance_batch([tmp_path / "a.dcm"], cfg, tmp_path / "o",
                                     progress=False),
        lambda: runner.enhance_volume(vol, cfg),
        lambda: runner.enhance_volume_stream(tmp_path / "in.nc", cfg,
                                             tmp_path / "o.nc"),
    ]
    if not torch.cuda.is_available():  # on the card these would run
        for call in calls:
            with pytest.raises(RuntimeError, match="cuda"):
                call()


def test_mesh_is_refused_with_the_roadmap_item(tmp_path):
    """Refused until ported (ROADMAP.md queue 1 item 7): enhance_batch(mesh=)
    and enhance_volume_stream(mesh=) on a gloo world of one write what the
    runs without a mesh write (the worlds of 2 and 4:
    tests/test_torch_dp_files.py)."""
    from mies_tpu_torch.parallel import init_distributed, make_mesh

    cfg = flagship_config()
    srcs = []
    for i, shape in enumerate([(24, 32), (24, 32), (20, 16)]):
        srcs.append(tmp_path / "in" / f"x{i}.png")
        srcs[-1].parent.mkdir(exist_ok=True)
        save_image(srcs[-1], np.random.default_rng(i).integers(
            0, 256, shape, dtype=np.uint8))
    vol = np.random.default_rng(7).integers(-500, 1500, (7, 24, 16),
                                            dtype=np.int16)
    save_volume(tmp_path / "in.nc", vol)
    ct = load_config(CT)
    runner.enhance_batch(srcs, cfg, tmp_path / "one", batch_size=2,
                         progress=False, device="cpu")
    runner.enhance_volume_stream(tmp_path / "in.nc", ct, tmp_path / "one.nc",
                                 slab_size=2, device="cpu")
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        man = runner.enhance_batch(srcs, cfg, tmp_path / "dp", batch_size=2,
                                   progress=False, mesh=make_mesh())
        runner.enhance_volume_stream(tmp_path / "in.nc", ct,
                                     tmp_path / "dp.nc", slab_size=2,
                                     mesh=make_mesh())
    finally:
        torch.distributed.destroy_process_group()
    assert man.done_count == 3 and not man.failures
    for p in srcs:
        np.testing.assert_array_equal(
            load_image(tmp_path / "dp" / p.name, dtype="raw"),
            load_image(tmp_path / "one" / p.name, dtype="raw"))
    np.testing.assert_array_equal(load_volume(tmp_path / "dp.nc")[0],
                                  load_volume(tmp_path / "one.nc")[0])


def test_enhance_volume_with_a_mesh_of_one_equals_without(tmp_path):
    """enhance_volume(mesh=) on a gloo world of one (the worlds of 2 and 4:
    tests/test_torch_volume_shard.py): a big-endian .nc volume with a
    short last slab gives the unsharded output."""
    from mies_tpu_torch.parallel import init_distributed, make_mesh

    vol = np.random.default_rng(7).integers(-500, 1500, (11, 24, 16),
                                            dtype=np.int16)
    save_volume(tmp_path / "in.nc", vol)
    big_endian, _ = load_volume(tmp_path / "in.nc")
    cfg = load_config(CT)
    want = runner.enhance_volume(vol, cfg, slab_size=4, device="cpu")
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        got = runner.enhance_volume(big_endian, cfg, slab_size=4,
                                    mesh=make_mesh())
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# On the card: the pinned ring, the streams and the events
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _on_card(cfg, x: np.ndarray, dev) -> np.ndarray:
    return compile_pipeline(cfg, batched=True, device=dev)(
        torch.from_numpy(np.array(x)).to(dev)).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_on_card_equals_compile_pipeline(tmp_path, cuda_device, depth):
    """Every slab equal to compile_pipeline on the card, whatever the ring
    depth (1: each slab drained before the next is staged); K1 to the
    LUTs, K2, K3, K4 once per slab, no other kernel; the short last slab
    included."""
    from mies_tpu_torch.kernels import _build

    cfg = flagship_volume_config()
    vol = _ct_volume(z=44, h=128, w=96)
    save_volume(tmp_path / "in.nc", vol)
    _build.reset_launches()
    runner.enhance_volume_stream(tmp_path / "in.nc", cfg, tmp_path / "o.nc",
                                 slab_size=8, max_in_flight=depth,
                                 device=cuda_device)
    torch.cuda.synchronize()
    want = {"tile_luts", "clahe_apply_lut", "bilateral", "unsharp_quant"}
    assert _build.LAUNCHES == {k: 6 if k in want else 0 for k in _build.LAUNCHES}
    got, _ = load_volume(tmp_path / "o.nc")
    for k in range(0, 44, 8):
        np.testing.assert_array_equal(got[k:k + 8],
                                      _on_card(cfg, vol[k:k + 8], cuda_device))
    np.testing.assert_array_equal(
        runner.enhance_volume(vol, cfg, slab_size=8, max_in_flight=depth,
                              device=cuda_device), got)


@pytest.mark.cuda
def test_batch_on_card_mixed_shapes_equals_compile_pipeline(tmp_path, cuda_device):
    """DICOM files of two sizes interleaved, batch 3 (five groups through
    two rings): each output equal to compile_pipeline on its decoded
    slice."""
    cfg = load_config(CT)
    d = tmp_path / "in"
    d.mkdir()
    paths = []
    for i in range(7):
        shape = (40, 56) if i % 2 else (64, 48)
        px = _ct_volume(1, *shape, seed=i)[0]
        paths.append(d / f"s{i}.dcm")
        write_dicom(paths[-1], px)
    m = runner.enhance_batch(paths, cfg, tmp_path / "out", batch_size=3,
                             progress=False, device=cuda_device)
    assert m.done_count == 7 and not m.failures
    for p in paths:
        px = load_image(p, dtype="raw")
        np.testing.assert_array_equal(
            load_image(tmp_path / "out" / p.name, dtype="raw"),
            _on_card(cfg, px[None], cuda_device)[0])
    one = runner.enhance_image(paths[3], cfg, device=cuda_device)
    np.testing.assert_array_equal(
        one, _on_card(cfg, load_image(paths[3], dtype="raw")[None], cuda_device)[0])


@pytest.mark.cuda
def test_stream_on_card_within_bound_of_the_cpu_chain(tmp_path, cuda_device):
    """The card's stream within 1 level on < 1e-3 of pixels of the CPU
    plain chain (PERF.md section 2)."""
    cfg = flagship_volume_config()
    vol = _ct_volume(z=12, h=256, w=256)
    save_volume(tmp_path / "in.npy", vol)
    runner.enhance_volume_stream(tmp_path / "in.npy", cfg, tmp_path / "o.npy",
                                 slab_size=5, device=cuda_device)
    got = np.load(tmp_path / "o.npy")
    d = np.abs(got.astype(np.int16) - _chain(cfg, vol).astype(np.int16))
    assert d.max() <= 1 and np.count_nonzero(d) < 1e-3 * d.size
