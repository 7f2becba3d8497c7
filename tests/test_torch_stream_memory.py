"""The streamed volume's host memory (``runner.enhance_volume_stream``) is a
count fixed before the first read, whatever the threads' timing.

A [64, 128, 128] int16 volume (262,144 B a slab of 8) streams at slab 8 on
the CPU from a classic .nc, a .npy and an HDF5 .nc written by h5py, each
under four timings forced by sleeps: none, a slow reader (in the slab
read), a slow consumer (before ``_DevicePipe.submit``) and a slow writer
(in ``append``). tracemalloc's peak stays within the two read buffers
plus 64 KiB, the four timings of one input form within 64 KiB of each
other, and every output equals the chain on the whole volume.
"""

from __future__ import annotations

import time
import tracemalloc

import h5py
import numpy as np
import pytest

from mies_tpu_torch.io import netcdf3, volume
from mies_tpu_torch.io.volume import load_volume, save_volume
from mies_tpu_torch.pipeline import runner
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.presets import flagship_volume_config

SLAB = 8
SHAPE = (64, 128, 128)
SLAB_BYTES = SLAB * SHAPE[1] * SHAPE[2] * 2  # 262,144
SLACK = 65_536
PEAK_LIMIT = runner.READ_BUFFERS * SLAB_BYTES + SLACK  # 589,824
FORMS = ["classic.nc", "npy", "hdf5.nc"]
TIMINGS = ["none", "slow reader", "slow consumer", "slow writer"]
DELAY = 0.02


def _volume() -> np.ndarray:
    return np.random.default_rng(21).integers(-1000, 2000, SHAPE,
                                              dtype=np.int16)


def _write_input(path, form: str, vol: np.ndarray) -> None:
    if form == "hdf5.nc":
        with h5py.File(path, "w") as f:
            f.create_dataset("ct", data=vol)
    else:
        save_volume(path, vol)


def _slowed(monkeypatch, timing: str) -> None:
    """Force ``timing`` by a sleep in the slab read, before the staging
    copy or in the output's append."""
    target = {"slow reader": (volume.SlabReader, "read_into"),
              "slow consumer": (runner._DevicePipe, "submit"),
              "slow writer": (netcdf3.NetCDF3VolumeWriter, "append")}
    if timing == "none":
        return
    cls, name = target[timing]
    real = getattr(cls, name)

    def slow(self, *args, **kwargs):
        time.sleep(DELAY)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(cls, name, slow)


_RUNS: dict[tuple[str, str], tuple[int, np.ndarray]] = {}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_memory")
    vol = _volume()
    for form in FORMS:
        _write_input(d / f"in.{form}", form, vol)
    # one stream of each form first: the imports and the chain's caches
    # are filled outside the traces
    for form in FORMS:
        runner.enhance_volume_stream(d / f"in.{form}", flagship_volume_config(),
                                     d / "warm.nc", slab_size=SLAB,
                                     device="cpu")
    return d


def _run(workdir, form: str, timing: str) -> tuple[int, np.ndarray]:
    """tracemalloc's peak of one stream of ``form`` under ``timing``, and
    its output (each pair measured once per process)."""
    if (form, timing) not in _RUNS:
        out = workdir / f"out.{form}.{timing.replace(' ', '_')}.nc"
        with pytest.MonkeyPatch.context() as mp:
            _slowed(mp, timing)
            tracemalloc.start()
            try:
                runner.enhance_volume_stream(
                    workdir / f"in.{form}", flagship_volume_config(), out,
                    slab_size=SLAB, device="cpu")
                _, peak = tracemalloc.get_traced_memory()
            finally:
                tracemalloc.stop()
        _RUNS[form, timing] = (peak, load_volume(out)[0])
    return _RUNS[form, timing]


@pytest.fixture(scope="module")
def whole_chain() -> np.ndarray:
    return compile_pipeline(flagship_volume_config(), batched=True,
                            device="cpu")(_volume()).numpy()


@pytest.mark.parametrize("timing", TIMINGS)
@pytest.mark.parametrize("form", FORMS)
def test_stream_peak_is_the_read_buffers_whatever_the_timing(
        workdir, whole_chain, form, timing):
    peak, out = _run(workdir, form, timing)
    assert peak <= PEAK_LIMIT, (form, timing, peak)
    peaks = {t: _run(workdir, form, t)[0] for t in TIMINGS}
    assert max(peaks.values()) - min(peaks.values()) <= SLACK, (form, peaks)
    assert out.dtype == np.uint8 and out.shape == SHAPE
    np.testing.assert_array_equal(out, whole_chain)
