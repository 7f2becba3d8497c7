"""The port's device-resident timers (``mies_tpu_torch.pipeline.runner``:
time_pipeline_device, time_latency_device), the counterparts of the
reference's ``lax.fori_loop`` timers: ``inner`` chained iterations of the
chain captured as one CUDA graph and timed by its replays.

On the CPU: the loop body iterated twice against the JAX package's
``build_batched_chain(cfg, quantize=None)`` iterated twice, for a float32
chain (adjust_gamma -> gaussian_blur) and BASELINE w4's int16 chain
(window_hu -> median -> bilateral, re-quantized each iteration), within
the ops' documented atol: 1e-6 for adjust_gamma and gaussian_blur (libm
and XLA's pow, tests/test_torch_intensity.py, test_torch_ops.py), 2e-6
for the bilateral (tests/test_torch_chains13.py; the median is
bit-equal); the int16 re-quantize bit-equal to ``jnp.round(...)
.astype(jnp.int16)`` on exact ties at .5; the carry check, the refusal of
the CPU, the stage named from a refused host read, and the returned keys
(the graph mocked). The tests marked ``cuda`` capture on the card (the
``cuda_device`` fixture skips them without one): one replay, and a second,
bit-equal to the eager loop on w5 and w8, the hand kernels recorded at
capture, and Canny refused with its stage named. This file imports jax
and mies_tpu only inside the tests that need them, so on the card they run
as ``python -m pytest tests/test_torch_device_timers.py --noconftest -m
cuda``.
"""

from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import pytest
import torch
from pytest import skip

from mies_tpu_torch.pipeline import runner as R
from mies_tpu_torch.pipeline.compiler import build_batched_chain
from mies_tpu_torch.ops import histogram as H
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
from mies_tpu_torch.pipeline.presets import flagship_config, latency_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
F32_CHAIN = [("adjust_gamma", {"gamma": 0.8}), ("gaussian_blur", {"sigma": 1.5})]
# BASELINE w4, w5 and w8 (benchmarks/workloads.py)
W4 = [("window_hu", {"center": 40.0, "width": 400.0}),
      ("median_blur", {"kernel_size": 3}),
      ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                          "sigma_space": 1.5})]
W8 = [("anisotropic_diffusion", {"niter": 6, "kappa": 0.05, "gamma": 0.2}),
      ("musica", {"levels": 5, "p": 0.6, "gain": 1.5})]
CANNY = [("gaussian_blur", {"sigma": 1.0}), ("canny", {"sigma": 1.0})]
CAPTURE_REFUSAL = "CUDA error: operation not permitted when stream is capturing"


def _reference_body(stages, dtype):
    """The reference's fori_loop body: its batched chain (quantize=None),
    for int16 ingest run from the re-quantized carry."""
    import jax.numpy as jnp

    import mies_tpu
    from mies_tpu.pipeline.compiler import build_batched_chain as jax_chain

    chain = jax_chain(mies_tpu.PipelineConfig.make(stages), quantize=None)
    if dtype == np.int16:
        return lambda y: chain(jnp.round(y * 3000.0 - 1000.0)
                               .astype(jnp.int16))
    return chain


@pytest.mark.parametrize("stages,dtype,atol", [
    (F32_CHAIN, np.float32, 1e-6),
    (W4, np.int16, 2e-6),
], ids=["float32", "w4-int16"])
def test_loop_body_twice_equals_the_reference_body_twice(stages, dtype, atol):
    import jax.numpy as jnp

    x = np.random.default_rng(0).random((2, 64, 96), dtype=np.float32)
    body = R._device_loop_body(PipelineConfig.make(stages), dtype, CPU)
    ref_body = _reference_body(stages, dtype)
    got, ref = torch.from_numpy(x), jnp.asarray(x)
    for _ in range(2):
        got, ref = body(got), ref_body(ref)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def test_loop_body_equals_the_unquantized_chain_bit_for_bit():
    """The body binds quantize=False (K4 in its float epilogue for the
    flagship's trailing unsharp_mask): the values of the quantize=None
    chain, bit for bit."""
    x = torch.from_numpy(
        np.random.default_rng(1).random((2, 64, 96), dtype=np.float32))
    cfg = flagship_config()
    body = R._device_loop_body(cfg, np.float32, CPU)
    plain = build_batched_chain(cfg, quantize=None, device=CPU)
    y, z = x, x
    for _ in range(2):
        y, z = body(y), plain(z)
    assert torch.equal(y, z)


def _exact_ties() -> np.ndarray:
    """float32 y in [0, 1] whose y * 3000 - 1000 is exactly k + 0.5 in
    float32 arithmetic, for even and odd k."""
    ys = []
    for k in range(-1000, 2000, 7):
        t = np.float32(k + 0.5)
        y0 = np.float32((k + 0.5 + 1000.0) / 3000.0)
        for step in range(-4, 5):
            y = np.float32(y0 + np.float32(step) * np.spacing(y0))
            if (np.float32(np.float32(y * np.float32(3000.0))
                           - np.float32(1000.0)) == t):
                ys.append(y)
                break
    return np.asarray(ys, np.float32)


def test_requantize_rounds_ties_half_to_even_as_jnp_round():
    import jax.numpy as jnp

    y = _exact_ties()
    t = y * np.float32(3000.0) - np.float32(1000.0)
    assert len(y) > 100 and (t % 1 == 0.5).all()
    floors = np.floor(t).astype(int)
    assert (floors % 2 == 0).any() and (floors % 2 == 1).any()
    got = R.requantize_hu(torch.from_numpy(y)).numpy()
    ref = np.asarray(jnp.round(jnp.asarray(y) * 3000.0 - 1000.0)
                     .astype(jnp.int16))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.rint(t).astype(np.int16))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_carry_check_names_a_shape_changing_config(dtype):
    """As the reference's test_time_pipeline_device_rejects_shape_changing
    _chain: refused with the config named, before any device work."""
    cfg = PipelineConfig.make([("resize", {"height": 32, "width": 32})],
                              name="rs-dev")
    with pytest.raises(ValueError, match="rs-dev"):
        R._check_carry(cfg, dtype, (2, 64, 64), "time_pipeline_device")
    # resized to its own extent, the carry keeps its shape
    R._check_carry(cfg, dtype, (2, 32, 32), "time_pipeline_device")


def test_carry_check_names_a_dtype_changing_config(monkeypatch):
    cfg = PipelineConfig.make([("canny", {})], name="edges-dev")
    R._check_carry(cfg, np.float32, (64, 64), "time_latency_device")
    monkeypatch.setattr(R, "_device_loop_body",
                        lambda *a: lambda y: (y * 255).to(torch.uint8))
    with pytest.raises(ValueError, match="edges-dev"):
        R._check_carry(cfg, np.float32, (64, 64), "time_latency_device")


def test_loop_body_refuses_other_ingest_dtypes():
    with pytest.raises(ValueError, match="float32 and int16"):
        R._device_loop_body(latency_config(), np.uint8, CPU)


def test_device_timers_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        R.time_pipeline_device(latency_config(), (64, 64), 2, inner=2,
                               repeats=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        R.time_latency_device(latency_config(), (64, 64), inner=2,
                              repeats=2, device="cpu")


def test_device_timers_return_the_reference_keys(monkeypatch):
    """The dicts the reference's timers return (plus the card's name, the
    kernels recorded at capture and the graph's peak), from a mocked
    graph whose replays took 1.0 .. 5.0 ms per iteration."""
    calls = []

    def fake_capture(cfg, shape, inner, dtype, device, timer):
        calls.append((shape, inner, np.dtype(dtype), timer))
        return types.SimpleNamespace(
            inner=inner, launches={"tile_luts": inner}, peak_bytes=123,
            device_name="card",
            replay_ms=lambda repeats: [5.0, 1.0, 3.0, 2.0, 4.0][:repeats])

    monkeypatch.setattr(R, "_capture_device_loop", fake_capture)
    r = R.time_pipeline_device(latency_config(), (64, 96), batch_size=4,
                               inner=8, repeats=5, dtype=np.int16)
    assert calls[-1] == ((4, 64, 96), 8, np.dtype(np.int16),
                         "time_pipeline_device")
    assert {"slices_per_sec", "p50_ms_per_slice", "ms_per_batch",
            "batch_size", "shape", "inner", "program", "device"} <= set(r)
    assert r["ms_per_batch"] == 3.0 and r["slices_per_sec"] == 4 / 3e-3
    assert r["p50_ms_per_slice"] == 0.75 and r["batch_size"] == 4
    assert r["shape"] == [64, 96] and r["inner"] == 8
    assert r["program"] == "cuda graph x8 (no per-call dispatch)"
    assert r["device"] == "card" and r["captured_launches"] == {"tile_luts": 8}
    assert r["graph_peak_bytes"] == 123

    r = R.time_latency_device(latency_config(), (64, 96), inner=64, repeats=5)
    assert calls[-1] == ((64, 96), 64, np.dtype(np.float32),
                         "time_latency_device")
    assert {"p50_ms", "p95_ms", "inner", "shape", "program",
            "device"} <= set(r)
    assert r["p50_ms"] == 3.0 and r["p95_ms"] == 5.0
    assert r["program"] == "cuda graph x64 (no per-call dispatch)"


def test_stage_at_fault_is_the_stage_that_read_the_host(monkeypatch):
    """A host read refused under capture (Canny's pixel count) names the
    canny stage, also when the capture's end raised while handling it."""
    def refuse(self):
        raise RuntimeError(CAPTURE_REFUSAL)

    body = R._device_loop_body(PipelineConfig.make(CANNY), np.float32, CPU)
    x = torch.from_numpy(
        np.random.default_rng(2).random((1, 32, 48), dtype=np.float32))
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    with pytest.raises(RuntimeError) as info:
        body(x)
    assert R._stage_at_fault(info.value) == "canny"
    with pytest.raises(RuntimeError) as info:
        try:
            body(x)
        except RuntimeError:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture")
    assert R._stage_at_fault(info.value) == "canny"
    assert R._stage_at_fault(RuntimeError("not in a chain")) is None


@pytest.mark.parametrize("rows,cols", [((0, 3), (2, 0)), ((5, 9), (7, 1))])
def test_reflect_pad_keeps_its_index_and_equals_numpy(rows, cols):
    """The skimage convention's reflect pad (any length) takes its index
    tensor from a cache: a capture finds it there instead of copying it
    from pageable host memory, which capture refuses."""
    x = np.random.default_rng(3).random((2, 6, 7), dtype=np.float32)
    want = np.pad(x, ((0, 0), rows, cols), mode="reflect")
    got = H._pad_reflect(torch.from_numpy(x), rows, cols)
    np.testing.assert_array_equal(got.numpy(), want)
    hits = H._reflect_index.cache_info().hits
    H._pad_reflect(torch.from_numpy(x), rows, cols)
    assert H._reflect_index.cache_info().hits == hits + 2


# --- on the card ----------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stages,kernels", [
    (list(flagship_config().stages),
     {"tile_luts", "clahe_apply_lut", "bilateral", "unsharp_quant"}),
    (W8, {"perona_malik"}),
], ids=["w5", "w8"])
def test_graph_replays_equal_the_eager_loop(cuda_device, stages, kernels):
    cfg = PipelineConfig.make(stages, name="graph-vs-eager")
    loop = R._capture_device_loop(cfg, (4, 256, 256), 4, np.float32,
                                  cuda_device, "test")
    loop.graph.replay()
    first = loop.y.clone()
    loop.graph.replay()
    eager = loop.eager()
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(loop.y, eager)
    assert set(loop.launches) == kernels
    assert all(n >= 4 and n % 4 == 0 for n in loop.launches.values())


@pytest.mark.cuda
def test_capture_refuses_canny_with_its_stage_named(cuda_device):
    cfg = PipelineConfig.make(CANNY, name="edges")
    with pytest.raises(RuntimeError, match="stage 'canny' of 'edges'"):
        R.time_pipeline_device(cfg, (64, 64), 2, inner=2, repeats=2,
                               device=cuda_device)
    # the card goes on working after the refused capture
    r = R.time_pipeline_device(latency_config(), (64, 64), 2, inner=2,
                               repeats=2, device=cuda_device)
    assert r["slices_per_sec"] > 0
    assert set(r["captured_launches"]) == {"tile_luts", "clahe_apply_lut",
                                           "bilateral"}


@pytest.mark.cuda
def test_the_skimage_config_captures(cuda_device):
    """Its reflect pads come from ops.histogram._reflect_index's cache, so
    nothing is copied from the host inside the capture."""
    cfg = load_config(REPO / "configs" / "xray_adapthist_skimage.yaml")
    loop = R._capture_device_loop(cfg, (4, 256, 256), 2, np.float32,
                                  cuda_device, "test")
    loop.graph.replay()
    eager = loop.eager()
    torch.cuda.synchronize()
    assert torch.equal(loop.y, eager)
    assert {"tile_hists_bins", "skimage_maps", "skimage_apply"} <= set(
        loop.launches)
