"""``parallel.sharded_evaluate`` and the data-parallel train step in real
gloo worlds of 1, 2 and 4 processes on the CPU, and the metric suite on
the card.

One ``spawn`` per world size runs every case (``_worker``, which imports
only torch and the port) and writes each rank's outputs; the tests hold
the worlds of 2 and 4 against the world of one:

* ``sharded_evaluate`` on the flagship (float32), a bilateral -> unsharp
  chain (uint8) and ``configs/ct_soft_tissue.yaml`` (int16 HU through the
  chain's window): the uint8 shards, stitched, bit-equal to
  ``compile_pipeline(batched=True)``; the batch means within 1e-6
  relative of the world of one (float64 sums in another grouping) and of
  the unsharded metrics; the uint8 chain's means within 1e-4 of the JAX
  package's ``sharded_evaluate`` on its fake CPU devices (its chain is a
  level off on a few pixels); int16 input without a window refused with
  the reference's message.
* ``make_train_step(mesh=)``, three steps of l2, mix and Noise2Void l2 on
  8-image batches, against the world of one: the first loss within 1e-6
  relative; AdamW's normalised first steps turn the gradients' other
  summation order into parameter moves of up to ~2e-5, so the parameters
  are held to 5e-5 and the later losses to 1e-3 (the l2 loss of step 3
  moves 6e-4 with them); every rank's parameters equal;
  ``train-denoiser --data-parallel`` writes (rank 0) the checkpoint a
  world of one writes, within 5e-5.

The card tests (marker ``cuda``; ``python -m pytest
tests/test_torch_eval_shard.py --noconftest -m cuda``): every metric on
the card against the CPU, ``sharded_evaluate`` at NCCL world 1 against
``compile_pipeline`` + the metrics with K1 to the LUTs, K2, K3 and K4
once a call.
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
from pytest import skip

from mies_tpu_torch import cli
from mies_tpu_torch.eval import metrics as T
from mies_tpu_torch.kernels import _build
from mies_tpu_torch.models import train as TT
from mies_tpu_torch.models.denoiser import load_denoiser
from mies_tpu_torch.parallel import init_distributed, make_mesh, sharded_evaluate
from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, load_config
from mies_tpu_torch.pipeline.presets import flagship_config

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 180
torch.set_num_threads(2)
SHARP = [("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                             "sigma_space": 1.5}),
         ("unsharp_mask", {"radius": 1.5, "amount": 1.0})]
TRAIN = {"l2": ("l2", False), "mix": ("mix", False), "n2v": ("l2", True)}


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:48, 0:64]
    base = 0.5 + 0.25 * np.sin(x / 7.0) * np.cos(y / 5.0)
    flt = np.clip(base + 0.05 * rng.standard_normal((8, 48, 64)), 0, 1)
    hu = 40 + 300 * np.sin(x / 6.0) + 30 * rng.standard_normal((8, 48, 64))
    return {"float": flt.astype(np.float32),
            "uint8": np.rint(flt * 255).astype(np.uint8),
            "int16": hu.astype(np.int16)}


def _eval_cases() -> dict:
    """name -> (config, input, metric names, max_val)."""
    return {
        "flagship": (flagship_config(), "float",
                     ("psnr", "ssim", "uqi", "vifp"), 1.0),
        "uint8": (PipelineConfig.make(SHARP), "uint8", ("psnr", "ssim"),
                  255.0),
        "ct": (load_config(REPO / "configs" / "ct_soft_tissue.yaml"), "int16",
               ("psnr", "ssim", "rmse"), 1.0),
    }


def _train_batches(n2v: bool) -> list:
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        noisy, clean = TT.synth_batch(rng, 8, 32)
        out.append(TT.n2v_mask_batch(rng, noisy) if n2v else (noisy, clean))
    return out


def _train(mesh, loss: str, n2v: bool):
    init, step, _ = TT.make_train_step(8, 3, mesh=mesh, self_supervised=n2v,
                                       loss=loss, device="cpu")
    state = init(0)
    losses = []
    for batch in _train_batches(n2v):
        state, value = step(state, *batch)
        losses.append(float(value))
    return losses, {k: v.detach().numpy() for k, v in
                    state.model.state_dict().items()}


CLI_TRAIN = ["--steps", "2", "--batch", "8", "--patch", "32", "--features",
             "8", "--depth", "3"]


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a gloo world: every sharded_evaluate case on this rank's
    shard, the train steps, train-denoiser --data-parallel."""
    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        init_distributed(f"file://{store}", world, rank, device="cpu")
        mesh = make_mesh()
        x = _inputs()
        res = {}
        for name, (cfg, inp, names, mv) in _eval_cases().items():
            k = 8 // world
            u8, means = sharded_evaluate(cfg, mesh, names, mv)(
                x[inp][rank * k:(rank + 1) * k])
            np.save(out_dir / f"{name}_{rank}.npy", u8.numpy())
            res[name] = means
        try:
            sharded_evaluate(PipelineConfig.make(SHARP[1:]), mesh)(
                x["int16"][:8 // world])
        except ValueError as e:
            res["refused"] = str(e)
        for name, (loss, n2v) in TRAIN.items():
            losses, params = _train(mesh, loss, n2v)
            res[f"train_{name}"] = losses
            np.savez(out_dir / f"train_{name}_{rank}.npz", **params)
        res["cli"] = cli.main(["train-denoiser", "-o", str(out_dir / "ck"),
                               *CLI_TRAIN, "--data-parallel"], device="cpu")
        (out_dir / f"res_{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _spawn(world: int, out: Path) -> Path:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(out / "store"),
                                               str(out)))
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
def worlds(tmp_path_factory):
    return {n: _spawn(n, tmp_path_factory.mktemp(f"world{n}"))
            for n in (1, 2, 4)}


def _res(out: Path, rank: int = 0) -> dict:
    return json.loads((out / f"res_{rank}.json").read_text())


@pytest.mark.parametrize("name", ["flagship", "uint8", "ct"])
def test_sharded_evaluate_equals_the_world_of_one(worlds, name):
    cfg, inp, names, mv = _eval_cases()[name]
    x = _inputs()[inp]
    whole = compile_pipeline(cfg, batched=True, device="cpu")(x).numpy()
    flt = compile_pipeline(cfg, batched=True, quantize=False, device="cpu")(x)
    from mies_tpu_torch.ops.intensity import window_hu
    from mies_tpu_torch.pipeline.compiler import _ingest

    gt = _ingest(torch.from_numpy(x))
    if inp == "int16":
        win = next(s for s in cfg.stages if s.op == "window_hu").kwargs()
        gt = window_hu(gt, **win)
    per = T.metric_values(gt * mv, flt * mv, names, mv)
    direct = {k: float(v.double().mean()) for k, v in per.items()}
    for n, out in worlds.items():
        u8 = np.concatenate([np.load(out / f"{name}_{r}.npy")
                             for r in range(n)])
        np.testing.assert_array_equal(u8, whole)
        for r in range(n):
            means = _res(out, r)[name]
            assert list(means) == list(names)
            for k in names:
                assert means[k] == pytest.approx(direct[k], rel=1e-6), (n, k)


def test_sharded_evaluate_equals_the_jax_package(worlds):
    """The uint8 chain's batch means against mies_tpu's sharded_evaluate on
    4 of the conftest's fake CPU devices: within 1e-4 relative (the two
    chains' outputs are a level apart on a few pixels)."""
    import jax
    import jax.numpy as jnp

    import mies_tpu
    from mies_tpu.parallel import make_mesh as jax_mesh
    from mies_tpu.parallel import sharded_evaluate as jax_eval

    cfg, inp, names, mv = _eval_cases()["uint8"]
    mesh = jax_mesh(data=4, space=1, devices=jax.devices()[:4])
    _, want = jax_eval(mies_tpu.PipelineConfig.make(SHARP), mesh, names,
                       mv)(jnp.asarray(_inputs()[inp]))
    got = _res(worlds[4])["uint8"]
    for k in names:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4), k


def test_sharded_evaluate_refuses_int16_without_a_window(worlds):
    for n, out in worlds.items():
        assert "int16 HU input needs a window_hu stage" in \
            _res(out)["refused"], n


@pytest.mark.parametrize("name", list(TRAIN))
def test_data_parallel_train_step_equals_the_world_of_one(worlds, name):
    loss, n2v = TRAIN[name]
    one_losses, one_params = _train(None, loss, n2v)
    for n, out in worlds.items():
        for r in range(n):
            losses = _res(out, r)[f"train_{name}"]
            assert losses[0] == pytest.approx(one_losses[0], rel=1e-6)
            np.testing.assert_allclose(losses, one_losses, rtol=1e-3)
            got = np.load(out / f"train_{name}_{r}.npz")
            for k, v in one_params.items():
                np.testing.assert_allclose(got[k], v, rtol=0, atol=5e-5,
                                           err_msg=f"{n} {r} {k}")
            if r:
                first = np.load(out / f"train_{name}_0.npz")
                for k in one_params:
                    np.testing.assert_array_equal(got[k], first[k])


def test_train_denoiser_data_parallel_writes_the_world_of_ones_checkpoint(
        worlds, tmp_path):
    assert cli.main(["train-denoiser", "-o", str(tmp_path / "one"),
                     *CLI_TRAIN], device="cpu") == 0
    want, *meta = load_denoiser(tmp_path / "one")
    for n, out in worlds.items():
        assert _res(out)["cli"] == 0
        got, *got_meta = load_denoiser(out / "ck")
        assert got_meta == meta
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=5e-5)


# --- the card -----------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# tests/test_torch_metrics.py's bounds (card against CPU: the same float32
# adds, other reduction orders)
CARD_REL = {**dict.fromkeys(T.METRIC_REGISTRY, 2e-6),
            **dict.fromkeys(("ssim", "uqi", "scc", "vifp", "msssim"), 5e-5)}
CARD_ABS = {**dict.fromkeys(T.METRIC_REGISTRY, 1e-6), "sam": 1e-3}


@pytest.mark.cuda
def test_metrics_on_card_equal_cpu(cuda_device):
    gen = torch.Generator().manual_seed(0)
    gt = torch.rand(4, 176, 190, generator=gen) * 255
    p = torch.clamp(gt + 8 * torch.randn(4, 176, 190, generator=gen), 0, 255)
    for name in T.METRIC_REGISTRY:
        cpu = T.metric_values(gt, p, (name,), 255.0)[name]
        card = T.metric_values(gt.to(cuda_device), p.to(cuda_device), (name,),
                               255.0)[name].cpu()
        tol = CARD_REL[name] * cpu.abs() + CARD_ABS[name]
        assert bool(((card - cpu).abs() <= tol).all()), (name, card, cpu)


@pytest.mark.cuda
def test_sharded_evaluate_on_card_world_one(cuda_device, tmp_path):
    x = torch.from_numpy(_inputs()["float"]).repeat(4, 1, 1)
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cuda")
    try:
        fn = sharded_evaluate(flagship_config(), make_mesh(),
                              ("psnr", "ssim"), 1.0)
        fn(x)
        _build.reset_launches()
        u8, means = fn(x)
        torch.cuda.synchronize()
        want = {k: int(k in ("tile_luts", "clahe_apply_lut", "bilateral",
                             "unsharp_quant")) for k in _build.LAUNCHES}
        assert dict(_build.LAUNCHES) == want
    finally:
        dist.destroy_process_group()
    ref = compile_pipeline(flagship_config(), batched=True,
                           device=cuda_device)(x)
    assert torch.equal(u8, ref)
    flt = compile_pipeline(flagship_config(), batched=True, quantize=False,
                           device=cuda_device)(x)
    per = T.metric_values(x.to(cuda_device), flt, ("psnr", "ssim"), 1.0)
    for k in ("psnr", "ssim"):
        assert means[k] == pytest.approx(float(per[k].double().mean()),
                                         rel=1e-6)
