"""The port's denoiser training (``mies_tpu_torch.models.train``) against the
JAX package's (``mies_tpu.models.train``), and the CLI's train-denoiser.

* Three AdamW steps from one parameter tree carried across, on identical
  batches (the host generators are numpy copies, bit-equal), for every
  loss and for Noise2Void, at float32 on both sides (the reference's
  ``build_model`` patched to ``dtype=jnp.float32``): the losses within
  1e-5 relative and the parameters within 2e-5 (tests/test_models.py:235's
  bound: AdamW's first steps normalise each gradient, so reduction-order
  noise on a near-zero gradient becomes a visible move). Noise2Void with
  the l1 loss is the exception the same mechanism makes: the last layer's
  bias gradient is a sum of +-1/40 over the masked pixels that cancels to
  ~4e-9 on this batch, so its first AdamW move is +-lr by the roundoff's
  sign; there the losses are held to 1e-3 and the parameters to 1e-3.
* At the default bfloat16 (DnCNN, l2): the first loss within 1e-6, the
  later ones within 5e-4, the parameters within 6e-3 (two lr-sized moves).
* AdamW's settings are optax.adamw(1e-3)'s; the refusals are the
  reference's; a short ``train_denoiser`` run writes the checkpoint and the
  report with the reference's keys; ``python -m mies_tpu_torch
  train-denoiser`` equals the in-process run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mies_tpu.models.denoiser as JD
import mies_tpu.models.train as JT
from mies_tpu_torch import cli
from mies_tpu_torch.io.dicom import write_dicom
from mies_tpu_torch.io.image import save_image
from mies_tpu_torch.models import train as TT
from mies_tpu_torch.models.augment import AugmentConfig
from mies_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from mies_tpu_torch.models.denoiser import load_denoiser

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)
REPORT_KEYS = {"steps", "arch", "data", "objective", "loss", "augment",
               "final_loss", "psnr_noisy", "psnr_model", "psnr_bilateral"}


@pytest.fixture()
def jax_f32(monkeypatch):
    """The reference's make_train_step with float32 compute."""
    build = JD.build_model
    monkeypatch.setattr(JT, "build_model",
                        lambda arch="dncnn", features=32, depth=6:
                        build(arch, features, depth).clone(dtype=jnp.float32))


def _run_three_steps(arch, depth, loss, n2v, dtype):
    init_j, step_j, _ = JT.make_train_step(8, depth, self_supervised=n2v,
                                           arch=arch, loss=loss)
    sj = init_j(jax.random.PRNGKey(0))
    init_t, step_t, _ = TT.make_train_step(8, depth, self_supervised=n2v,
                                           arch=arch, loss=loss, device="cpu",
                                           dtype=dtype)
    st = init_t(flax_to_torch(jax.tree_util.tree_map(np.asarray, sj.params),
                              arch, 8, depth))
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(3):
        noisy, clean = JT.synth_batch(rng, 4, 32)
        batch = TT.n2v_mask_batch(rng, noisy) if n2v else (noisy, clean)
        sj, lj = step_j(sj, *[jnp.asarray(b) for b in batch])
        st, lt = step_t(st, *batch)
        losses.append((float(lt), float(lj)))
    assert st.step == 3
    ref = jax.tree_util.tree_leaves(sj.params)
    got = jax.tree_util.tree_leaves(torch_to_flax(st.model.state_dict(), arch,
                                                  8, depth))
    dparam = max(np.abs(np.asarray(a) - b).max() for a, b in zip(ref, got))
    return losses, dparam


STEPS = [("dncnn", 3, loss, False) for loss in TT.TRAIN_LOSSES]
STEPS += [("dncnn", 3, loss, True) for loss in ("l2", "l1")]
STEPS += [("unet", 2, "l2", False), ("unet", 2, "mix", False),
          ("unet", 2, "l2", True)]


@pytest.mark.parametrize("arch,depth,loss,n2v", STEPS,
                         ids=[f"{a}-{'n2v-' if n else ''}{loss}"
                              for a, _, loss, n in STEPS])
def test_three_adamw_steps_equal_the_references(jax_f32, arch, depth, loss,
                                                n2v):
    losses, dparam = _run_three_steps(arch, depth, loss, n2v, torch.float32)
    sign_limited = n2v and loss == "l1"
    rel, atol = (1e-3, 1e-3) if sign_limited else (1e-5, 2e-5)
    for got, want in losses:
        assert got == pytest.approx(want, rel=rel), losses
    assert dparam <= atol, dparam


def test_three_bf16_steps_follow_the_reference():
    losses, dparam = _run_three_steps("dncnn", 3, "l2", False, torch.bfloat16)
    assert losses[0][0] == pytest.approx(losses[0][1], rel=1e-6)
    for got, want in losses[1:]:
        assert got == pytest.approx(want, rel=5e-4)
    assert dparam <= 6e-3, dparam


def test_adamw_is_optaxs_and_the_refusals_are_the_references():
    init, _, make_opt = TT.make_train_step(8, 3, device="cpu")
    group = init(0).optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert make_opt is not None
    for kw, match in (({"loss": "huber"}, "loss must be one of"),
                      ({"loss": "ssim", "self_supervised": True},
                       "ssim/mix losses need dense targets")):
        with pytest.raises(ValueError, match=match):
            TT.make_train_step(8, 3, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JT.make_train_step(8, 3, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            TT.make_train_step(8, 3)


def test_host_batches_equal_the_references(tmp_path):
    """synth_batch, n2v_mask_batch and FileDataset (png, npy, int16 dcm):
    the same numbers from the same np.random.Generator."""
    for mod in (JT, TT):
        rng = np.random.default_rng(4)
        noisy, clean = mod.synth_batch(rng, 3, 24, 0.1)
        masked, target, mask = mod.n2v_mask_batch(rng, noisy)
        if mod is JT:
            want = (noisy, clean, masked, target, mask)
    got = (noisy, clean, masked, target, mask)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    save_image(tmp_path / "a.png", rng.integers(0, 256, (40, 50), np.uint8))
    np.save(tmp_path / "b.npy", rng.random((36, 44)).astype(np.float32))
    write_dicom(tmp_path / "c.dcm",
                rng.integers(-1000, 1500, (48, 40)).astype(np.int16))
    for mod in (JT, TT):
        ds = mod.FileDataset(tmp_path, patch=32)
        r = np.random.default_rng(6)
        out = (*ds.batch(r, 5, 0.08), ds.crops(r, 3))
        if mod is JT:
            want = out
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="smaller than patch"):
        TT.FileDataset(tmp_path, patch=45)


def test_train_denoiser_writes_the_checkpoint_and_the_report(tmp_path):
    """Noise2Void with augmentation (elastic), then noise2clean with the
    mix loss and evaluate=True: finite losses, the reference's report keys,
    the checkpoint loadable, train_report.json beside it; psnr_noisy is
    the reference's on the same held-out phantoms."""
    state, losses, report = TT.train_denoiser(
        steps=3, batch=4, patch=32, features=8, depth=3, log_every=1,
        self_supervised=True, augment=AugmentConfig(elastic=3.0),
        device="cpu")
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert report["objective"] == "noise2void" and report["augment"]["elastic"] == 3.0
    state, losses, report = TT.train_denoiser(
        steps=4, batch=4, patch=32, features=8, depth=2, arch="unet",
        loss="mix", evaluate=True, checkpoint_dir=str(tmp_path / "ck"),
        log_every=2, device="cpu")
    assert set(report) == REPORT_KEYS and len(losses) == 3
    assert report["final_loss"] == losses[-1] and state.step == 4
    _, features, depth, arch = load_denoiser(tmp_path / "ck")
    assert (features, depth, arch) == (8, 2, "unet")
    assert json.loads((tmp_path / "ck" / "train_report.json").read_text()) \
        == report
    noisy, clean = JT.synth_batch(np.random.default_rng(1234), 16, 128, 0.08)
    mse = ((noisy[..., 0].astype(np.float64) - clean[..., 0]) ** 2).mean((1, 2))
    assert report["psnr_noisy"] == pytest.approx(
        float(np.mean(10 * np.log10(1.0 / mse))), rel=1e-5)


def test_cli_train_denoiser_in_process_and_as_a_module(tmp_path, capsys):
    """The reference's JSON line (checkpoint, steps, loss_curve, the
    report); `python -m mies_tpu_torch train-denoiser` gives the same run."""
    args = ["train-denoiser", "-o", str(tmp_path / "a"), "--steps", "3",
            "--batch", "4", "--patch", "32", "--features", "8", "--depth",
            "3", "--augment"]
    assert cli.main(args, device="cpu") == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == {"checkpoint", "steps", "loss_curve"} | REPORT_KEYS - {
        "psnr_noisy", "psnr_model", "psnr_bilateral"}
    assert got["steps"] == 3 and got["checkpoint"] == str(tmp_path / "a")
    assert got["augment"]["brightness"] == 0.05
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    code = ("import sys, torch; torch.set_num_threads(2); "
            "from mies_tpu_torch import cli; "
            "sys.exit(cli.main(sys.argv[1:], device='cpu'))")
    args[2] = str(tmp_path / "b")
    proc = subprocess.run([sys.executable, "-c", code, *args], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    sub = json.loads(proc.stdout)
    np.testing.assert_allclose(sub["loss_curve"], got["loss_curve"],
                               rtol=1e-5)
    assert (tmp_path / "b" / "params.pt").exists()
