"""Training of the learned denoiser: AdamW, noise2clean or Noise2Void,
optionally data-parallel over torch.distributed.

The port of ``mies_tpu.models.train``. The optimizer is the reference's
``optax.adamw(1e-3)``: betas (0.9, 0.999), eps 1e-8 and a weight decay of
1e-4 on every parameter, biases included (``torch.optim.AdamW``'s default
decay is 1e-2). Batches come from the host generators the reference uses
(``synth_batch``, ``n2v_mask_batch``, ``FileDataset``: numpy copies, so one
``np.random.Generator`` gives both packages the same batches), as
[B, p, p, 1]; the step takes them as they are and runs the model on NCHW.

With a ``mesh``, every rank takes the whole batch, runs the model on its
own shard of it, and one ``all_reduce`` sums the gradients (and the loss)
over the ranks. Each rank's loss term is its share of the whole batch's
loss (its sum over the global count), so the summed gradient is the
gradient of the loss over the whole batch and the parameters stay
replicated: a world of N takes the step a world of one takes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mies_tpu_torch.models.denoiser import (
    denoise_batch,
    init_params,
    save_denoiser,
)

TRAIN_LOSSES = ("l2", "l1", "ssim", "mix")
# optax.adamw's defaults at learning rate 1e-3
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


@dataclasses.dataclass
class TrainState:
    """The model (its parameters float32), its optimizer and the step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _ssim_sum(denoised: torch.Tensor, clean: torch.Tensor, ws: int = 7
              ) -> torch.Tensor:
    """The sum over the batch of each image's mean SSIM (sewar's uniform
    window via eval.metrics._ssim_maps, max_val 1 for [0, 1] floats; ws 7
    keeps a meaningful valid region on small patches)."""
    from mies_tpu_torch.eval.metrics import _ssim_maps

    m, _ = _ssim_maps(clean[:, 0], denoised[:, 0], ws, 0.01, 0.03, 1.0)
    return m.mean(dim=(-2, -1)).sum()


def _nchw(x, dev: torch.device) -> torch.Tensor:
    """A [B, p, p, 1] batch (numpy or tensor) as float32 [B, 1, p, p] on dev."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"expected a [B, p, p, 1] batch, got {tuple(x.shape)}")
    return x.to(dev, torch.float32).permute(0, 3, 1, 2)


def make_train_step(
    features: int = 32,
    depth: int = 6,
    learning_rate: float = 1e-3,
    mesh=None,
    self_supervised: bool = False,
    arch: str = "dncnn",
    loss: str = "l2",
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[Callable, Callable, Callable]:
    """Returns (init_fn, train_step, make_optimizer).

    self_supervised=False (noise2clean): train_step(state, noisy, clean),
    the loss on the predicted residual against the true noise (l2, l1), on
    the denoised estimate (ssim), or 0.16 L1 + 0.84 SSIM (mix).
    self_supervised=True (Noise2Void): train_step(state, masked, target,
    mask), the masked-pixel l2 (or l1) of the DENOISED estimate against the
    original noisy values. Batches are [B, p, p, 1]; the step returns
    (state, loss) with the loss a 0-d tensor on the device (no host read).

    init_fn(seed) builds a model from flax's distributions; init_fn(state
    dict) loads given parameters. With a ``mesh``, each rank runs its shard
    of every batch (B must divide by the mesh's size) and the gradients are
    summed over the mesh's ranks by one all_reduce.
    """
    if loss not in TRAIN_LOSSES:
        raise ValueError(f"loss must be one of {TRAIN_LOSSES}, got {loss!r}")
    if self_supervised and loss in ("ssim", "mix"):
        raise ValueError(
            "ssim/mix losses need dense targets; Noise2Void's blind-spot "
            "objective is defined only on the masked pixels — use l1/l2"
        )
    if mesh is not None:
        from mies_tpu_torch.parallel.mesh import mesh_device
        from mies_tpu_torch.parallel.sharding import _mesh_group, shard_index

        dev = mesh_device(mesh)
        n_shards, me = mesh.mesh.numel(), shard_index(mesh)
        group = _mesh_group(mesh)
    else:
        from mies_tpu_torch.pipeline.compiler import resolve_device

        dev = resolve_device(device)
        n_shards, me, group = 1, 0, None

    def make_optimizer(params) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=learning_rate, **ADAMW)

    def init_fn(seed_or_state=0) -> TrainState:
        if isinstance(seed_or_state, dict):
            model = init_params(0, features, depth, arch, dtype)
            model.load_state_dict(seed_or_state)
        else:
            model = init_params(int(seed_or_state), features, depth, arch,
                                dtype)
        model = model.to(dev).train()
        return TrainState(model, make_optimizer(model.parameters()), 0)

    def shard(*xs):
        b = xs[0].shape[0]
        if b % n_shards:
            raise ValueError(f"batch {b} does not divide by the mesh's "
                             f"{n_shards} ranks")
        k = b // n_shards
        return [x[me * k:(me + 1) * k] for x in xs]

    def loss_part(model, noisy, clean, b_total):
        """This shard's share of the loss over the whole batch."""
        pred_noise = model(noisy)
        count = float(b_total * noisy[0].numel())
        if loss in ("l2", "l1"):
            err = pred_noise - (noisy - clean)
            e = err * err if loss == "l2" else err.abs()
            return e.sum() / count
        denoised = noisy - pred_noise
        ssim_part = 1.0 / n_shards - _ssim_sum(denoised, clean) / b_total
        if loss == "ssim":
            return ssim_part
        l1 = (pred_noise - (noisy - clean)).abs().sum() / count
        return 0.16 * l1 + 0.84 * ssim_part

    def n2v_part(model, masked, target, mask, mask_total):
        denoised = masked - model(masked)
        err = denoised - target
        e = err.abs() if loss == "l1" else err * err
        return (e * mask).sum() / torch.clamp_min(mask_total, 1.0)

    def finish(state: TrainState, part: torch.Tensor):
        """Backward, the gradient (and loss) all_reduce over the mesh, the
        optimizer step."""
        part.backward()
        params = list(state.model.parameters())
        if mesh is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [part.detach().reshape(1)])
            dist.all_reduce(flat, group=group)
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
            value = flat[-1]
        else:
            value = part.detach()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=False)
        state.step += 1
        return state, value

    if self_supervised:

        def train_step(state: TrainState, masked, target, mask):
            masked, target, mask = (_nchw(v, dev) for v in (masked, target, mask))
            total = mask.sum()
            masked, target, mask = shard(masked, target, mask)
            return finish(state, n2v_part(state.model, masked, target, mask,
                                          total))

    else:

        def train_step(state: TrainState, noisy, clean):
            noisy, clean = _nchw(noisy, dev), _nchw(clean, dev)
            b_total = noisy.shape[0]
            noisy, clean = shard(noisy, clean)
            return finish(state, loss_part(state.model, noisy, clean, b_total))

    return init_fn, train_step, make_optimizer


def n2v_mask_batch(
    rng: np.random.Generator,
    noisy: np.ndarray,
    frac: float = 0.01,
    radius: int = 2,
):
    """Noise2Void blind-spot masking (Krull et al., CVPR 2019, uniform
    pixel selection): ``frac`` of each patch's pixels replaced by a random
    neighbour within ``radius``, never the pixel itself. Returns (masked,
    target, mask), all [B, p, p, 1]; target is the untouched noisy batch.
    The reference's numpy code, draw for draw."""
    b, p = noisy.shape[0], noisy.shape[1]
    n_mask = max(1, int(frac * p * p))
    masked = noisy.copy()
    mask = np.zeros_like(noisy)
    for i in range(b):
        ys = rng.integers(0, p, n_mask)
        xs = rng.integers(0, p, n_mask)
        dy = rng.integers(-radius, radius + 1, n_mask)
        dx = rng.integers(-radius, radius + 1, n_mask)
        dx = np.where((dy == 0) & (dx == 0), 1, dx)  # exclude the center
        sy = np.clip(ys + dy, 0, p - 1)
        sx = np.clip(xs + dx, 0, p - 1)
        # border clipping can land back ON the masked pixel: step off it
        collide = (sy == ys) & (sx == xs)
        sx = np.where(collide, np.where(xs > 0, xs - 1, xs + 1), sx)
        masked[i, ys, xs, 0] = noisy[i, sy, sx, 0]
        mask[i, ys, xs, 0] = 1.0
    return masked, noisy, mask


def synth_batch(rng: np.random.Generator, batch: int, patch: int,
                sigma: float = 0.08):
    """Synthetic clean/noisy pairs [B, p, p, 1]: smooth phantoms + Gaussian
    noise (the reference's numpy code, draw for draw)."""
    y, x = np.mgrid[0:patch, 0:patch].astype(np.float32) / patch
    clean = []
    for _ in range(batch):
        cx, cy, s = rng.random(3)
        img = np.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / (0.05 + 0.2 * s)))
        img += 0.2 * np.sin(12 * x * rng.random()) * np.cos(9 * y * rng.random())
        clean.append(np.clip(img, 0, 1))
    clean = np.stack(clean)[..., None].astype(np.float32)
    noisy = np.clip(
        clean + rng.normal(0, sigma, clean.shape).astype(np.float32), 0, 1
    )
    return noisy, clean


class FileDataset:
    """Clean patches from a directory of real slices: .png/.jpg/.tif, .npy
    and .dcm; normalised to float [0, 1] (int16 HU windowed to each
    image's 1st..99th percentiles). Batches are random patch crops with
    synthetic Gaussian noise added (noise2clean), or the raw crops
    (Noise2Void). The reference's class over the port's file I/O."""

    _IMG = (".png", ".jpg", ".jpeg", ".tif", ".tiff")

    def __init__(self, data_dir, patch: int = 64, max_images: int = 256):
        self.patch = patch
        paths = sorted(
            p
            for p in Path(data_dir).iterdir()
            if p.suffix.lower() in (*self._IMG, ".npy", ".dcm")
        )
        if not paths:
            raise FileNotFoundError(
                f"no trainable images (png/jpg/tif/npy/dcm) in {data_dir}"
            )
        self.images = [self._load(p) for p in paths[:max_images]]
        small = [
            p for p, im in zip(paths, self.images)
            if min(im.shape) < patch
        ]
        if small:
            raise ValueError(
                f"{len(small)} image(s) smaller than patch={patch}, "
                f"e.g. {small[0]}"
            )

    def _load(self, p) -> np.ndarray:
        if p.suffix.lower() == ".npy":
            arr = np.load(p)
        elif p.suffix.lower() == ".dcm":
            from mies_tpu_torch.io.dicom import read_dicom

            arr = read_dicom(p).pixels
        else:
            from mies_tpu_torch.io.image import load_image

            return load_image(p, dtype="float32")
        arr = arr.astype(np.float32)
        if arr.ndim != 2:
            raise ValueError(f"{p}: expected a 2-D slice, got {arr.shape}")
        lo, hi = np.percentile(arr, (1.0, 99.0))
        return np.clip((arr - lo) / max(hi - lo, 1e-6), 0.0, 1.0)

    def crops(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        """Random raw patch crops [B, p, p, 1], no synthetic noise."""
        p = self.patch
        out = []
        for _ in range(batch):
            im = self.images[rng.integers(len(self.images))]
            y = rng.integers(im.shape[0] - p + 1)
            x = rng.integers(im.shape[1] - p + 1)
            out.append(im[y : y + p, x : x + p])
        return np.stack(out)[..., None].astype(np.float32)

    def batch(self, rng: np.random.Generator, batch: int, sigma: float):
        """Random crops + Gaussian noise -> (noisy, clean) [B, p, p, 1]."""
        clean = self.crops(rng, batch)
        noisy = np.clip(
            clean + rng.normal(0, sigma, clean.shape).astype(np.float32), 0, 1
        )
        return noisy, clean


def _eval_vs_bilateral(model: nn.Module, sigma: float, seed: int = 1234
                       ) -> dict:
    """Mean PSNR (max_val 1) of the noisy input, the trained denoiser and
    the bilateral baseline on a fixed held-out set of 16 phantoms of 128^2,
    on the model's device."""
    from mies_tpu_torch.eval.metrics import psnr
    from mies_tpu_torch.kernels.bilateral import denoise_bilateral_batched

    dev = next(model.parameters()).device
    noisy, clean = synth_batch(np.random.default_rng(seed), 16, 128, sigma)
    noisy2d = torch.from_numpy(noisy[..., 0]).to(dev)
    clean2d = torch.from_numpy(clean[..., 0]).to(dev)

    def psnr_of(pred):
        return float(psnr(clean2d, pred, max_val=1.0).mean())

    was_training = model.training
    model.eval()
    with torch.no_grad():
        model_out = denoise_batch(model, noisy2d)
        bilat_out = denoise_bilateral_batched(noisy2d, sigma_color=2 * sigma,
                                              sigma_spatial=1.5)
    model.train(was_training)
    return {
        "psnr_noisy": psnr_of(noisy2d),
        "psnr_model": psnr_of(model_out),
        "psnr_bilateral": psnr_of(bilat_out),
    }


def train_denoiser(
    steps: int = 200,
    batch: int = 32,
    patch: int = 64,
    features: int = 32,
    depth: int = 6,
    sigma: float = 0.08,
    seed: int = 0,
    mesh=None,
    checkpoint_dir: str | None = None,
    log_every: int = 50,
    data_dir: str | None = None,
    evaluate: bool = False,
    self_supervised: bool = False,
    arch: str = "dncnn",
    augment=None,
    loss: str = "l2",
    device="cuda",
) -> tuple[TrainState, list[float], dict]:
    """Train the denoiser; returns (state, losses, report).

    data_dir=None trains on synthetic phantoms, else on patches of the
    slices in it (``FileDataset``). evaluate=True adds the PSNR of the
    model and of the bilateral baseline on a held-out phantom set to the
    report, which is also written beside the checkpoint
    (``train_report.json``). self_supervised=True trains Noise2Void-style,
    from noisy data alone (with a data_dir, the crops' own noise). augment
    (an ``AugmentConfig``) augments each batch on the device: the same
    geometric transform on input and target, photometric jitter on the
    input only; Noise2Void's crops are augmented before the masking. With
    a ``mesh`` every rank draws the same batches and runs its shard; rank
    0 writes the checkpoint. ``device`` ("cuda" by default; no card ->
    RuntimeError) is ignored under a mesh, whose rank device is used.
    """
    init_fn, step_fn, _ = make_train_step(
        features, depth, mesh=mesh, self_supervised=self_supervised,
        arch=arch, loss=loss, device=device,
    )
    state = init_fn(seed)
    dev = next(state.model.parameters()).device
    rng = np.random.default_rng(seed)
    dataset = FileDataset(data_dir, patch=patch) if data_dir else None
    if augment is not None:
        from mies_tpu_torch.models.augment import augment_batch, augment_pair

        aug_gen = torch.Generator().manual_seed(seed ^ 0x5A5A5A)

    def nhwc(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1)

    losses = []
    for i in range(steps):
        if self_supervised:
            if dataset is not None:
                noisy = dataset.crops(rng, batch)
            else:
                noisy, _ = synth_batch(rng, batch, patch, sigma)
            if augment is not None:
                noisy = nhwc(augment_batch(aug_gen, _nchw(noisy, dev),
                                           augment)).cpu().numpy()
            masked, target, mask = n2v_mask_batch(rng, noisy)
            state, loss_val = step_fn(state, masked, target, mask)
        else:
            if dataset is not None:
                noisy, clean = dataset.batch(rng, batch, sigma)
            else:
                noisy, clean = synth_batch(rng, batch, patch, sigma)
            if augment is not None:
                n, c = augment_pair(aug_gen, _nchw(noisy, dev),
                                    _nchw(clean, dev), augment)
                noisy, clean = nhwc(n), nhwc(c)
            state, loss_val = step_fn(state, noisy, clean)
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss_val))
    report = {
        "steps": steps,
        "arch": arch,
        "data": data_dir or "synthetic-phantoms",
        "objective": "noise2void" if self_supervised else "noise2clean",
        "loss": loss,
        "augment": None if augment is None else dataclasses.asdict(augment),
        "final_loss": losses[-1] if losses else None,
    }
    if evaluate:
        report.update(_eval_vs_bilateral(state.model, sigma))
    if checkpoint_dir is not None and (mesh is None or dist.get_rank() == 0):
        save_denoiser(checkpoint_dir, state.model, features, depth, arch=arch)
        (Path(checkpoint_dir) / "train_report.json").write_text(
            json.dumps(report, indent=2) + "\n"
        )
    return state, losses, report
