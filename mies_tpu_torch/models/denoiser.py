"""Residual denoising CNN (DnCNN-style) for medical slices.

The port of ``mies_tpu.models.denoiser``. Architecture: conv-relu, (depth-2)
x [conv-relu], conv, predicting the NOISE residual; the denoised image is
the input minus the predicted noise. All convolutions are 3x3 with a pad of
1 ('SAME'), on NCHW tensors with C = 1. As in the reference, the parameters
are float32 and the compute dtype is bfloat16 by default: each convolution
casts its input, kernel and bias to ``dtype`` and adds the bias after the
convolution, in ``dtype``. The middle blocks run under activation
checkpointing while training (the reference's ``nn.remat``): recomputed in
the backward pass, the same numbers.

Checkpoints are a directory with the reference's ``meta.json`` keys
(features, depth, arch) and a PyTorch state dict, ``params.pt``, loaded
with ``weights_only=True``. The reference writes orbax instead;
``tools/convert_denoiser_ckpt.py`` (run where JAX is) converts one.

The pipeline's ``learned_denoise`` stage builds the model from a checkpoint
once, when the chain is built (``pipeline.compiler``).
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose standard normal truncated to [-2, 2] has this standard deviation
_TRUNC_STD = 0.87962566103423978
PARAMS_FILE = "params.pt"
CONVERTER = "tools/convert_denoiser_ckpt.py"


class Conv3x3(nn.Module):
    """3x3 convolution with float32 parameters computed in ``dtype``:
    stride 1 pads 1 on every side; stride 2 pads (0, 1) on each spatial axis,
    flax's 'SAME' on an even extent (total pad 1, the low side 0)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset(self, gen: torch.Generator | None) -> None:
        """flax's initialisers: lecun_normal kernels, zero biases."""
        std = math.sqrt(1.0 / (9 * self.weight.shape[1])) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stride == 1:
            y = F.conv2d(x, self.weight.to(self.dtype), padding=1)
        else:
            y = F.conv2d(F.pad(x, (0, 1, 0, 1)), self.weight.to(self.dtype),
                         stride=self.stride)
        return y + self.bias.to(self.dtype)[:, None, None]


def init_convs(module: nn.Module, gen: torch.Generator | None) -> nn.Module:
    """Initialise every Conv3x3 of ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, Conv3x3):
            m.reset(gen)
    return module


def remat(fn, x: torch.Tensor, training: bool) -> torch.Tensor:
    """fn(x), its activations recomputed in the backward pass while
    training (the reference's nn.remat)."""
    if training and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class DenoiserCNN(nn.Module):
    """Predicts the noise residual of a [N, 1, H, W] image (float32 out)."""

    def __init__(self, features: int = 32, depth: int = 6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.depth, self.dtype = features, depth, dtype
        widths = [1] + [features] * (depth - 1) + [1]
        self.convs = nn.ModuleList(
            Conv3x3(a, b, dtype=dtype) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.convs[0](x.to(self.dtype)))
        for conv in self.convs[1:-1]:
            h = remat(lambda v, c=conv: F.relu(c(v)), h, self.training)
        return self.convs[-1](h).to(torch.float32)


def build_model(arch: str = "dncnn", features: int = 32, depth: int = 6,
                dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Model-family registry: ``arch`` in {'dncnn', 'unet'}. Both predict
    the noise residual; for 'unet', ``depth`` is the number of stride-2
    levels (1..4)."""
    if arch == "dncnn":
        return DenoiserCNN(features=features, depth=depth, dtype=dtype)
    if arch == "unet":
        from mies_tpu_torch.models.unet import UNetDenoiser

        if not 1 <= depth <= 4:
            raise ValueError(
                f"unet depth (stride-2 levels) must be 1..4, got {depth}"
            )
        return UNetDenoiser(features=features, levels=depth, dtype=dtype)
    raise ValueError(f"unknown denoiser arch {arch!r}; use 'dncnn' or 'unet'")


def init_params(seed: int = 0, features: int = 32, depth: int = 6,
                arch: str = "dncnn",
                dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A freshly initialised model (on the CPU) from ``seed``: flax's
    distributions drawn from a seeded torch.Generator (the same
    distributions as the reference's PRNGKey(seed), not the same draws)."""
    gen = torch.Generator().manual_seed(int(seed))
    return init_convs(build_model(arch, features, depth, dtype), gen)


def denoise_batch(model: nn.Module, imgs: torch.Tensor) -> torch.Tensor:
    """Apply the denoiser to [B, H, W] float [0, 1]: clip(x - noise, 0, 1)."""
    x = imgs.to(torch.float32)[:, None]
    return torch.clamp((x - model(x))[:, 0], 0.0, 1.0)


def denoise(model: nn.Module, img: torch.Tensor) -> torch.Tensor:
    """Apply the denoiser to one [H, W] float [0, 1] image."""
    return denoise_batch(model, img[None])[0]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def save_denoiser(path: str | Path, params, features: int, depth: int,
                  arch: str = "dncnn") -> None:
    """Write ``params`` (a model or its state dict) and meta.json to the
    directory ``path``."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    state = params.state_dict() if isinstance(params, nn.Module) else params
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               path / PARAMS_FILE)
    (path / "meta.json").write_text(
        json.dumps({"features": features, "depth": depth, "arch": arch}))


@functools.lru_cache(maxsize=8)
def _load(path: str, stamp: int):
    p = Path(path)
    meta = json.loads((p / "meta.json").read_text())
    state = torch.load(p / PARAMS_FILE, map_location="cpu", weights_only=True)
    return state, meta["features"], meta["depth"], meta.get("arch", "dncnn")


def load_denoiser(path: str | Path):
    """(state_dict, features, depth, arch) of a checkpoint directory.
    Checkpoints without an 'arch' key load as 'dncnn'. A directory holding
    only the reference's orbax ``params/`` raises, naming the converter."""
    p = Path(path).absolute()
    if not (p / PARAMS_FILE).exists() and (p / "params").is_dir():
        raise ValueError(
            f"{p} holds an orbax checkpoint (params/) written by mies_tpu; "
            f"convert it to mies_tpu_torch's format with `python {CONVERTER} "
            f"{p} OUT_DIR` where JAX is installed"
        )
    if not (p / "meta.json").exists() or not (p / PARAMS_FILE).exists():
        raise FileNotFoundError(f"no denoiser checkpoint in {p}")
    return _load(str(p), (p / PARAMS_FILE).stat().st_mtime_ns)


def load_model(path: str | Path, device="cpu") -> nn.Module:
    """The checkpoint's model (bfloat16 compute) in eval mode on
    ``device``."""
    state, features, depth, arch = load_denoiser(path)
    model = build_model(arch, features, depth)
    model.load_state_dict(state)
    return model.to(device).eval()
