"""Learned enhancement stages: the port of ``mies_tpu.models``.

Two residual model families, a DnCNN-style CNN and a U-Net
(``build_model``'s registry), as ``nn.Module``s on NCHW with float32
parameters and bfloat16 compute; trained with AdamW (noise2clean or
Noise2Void, optionally data-parallel over torch.distributed); saved as a
state dict beside the reference's meta.json; run by the pipeline's
``learned_denoise`` stage. ``convert`` carries weights from and to the
reference's flax trees.
"""

from mies_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from mies_tpu_torch.models.denoiser import (
    DenoiserCNN,
    build_model,
    denoise,
    load_denoiser,
)
from mies_tpu_torch.models.train import TrainState, make_train_step, train_denoiser
from mies_tpu_torch.models.unet import UNetDenoiser

__all__ = [
    "DenoiserCNN",
    "UNetDenoiser",
    "build_model",
    "denoise",
    "load_denoiser",
    "TrainState",
    "make_train_step",
    "train_denoiser",
    "flax_to_torch",
    "torch_to_flax",
]
