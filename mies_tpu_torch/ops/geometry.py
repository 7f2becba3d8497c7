"""Geometry-family ops, plain PyTorch: the kornia mean/std normalization
pair of ``mies_tpu.ops.geometry``.

Both are pointwise, so they take any shape: a [..., H, W] batch in the 2-D
chains, a [Z, H, W] volume in the volume program. The divide is a true
division (a 0-d tensor divisor: CUDA torch multiplies by the reciprocal of
a Python scalar), as the reference's eager op divides.
"""

from __future__ import annotations

import torch

from mies_tpu_torch.ops.histogram import _const


def normalize_meanstd(img: torch.Tensor, mean: float = 0.5,
                      std: float = 0.5) -> torch.Tensor:
    """kornia.enhance.normalize semantics: ``(x - mean) / std``."""
    return (img - mean) / _const(img, std)


def denormalize_meanstd(img: torch.Tensor, mean: float = 0.5,
                        std: float = 0.5) -> torch.Tensor:
    """Inverse of normalize_meanstd: ``x * std + mean``."""
    return img * std + mean
