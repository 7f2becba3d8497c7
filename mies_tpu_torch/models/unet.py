"""U-Net residual denoiser: the second learned model family.

The port of ``mies_tpu.models.unet``. Same contract as ``DenoiserCNN``
(predicts the noise residual of a [N, 1, H, W] image), with an
encoder-decoder and skip connections: a stride-2 3x3 convolution down per
level (flax 'SAME' on an even extent: a pad of (0, 1)), nearest x2 upsampling
by repetition and a crop, a 3x3 convolution, then the skip concatenated
after it on channels ([h, skip]). The two bottleneck convolutions run under
activation checkpointing while training. The forward reflect-pads H and W
(numpy 'reflect', any length) to a multiple of 2**levels and crops the
noise back, so any slice shape runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mies_tpu_torch.models.denoiser import Conv3x3, remat
from mies_tpu_torch.ops.histogram import _pad_reflect


def _pad_to_multiple(x: torch.Tensor, m: int) -> tuple[torch.Tensor, int, int]:
    """Reflect-pad [..., H, W] at the bottom and right so H and W divide
    ``m``."""
    h, w = x.shape[-2:]
    return _pad_reflect(x, (0, (-h) % m), (0, (-w) % m)), h, w


class ConvBlock(nn.Module):
    """conv-relu-conv-relu."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv3x3(cin, cout, dtype=dtype)
        self.conv2 = Conv3x3(cout, cout, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(h))))


class UNetDenoiser(nn.Module):
    """``features`` is the stem width (doubled per level); ``levels`` the
    number of stride-2 downsamplings."""

    def __init__(self, features: int = 24, levels: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.levels, self.dtype = features, levels, dtype
        f = [features * 2 ** lvl for lvl in range(levels + 1)]
        self.enc = nn.ModuleList(
            ConvBlock(1 if lvl == 0 else f[lvl], f[lvl], dtype)
            for lvl in range(levels))
        self.down = nn.ModuleList(
            Conv3x3(f[lvl], f[lvl + 1], stride=2, dtype=dtype)
            for lvl in range(levels))
        self.mid = ConvBlock(f[levels], f[levels], dtype)
        # the decoder in the order it runs: the deepest level first
        self.up = nn.ModuleList(
            Conv3x3(f[lvl + 1], f[lvl], dtype=dtype)
            for lvl in reversed(range(levels)))
        self.dec = nn.ModuleList(
            ConvBlock(2 * f[lvl], f[lvl], dtype)
            for lvl in reversed(range(levels)))
        self.out = Conv3x3(f[0], 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, h0, w0 = _pad_to_multiple(x.to(self.dtype), 2 ** self.levels)
        skips = []
        for enc, down in zip(self.enc, self.down):
            h = enc(h)
            skips.append(h)
            h = F.relu(down(h))
        h = remat(self.mid, h, self.training)
        for up, dec, skip in zip(self.up, self.dec, reversed(skips)):
            nh, nw = skip.shape[-2:]
            h = h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            h = F.relu(up(h[..., :nh, :nw]))
            h = dec(torch.cat([h, skip], dim=1))
        return self.out(h)[..., :h0, :w0].to(torch.float32)
