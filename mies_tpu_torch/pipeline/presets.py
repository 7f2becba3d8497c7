"""Canonical benchmark configs — the same chains as mies_tpu's presets."""

from __future__ import annotations

from mies_tpu_torch.pipeline.config import PipelineConfig


def flagship_config(name: str = "flagship-clahe-denoise-sharpen") -> PipelineConfig:
    """The headline CLAHE + bilateral + unsharp chain (BASELINE w5)."""
    return PipelineConfig.make(
        [
            ("clahe", {"clip_limit": 2.0, "grid_size": (8, 8),
                       "convention": "opencv"}),
            ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                                "sigma_space": 1.5}),
            ("unsharp_mask", {"radius": 1.5, "amount": 1.0}),
        ],
        name=name,
    )


def flagship_volume_config(name: str = "flagship-volume") -> PipelineConfig:
    """The streamed-volume variant (BASELINE w5): HU windowing + the
    flagship chain."""
    return PipelineConfig.make(
        [("window_hu", {"center": 40.0, "width": 400.0})]
        + list(flagship_config().stages),
        name=name,
    )


def latency_config(name: str = "latency-clahe-denoise") -> PipelineConfig:
    """BASELINE metric 2: the batch-1 CLAHE + denoise latency chain."""
    return PipelineConfig.make(
        [
            ("clahe", {"clip_limit": 2.0, "grid_size": (8, 8),
                       "convention": "opencv"}),
            ("bilateral_blur", {"kernel_size": 5, "sigma_color": 0.1,
                                "sigma_space": 1.5}),
        ],
        name=name,
    )
