"""Intensity ops, plain PyTorch: CT Hounsfield-unit windowing.

Same semantics and f32 operation order as ``mies_tpu.ops.intensity``.
"""

from __future__ import annotations

import torch

# Standard clinical CT windows (center, width) in Hounsfield units.
HU_PRESETS: dict[str, tuple[float, float]] = {
    "soft_tissue": (40.0, 400.0),
    "lung": (-600.0, 1500.0),
    "bone": (400.0, 1800.0),
    "brain": (40.0, 80.0),
    "liver": (60.0, 160.0),
    "mediastinum": (50.0, 350.0),
    "stroke": (40.0, 40.0),
    "subdural": (75.0, 215.0),
    "abdomen": (50.0, 400.0),
}


def window_hu(
    hu: torch.Tensor,
    center: float | None = None,
    width: float | None = None,
    preset: str | None = None,
) -> torch.Tensor:
    """CT Hounsfield-unit windowing to float [0, 1]:
    ``clip((hu - (center - width/2)) / width, 0, 1)`` in float32.

    ``preset`` names a standard clinical window (``HU_PRESETS``); explicit
    center/width override the preset's. int16 or float input.
    """
    if preset is not None:
        if preset not in HU_PRESETS:
            raise ValueError(
                f"unknown HU preset {preset!r}; available: "
                f"{sorted(HU_PRESETS)}"
            )
        pc, pw = HU_PRESETS[preset]
        center = pc if center is None else center
        width = pw if width is None else width
    if center is None or width is None:
        raise ValueError("window_hu needs center+width or a preset")
    x = hu.to(torch.float32)
    lo = float(center) - float(width) / 2.0
    # a tensor divisor: CUDA torch divides by a Python scalar as a multiply
    # by its reciprocal, which is not the reference's true division
    return torch.clamp((x - lo) / x.new_full((), float(width)), 0.0, 1.0)
