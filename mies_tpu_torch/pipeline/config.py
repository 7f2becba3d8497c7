"""Config schema for the declarative enhancement pipeline.

The same schema and the same YAML/JSON files as ``mies_tpu.pipeline.config``
(``configs/*.yaml``, ``PipelineConfig.to_dict()``): a config is frozen,
hashable data. ``validate`` checks every stage against the port's own op
registry (the reference's 99 ops), function signatures and value rules,
so a bad config fails at load time with the stage named.

Schema (YAML/JSON):

    name: chest-xray-clahe
    pipeline:
      - op: clahe
        clip_limit: 2.0
        grid_size: [8, 8]
        convention: opencv
      - op: bilateral_blur
        kernel_size: 5
        sigma_color: 0.1
        sigma_space: 1.5
      - op: unsharp_mask
        radius: 1.5
        amount: 1.0
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Mapping, Sequence

from mies_tpu_torch.ops.intensity import HU_PRESETS


def _freeze(v: Any) -> Any:
    """Recursively convert JSON-ish values to hashable equivalents."""
    if isinstance(v, Mapping):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _thaw(v: Any) -> Any:
    """Inverse of _freeze for param dicts (tuples stay tuples)."""
    if isinstance(v, tuple) and v and all(
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str) for x in v
    ):
        return {k: _thaw(x) for k, x in v}
    return v


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One pipeline stage: op name + frozen (hashable) params."""

    op: str
    params: tuple = ()  # frozen key/value tuple, see _freeze

    @classmethod
    def make(cls, op: str, **params: Any) -> "StageConfig":
        return cls(op=op, params=_freeze(params))

    def kwargs(self) -> dict[str, Any]:
        out = {}
        for k, v in self.params:
            out[k] = _thaw(v)
        return out


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """A full pipeline: ordered stages + io/eval metadata."""

    stages: tuple[StageConfig, ...]
    name: str = "pipeline"
    io: tuple = ()
    eval: tuple = ()

    @classmethod
    def make(
        cls,
        stages: Sequence[tuple[str, dict[str, Any]] | StageConfig],
        name: str = "pipeline",
        io: Mapping[str, Any] | None = None,
        eval: Mapping[str, Any] | None = None,
    ) -> "PipelineConfig":
        built = []
        for s in stages:
            if isinstance(s, StageConfig):
                built.append(s)
            else:
                op, params = s
                built.append(StageConfig.make(op, **params))
        return cls(
            stages=tuple(built),
            name=name,
            io=_freeze(dict(io or {})),
            eval=_freeze(dict(eval or {})),
        )

    def io_dict(self) -> dict[str, Any]:
        return {k: _thaw(v) for k, v in self.io}

    def eval_dict(self) -> dict[str, Any]:
        return {k: _thaw(v) for k, v in self.eval}

    def cache_key(self) -> str:
        """Stable content hash — names a config in run records."""
        payload = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()[:16]

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "pipeline": [{"op": s.op, **s.kwargs()} for s in self.stages],
            "io": self.io_dict(),
            "eval": self.eval_dict(),
        }

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2) + "\n")


def from_dict(d: Mapping[str, Any]) -> PipelineConfig:
    stages = []
    for entry in d.get("pipeline", []):
        entry = dict(entry)
        op = entry.pop("op")
        # YAML lists -> tuples for hashability (grid_size etc.)
        stages.append((op, entry))
    return PipelineConfig.make(
        stages,
        name=d.get("name", "pipeline"),
        io=d.get("io"),
        eval=d.get("eval"),
    )


def load_config(path: str | Path) -> PipelineConfig:
    """Load a pipeline config from a .json / .yaml / .yml file."""
    path = Path(path)
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        import yaml

        d = yaml.safe_load(text)
    else:
        d = json.loads(text)
    if not isinstance(d, Mapping):
        raise ValueError(f"config root must be a mapping: {path}")
    cfg = from_dict(d)
    validate(cfg)
    return cfg


# --- load-time value validation ---------------------------------------------
# Each rule: param -> (predicate, human description of the constraint).
# Predicates run on the RAW config value, so bad types and bad ranges both
# fail at load_config with the stage named: the reference's rules for every
# ported op.

_PAD_MODES = ("nearest", "reflect", "edge", "mirror", "constant", "wrap")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _pos(v) -> bool:
    return _is_num(v) and v > 0


def _nonneg(v) -> bool:
    return _is_num(v) and v >= 0


def _odd_kernel(v) -> bool:
    return _is_int(v) and v >= 1 and v % 2 == 1


def _pos_int(v) -> bool:
    return _is_int(v) and v >= 1


def _int_pair(n):
    def check(v) -> bool:
        return (
            isinstance(v, (tuple, list))
            and len(v) == n
            and all(_pos_int(x) for x in v)
        )

    return check


def _mode_ok(v) -> bool:
    return v in _PAD_MODES


def _num_pair(v) -> bool:
    return (
        isinstance(v, (tuple, list)) and len(v) == 2 and all(_is_num(x) for x in v)
    )


def _hu_preset_ok(v) -> bool:
    return v is None or (isinstance(v, str) and v in HU_PRESETS)


_BUTTERWORTH_RULES = {
    "cutoff_frequency_ratio": (
        lambda v: _is_num(v) and 0.0 < v <= 0.5,
        "a number in (0, 0.5] (fraction of the sampling rate)",
    ),
    "high_pass": (lambda v: isinstance(v, bool), "a bool"),
    "order": (_pos, "a number > 0"),
    "squared_butterworth": (lambda v: isinstance(v, bool), "a bool"),
    "npad": (lambda v: _is_int(v) and v >= 0, "an int >= 0"),
}
_HOMOMORPHIC_RULES = {
    "cutoff_frequency_ratio": (
        lambda v: _is_num(v) and 0.0 < v <= 0.5,
        "a number in (0, 0.5] (fraction of the sampling rate)",
    ),
    "order": (_pos, "a number > 0"),
    "low_gain": (_pos, "a number > 0"),
    "high_gain": (_pos, "a number > 0"),
    "eps": (_pos, "a number > 0"),
    "npad": (lambda v: _is_int(v) and v >= 0, "an int >= 0"),
}


def _sigmas_ok(v) -> bool:
    return (isinstance(v, (tuple, list)) and len(v) >= 1
            and all(_pos(x) for x in v))


_SIGMAS = (_sigmas_ok, "a non-empty list of numbers > 0")
_MODE = (_mode_ok, f"one of {_PAD_MODES}")
_DOG_RULES = {
    "low_sigma": (_pos, "a number > 0"),
    "high_sigma": (lambda v: v is None or _pos(v),
                   "a number > 0 (or omitted: 1.6 * low_sigma)"),
    "truncate": (_pos, "a number > 0"),
    "mode": _MODE,
}
_WIENER_RULES = {
    "psf_sigma": (_pos, "a number > 0"),
    "psf_size": (_odd_kernel, "an odd int >= 1"),
    "balance": (_pos, "a number > 0"),
    "clip": (lambda v: isinstance(v, bool), "a bool"),
}
_BLACK_RIDGES = (lambda v: isinstance(v, bool), "a bool")
_GAMMA_OR_NONE = (lambda v: v is None or _pos(v),
                  "a number > 0 (or omitted: per-scale half-max norm)")
_WAVELET_RULES = {
    "sigma": (lambda v: v is None or _pos(v),
              "a number > 0 (or omitted: MAD estimate in-graph)"),
    "wavelet": (
        lambda v: isinstance(v, str),
        "a wavelet name (haar/db1..db4/sym4)",
    ),
    "mode": (lambda v: v in ("soft", "hard"), "'soft' or 'hard'"),
    "wavelet_levels": (
        lambda v: v is None or _pos_int(v),
        "an int >= 1 (or omitted: skimage default max-3)",
    ),
    "method": (
        lambda v: v in ("BayesShrink", "VisuShrink"),
        "'BayesShrink' or 'VisuShrink'",
    ),
}

_FRANGI_RULES = {
    "sigmas": _SIGMAS,
    "alpha": (_pos, "a number > 0"),
    "beta": (_pos, "a number > 0"),
    "gamma": _GAMMA_OR_NONE,
    "black_ridges": _BLACK_RIDGES,
    "mode": _MODE,
}
_VESSEL_RULES = {**_FRANGI_RULES, "amount": (_nonneg, "a number >= 0")}
_HESSIAN_RULES = {
    **_FRANGI_RULES,
    "gamma": (_pos, "a number > 0 (skimage default 15)"),
}
_SATO_RULES = {"sigmas": _SIGMAS, "black_ridges": _BLACK_RIDGES,
               "mode": _MODE}
_MEIJERING_RULES = {
    "sigmas": _SIGMAS,
    "alpha": (lambda v: v is None or _pos(v),
              "a number > 0 (or omitted: 1/(ndim + 1))"),
    "black_ridges": _BLACK_RIDGES,
    "mode": _MODE,
}
_NLM_RULES = {
    "patch_size": (_pos_int, "an int >= 1"),
    "patch_distance": (_pos_int, "an int >= 1"),
    "h": (_pos, "a number > 0"),
    "sigma": (_nonneg, "a number >= 0"),
}
_TV_RULES = {
    "weight": (_pos, "a number > 0"),
    "eps": (_nonneg, "a number >= 0"),
    "max_num_iter": (_pos_int, "an int >= 1"),
}
_SRAD_RULES = {
    "niter": (_pos_int, "an int >= 1"),
    "dt": (lambda v: _is_num(v) and 0.0 < v <= 0.25,
           "a number in (0, 0.25] (step size)"),
    "q0": (_pos, "a number > 0 (speckle scale at t=0)"),
    "rho": (_nonneg, "a number >= 0 (q0 decay rate)"),
    "eps": (_pos, "a number > 0"),
}
_PM_RULES = {
    "niter": (_pos_int, "an int >= 1"),
    "kappa": (_pos, "a number > 0 (gradient scale, intensity units)"),
    "gamma": (_pos, "a number > 0 (step size; stability <= 1/4)"),
    "option": (lambda v: v in (1, 2),
               "1 (exponential conduction) or 2 (inverse quadratic)"),
}
_GUIDED_RULES = {
    "kernel_size": (_odd_kernel, "an odd int >= 1"),
    "eps": (_pos, "a number > 0"),
    "mode": _MODE,
}
_MEDIAN_RULES = {"kernel_size": (_odd_kernel, "an odd int >= 1"),
                 "mode": _MODE}
_UNSHARP_RULES = {
    "radius": (_pos, "a number > 0"),
    "amount": (_nonneg, "a number >= 0"),
    "mode": _MODE,
}
_MORPH3D_RULES = {
    "kernel_size": (_odd_kernel, "an odd int >= 1"),
    "mode": (
        lambda v: v == "ignore" or _mode_ok(v),
        f"'ignore' or one of {_PAD_MODES}",
    ),
}

_WARP_MODE = (lambda v: v in ("constant", "nearest"),
              "one of 'constant', 'nearest'")
_GABOR_RULES = {
    "frequency": (_pos, "a number > 0 (cycles/pixel)"),
    "bandwidth": (_pos, "a number > 0"),
    "sigma_x": (lambda v: v is None or _pos(v),
                "a number > 0 (or omitted: derived from bandwidth)"),
    "sigma_y": (lambda v: v is None or _pos(v),
                "a number > 0 (or omitted: derived from bandwidth)"),
    "n_stds": (_pos_int, "an int >= 1"),
    "offset": (_is_num, "a number (radians)"),
    "mode": _MODE,
}

_VALUE_RULES: dict[str, dict[str, tuple]] = {
    "box_blur": {"kernel_size": (_odd_kernel, "an odd int >= 1"),
                 "mode": _MODE},
    "denoise_bilateral": {
        "sigma_color": (_pos, "a number > 0"),
        "sigma_spatial": (_pos, "a number > 0"),
        "mode": _MODE,
    },
    "difference_of_gaussians": _DOG_RULES,
    "gabor": {
        **_GABOR_RULES,
        "theta": (_is_num, "a number (radians)"),
        "output": (lambda v: v in ("magnitude", "real", "imag"),
                   "one of ('magnitude', 'real', 'imag')"),
    },
    "gabor_bank": {
        **_GABOR_RULES,
        "n_orientations": (_pos_int, "an int >= 1"),
        "output": (lambda v: v in ("max", "mean"), "one of ('max', 'mean')"),
    },
    "kuwahara": {
        "kernel_size": (lambda v: _odd_kernel(v) and v >= 3,
                        "an odd int >= 3"),
        "mode": _MODE,
    },
    "retinex": {
        "sigmas": _SIGMAS,
        "weights": (
            lambda v: v is None or (
                isinstance(v, (tuple, list)) and len(v) >= 1
                and all(_is_num(x) for x in v)
            ),
            "a list of numbers matching sigmas (or omitted: uniform)",
        ),
        "eps": (_pos, "a number > 0"),
        "gain": (_pos, "a number > 0"),
        "rescale": (lambda v: v in ("clip", "minmax"),
                    "'clip' (local) or 'minmax' (global stretch)"),
        "mode": _MODE,
        "truncate": (_pos, "a number > 0"),
    },
    "subtract_background": {
        "radius": (_pos, "a number > 0 (ball radius, pixels)"),
        "intensity": (
            lambda v: v is None or _pos(v),
            "a number > 0 (ball height, intensity units; or omitted: "
            "radius/255, the ImageJ 8-bit equivalence)",
        ),
        "light_background": (lambda v: isinstance(v, bool), "a bool"),
        "downscale": (
            lambda v: v == "auto" or (
                _is_int(v) and v >= 1 and v & (v - 1) == 0
            ),
            "'auto' (ImageJ's shrink schedule) or a power-of-two "
            "int >= 1",
        ),
    },
    "richardson_lucy": {
        "psf_sigma": (_pos, "a number > 0"),
        "psf_size": (_odd_kernel, "an odd int >= 1"),
        "num_iter": (_pos_int, "an int >= 1"),
        "clip": (lambda v: isinstance(v, bool), "a bool"),
        "filter_epsilon": (
            lambda v: v is None or _pos(v), "a number > 0 (or omitted)"
        ),
    },
    **{_m: {"mode": _MODE} for _m in (
        "sobel_edges", "scharr_edges", "prewitt_edges", "farid_edges",
        "roberts_edges", "laplace")},
    "laplacian_sharpen": {
        "alpha": (_nonneg, "a number >= 0"),
        "mode": _MODE,
    },
    "resize": {
        "height": (_pos_int, "an int >= 1"),
        "width": (_pos_int, "an int >= 1"),
        "method": (
            lambda v: v in ("nearest", "bilinear", "bicubic", "lanczos3",
                            "lanczos5"),
            "a jax.image.resize method",
        ),
    },
    "center_crop": {
        "height": (_pos_int, "an int >= 1"),
        "width": (_pos_int, "an int >= 1"),
    },
    "rot90": {"k": (_is_int, "an int")},
    "rotate": {
        "angle": (_is_num, "a number (degrees)"),
        "mode": _WARP_MODE,
        "cval": (_is_num, "a number"),
    },
    "affine_warp": {
        "matrix": (
            lambda v: (
                isinstance(v, (tuple, list))
                and len(v) == 2
                and all(_num_pair(r) for r in v)
            ),
            "a 2x2 matrix (output->input map)",
        ),
        "offset": (_num_pair, "a 2-vector"),
        "mode": _WARP_MODE,
        "cval": (_is_num, "a number"),
    },
    "perspective_warp": {
        "matrix": (
            lambda v: (
                isinstance(v, (tuple, list))
                and len(v) == 3
                and all(
                    isinstance(r, (tuple, list)) and len(r) == 3
                    and all(_is_num(x) for x in r)
                    for r in v
                )
            ),
            "a 3x3 homography (output->input, homogeneous (row, col, 1))",
        ),
        "mode": _WARP_MODE,
        "cval": (_is_num, "a number"),
    },
    "motion_blur": {
        "kernel_size": (
            lambda v: _is_int(v) and v >= 3 and v % 2 == 1,
            "an odd int >= 3",
        ),
        "angle": (_is_num, "a number (degrees)"),
        "direction": (
            lambda v: _is_num(v) and -1.0 <= v <= 1.0,
            "a number in [-1, 1]",
        ),
        "mode": _MODE,
    },
    "canny": {
        "sigma": (_pos, "a number > 0"),
        "low_threshold": (
            lambda v: v is None or (_is_num(v) and v >= 0),
            "a number >= 0 (or omitted: 0.1)",
        ),
        "high_threshold": (
            lambda v: v is None or (_is_num(v) and v >= 0),
            "a number >= 0 (or omitted: 0.2)",
        ),
        "use_quantiles": (lambda v: isinstance(v, bool), "a bool"),
        "mode": _MODE,
    },
    "learned_denoise": {
        "checkpoint": (lambda v: isinstance(v, str) and v, "a checkpoint path")
    },
    "histogram_match": {
        "reference": (
            lambda v: isinstance(v, str) and v,
            "a reference image path",
        )
    },
    "butterworth": _BUTTERWORTH_RULES,
    "butterworth3d": _BUTTERWORTH_RULES,
    "homomorphic": _HOMOMORPHIC_RULES,
    "homomorphic3d": _HOMOMORPHIC_RULES,
    "frangi3d": _FRANGI_RULES,
    "vessel_enhance3d": _VESSEL_RULES,
    "hessian3d": _HESSIAN_RULES,
    "sato3d": _SATO_RULES,
    "meijering3d": _MEIJERING_RULES,
    "denoise_wavelet3d": _WAVELET_RULES,
    "difference_of_gaussians3d": _DOG_RULES,
    "wiener": _WIENER_RULES,
    "wiener3d": _WIENER_RULES,
    "normalize_meanstd": {
        "mean": (_is_num, "a number"),
        "std": (lambda v: _is_num(v) and v != 0, "a nonzero number"),
    },
    "denormalize_meanstd": {
        "mean": (_is_num, "a number"),
        "std": (_is_num, "a number"),
    },
    "guided_blur3d": _GUIDED_RULES,
    "median_blur3d": _MEDIAN_RULES,
    "unsharp_mask3d": _UNSHARP_RULES,
    **{_m: _MORPH3D_RULES for _m in (
        "erode3d", "dilate3d", "morph_open3d", "morph_close3d",
        "morph_gradient3d", "top_hat3d", "black_hat3d")},
    "resample3d": {
        "depth": (_pos_int, "an int >= 1"),
        "height": (_pos_int, "an int >= 1"),
        "width": (_pos_int, "an int >= 1"),
    },
    "denoise_nl_means3d": _NLM_RULES,
    "denoise_tv3d": _TV_RULES,
    "srad3d": _SRAD_RULES,
    "anisotropic_diffusion3d": {
        **_PM_RULES,
        "gamma": (_pos, "a number > 0 (step size; stability <= 1/6)"),
        "voxelspacing": (
            lambda v: v is None or (
                isinstance(v, (tuple, list)) and len(v) == 3
                and all(_pos(x) for x in v)
            ),
            "3 positive numbers (dz, dy, dx) or omitted",
        ),
    },
    "frangi": _FRANGI_RULES,
    "hessian": _HESSIAN_RULES,
    "vessel_enhance": _VESSEL_RULES,
    "sato": _SATO_RULES,
    "meijering": _MEIJERING_RULES,
    "denoise_wavelet": _WAVELET_RULES,
    "cycle_spin": {
        "max_shifts": (
            lambda v: isinstance(v, int) and not isinstance(v, bool)
            and v >= 0,
            "an int >= 0",
        ),
        "shift_steps": (_pos_int, "an int >= 1"),
        **_WAVELET_RULES,
    },
    "adjust_gamma": {
        "gamma": (_pos, "a number > 0"),
        "gain": (_pos, "a number > 0"),
    },
    "adjust_log": {"gain": (_pos, "a number > 0")},
    "adjust_sigmoid": {
        "cutoff": (_is_num, "a number"),
        "gain": (_is_num, "a number"),
    },
    "adjust_brightness": {"factor": (_is_num, "a number")},
    "adjust_contrast": {"factor": (_nonneg, "a number >= 0")},
    "solarize": {
        "threshold": (lambda v: _is_num(v) and 0.0 <= v <= 1.0, "in [0, 1]")
    },
    "posterize": {
        "bits": (lambda v: _is_int(v) and 1 <= v <= 8, "an int in [1, 8]")
    },
    "sharpness": {"factor": (_is_num, "a number")},
    "normalize": {"eps": (_pos, "a number > 0")},
    "rescale_intensity": {
        "in_range": (lambda v: v is None or _num_pair(v), "a (lo, hi) pair"),
        "out_range": (_num_pair, "a (lo, hi) pair"),
    },
    "equalize_hist": {
        "nbins": (lambda v: _is_int(v) and v >= 2, "an int >= 2")
    },
    "clahe": {
        "clip_limit": (_pos, "a number > 0"),
        "grid_size": (_int_pair(2), "a pair of ints >= 1"),
        "convention": (
            lambda v: v in ("opencv", "skimage", "fraction", "kornia"),
            "one of 'opencv', 'skimage', 'fraction', 'kornia'",
        ),
        # nbins != 256 is skimage-only; the op rejects other
        # conventions at build time with the reason
        "nbins": (lambda v: _is_int(v) and v >= 2, "an int >= 2"),
        "kernel_size": (
            lambda v: v is None or _int_pair(2)(v),
            "a pair of ints >= 1 (or omitted)",
        ),
    },
    "clahe3d": {
        "clip_limit": (_pos, "a number > 0"),
        "grid_size": (_int_pair(3), "a triple of ints >= 1"),
        "convention": (
            lambda v: v in ("opencv", "skimage", "fraction"),
            "one of 'opencv', 'skimage', 'fraction'",
        ),
        "kernel_size": (
            lambda v: v is None or _int_pair(3)(v),
            "a triple of ints >= 1 (or omitted)",
        ),
    },
    "gaussian_blur": {
        "sigma": (_pos, "a number > 0"),
        "truncate": (_pos, "a number > 0"),
        "mode": (_mode_ok, f"one of {_PAD_MODES}"),
    },
    "gaussian_blur3d": {
        "sigma": (_pos, "a number > 0"),
        "truncate": (_pos, "a number > 0"),
        "mode": (_mode_ok, f"one of {_PAD_MODES}"),
    },
    "unsharp_mask": _UNSHARP_RULES,
    "median_blur": _MEDIAN_RULES,
    "bilateral_blur": {
        "kernel_size": (_odd_kernel, "an odd int >= 1"),
        "sigma_color": (_pos, "a number > 0"),
        "sigma_space": (_pos, "a number > 0"),
        "mode": (_mode_ok, f"one of {_PAD_MODES}"),
    },
    "guided_blur": _GUIDED_RULES,
    **{
        _m: {
            "kernel_size": (_odd_kernel, "an odd int >= 1"),
            "shape": (
                lambda v: v in ("rect", "ellipse", "cross"),
                "one of ('rect', 'ellipse', 'cross')",
            ),
            # 'ignore' = cv2's default morphology border (outside the
            # image never wins the min/max)
            "mode": (
                lambda v: v == "ignore" or _mode_ok(v),
                f"'ignore' or one of {_PAD_MODES}",
            ),
        }
        for _m in (
            "erode", "dilate", "morph_open", "morph_close",
            "morph_gradient", "top_hat", "black_hat",
        )
    },
    "window_hu": {
        "center": (lambda v: v is None or _is_num(v), "a number"),
        "width": (lambda v: v is None or _pos(v), "a number > 0"),
        "preset": (
            _hu_preset_ok,
            "a named clinical window (see mies_tpu_torch.ops.intensity"
            ".HU_PRESETS)",
        ),
    },
    "denoise_nl_means": _NLM_RULES,
    "denoise_tv": _TV_RULES,
    "srad": _SRAD_RULES,
    "lee_filter": {
        "kernel_size": (lambda v: _odd_kernel(v) and v >= 3,
                        "an odd int >= 3"),
        "sigma": (lambda v: v is None or _pos(v),
                  "a number > 0 (noise STD; or omitted: each image's "
                  "mean local variance)"),
        "mode": (_mode_ok, f"one of {_PAD_MODES}"),
    },
    "anisotropic_diffusion": _PM_RULES,
    "musica": {
        "levels": (_pos_int, "an int >= 1"),
        "p": (lambda v: _is_num(v) and 0.0 < v <= 1.0,
              "a number in (0, 1] (band compression exponent)"),
        "gain": (
            lambda v: _pos(v) or (
                isinstance(v, (tuple, list)) and len(v) >= 1
                and all(_pos(x) for x in v)
            ),
            "a number > 0 or a list of numbers > 0 (one per level)",
        ),
        "m": (_pos, "a number > 0 (amplitude bound; 1.0 for [0,1] input)"),
        "clip": (lambda v: isinstance(v, bool), "a bool"),
    },
}


def validate(cfg: PipelineConfig) -> None:
    """Check ops exist in the port, params are accepted, AND values are
    sane — fail at load_config with the stage named."""
    import inspect

    from mies_tpu_torch.pipeline.compiler import OP_REGISTRY

    ch = cfg.io_dict().get("channels")
    if ch not in (None, "gray", "per-channel"):
        raise ValueError(
            f"io.channels={ch!r} is invalid — expected 'gray' (explicit "
            f"luminance collapse) or 'per-channel'"
        )
    for i, s in enumerate(cfg.stages):
        if s.op not in OP_REGISTRY:
            raise ValueError(
                f"stage {i}: unknown op {s.op!r}; available: "
                f"{sorted(OP_REGISTRY)}"
            )
        sig = inspect.signature(OP_REGISTRY[s.op])
        rules = _VALUE_RULES.get(s.op, {})
        for k, v in s.kwargs().items():
            if k not in sig.parameters:
                raise ValueError(
                    f"op {s.op!r} does not accept param {k!r}; "
                    f"accepted: {[p for p in sig.parameters if p != 'img']}"
                )
            rule = rules.get(k)
            if rule is not None:
                check, want = rule
                if not check(v):
                    raise ValueError(
                        f"stage {i} ({s.op!r}): param {k}={v!r} is invalid — "
                        f"expected {want}"
                    )
