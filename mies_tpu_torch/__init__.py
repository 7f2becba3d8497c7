"""mies_tpu_torch — mies_tpu ported to PyTorch and CUDA on NVIDIA Hopper.

The JAX package ``mies_tpu`` is the reference; this package runs the same
configs (``configs/*.yaml``) with plain PyTorch for the tensor code and
hand-written CUDA kernels (``csrc/``, built with nvcc at first use) where
the reference had Pallas TPU kernels. It imports neither jax nor mies_tpu.

Ported so far: the flagship CLAHE -> bilateral -> unsharp chain
(``pipeline.presets.flagship_config``) and the clahe op in its four
conventions (opencv, fraction, skimage, kornia; e.g.
``configs/xray_adapthist_skimage.yaml``). ROADMAP.md lists what follows.

    import torch, mies_tpu_torch
    cfg = mies_tpu_torch.load_config("configs/xray_clahe.yaml")
    out = mies_tpu_torch.compile_pipeline(cfg, batched=True)(x.cuda())
"""

from mies_tpu_torch.pipeline.compiler import compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, StageConfig, load_config

__all__ = ["PipelineConfig", "StageConfig", "load_config", "compile_pipeline"]
