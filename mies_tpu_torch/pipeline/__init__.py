"""Declarative pipeline: config schema -> one eager PyTorch chain."""

from mies_tpu_torch.pipeline.compiler import OP_REGISTRY, compile_pipeline
from mies_tpu_torch.pipeline.config import PipelineConfig, StageConfig, load_config
from mies_tpu_torch.pipeline.export import (
    export_pipeline,
    load_exported,
    read_export_header,
)

__all__ = [
    "PipelineConfig",
    "StageConfig",
    "load_config",
    "compile_pipeline",
    "OP_REGISTRY",
    "export_pipeline",
    "load_exported",
    "read_export_header",
]
