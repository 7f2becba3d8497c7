"""Cross-cutting utilities: profiling and tracing, the kernel build cache."""

from mies_tpu_torch.utils.profiling import (
    device_sync,
    enable_compilation_cache,
    stage_costs,
    strict_numerics,
    time_fn,
    trace,
)

__all__ = [
    "device_sync",
    "time_fn",
    "trace",
    "stage_costs",
    "strict_numerics",
    "enable_compilation_cache",
]
