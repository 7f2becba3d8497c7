"""Hand-written CUDA kernels (``csrc/``) for the hot stages, with wrappers.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain PyTorch version only for a CPU tensor; ``_build.LAUNCHES``
counts the launches. Importing the package registers every wrapper a
chain calls as a ``torch.ops.mies`` custom op (``_build.register_op``),
which ``torch.export`` records and ``pipeline.export.load_exported``
resolves.
"""

from mies_tpu_torch.kernels import (  # noqa: F401 (registers the mies ops)
    bilateral,
    clahe,
    clahe3d,
    diffusion,
    fused,
    nlmeans,
    tv,
    unsharp_gauss,
)
from mies_tpu_torch.kernels.bilateral import bilateral_batched
from mies_tpu_torch.kernels.clahe import clahe_apply_lut, clahe_batched

# the reference's names; its clahe_tpu / bilateral_tpu (and their
# *_supported) are the TPU's own entry points: here the batched wrappers
# launch the card's kernels
__all__ = ["bilateral_batched", "clahe_apply_lut", "clahe_batched"]
