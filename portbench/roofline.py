"""The card's published peaks and the least time a piece of work can take.

NVIDIA H100 SXM (data sheet, at the 700 W limit): 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores. A piece of work takes at
least the larger of its bytes over the bandwidth and its operations over
the float32 rate. Bytes count each input read once and each output
written once; operations are the stage's own count per pixel (the
reference stage files), not what a kernel happens to execute.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_s(nbytes: float, ops: float) -> float:
    """Least seconds for ``nbytes`` moved and ``ops`` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)

