"""Hand-written CUDA kernels (``csrc/``) for the hot stages, with wrappers.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain PyTorch version only for a CPU tensor; ``_build.LAUNCHES``
counts the launches.
"""
