"""mies_tpu_torch — mies_tpu ported to PyTorch and CUDA on NVIDIA Hopper.

The JAX package ``mies_tpu`` is the reference; this package runs the same
configs (``configs/*.yaml``) with plain PyTorch for the tensor code and
hand-written CUDA kernels (``csrc/``, built with nvcc at first use) where
the reference had Pallas TPU kernels. It imports neither jax nor mies_tpu.

Ported so far: the flagship CLAHE -> bilateral -> unsharp chain
(``pipeline.presets.flagship_config``); the clahe op in its four
conventions (opencv, fraction, skimage, kornia; e.g.
``configs/xray_adapthist_skimage.yaml``); the low-dose CT chain
``configs/ct_lowdose_nlm.yaml`` (window_hu -> NL-means -> TV -> clahe on
int16 Hounsfield units), the ultrasound chain
``configs/ultrasound_despeckle.yaml`` (SRAD -> Lee -> clahe),
Perona-Malik diffusion -> MUSICA, the 1024^2 mammography chains (unsharp
-> gaussian as one kernel; ``configs/mammogram_sharpen.yaml``) and the
volume program ``pipeline.compiler.compile_volume_pipeline``
(``configs/ct_volume_3d.yaml``: window_hu -> clahe3d -> gaussian_blur3d on
a [Z, H, W] volume), the row- and batch-sharded chains of ``parallel`` on
torch.distributed, and the opt-in fused bilateral -> unsharp tail
(``MIES_TPU_FUSE_TAIL=1``); the intensity ops, global equalization
(``equalize_hist``, ``equalize``), median_blur, guided_blur and
morphology, and with them ``configs/histeq_baseline.yaml``,
``configs/ct_soft_tissue.yaml``, ``configs/ct_guided_denoise.yaml`` and
``configs/mammo_microcalc_tophat.yaml``; the frequency, wavelet and ridge
ops, and with them ``configs/xray_homomorphic.yaml``,
``configs/xray_wavelet_denoise.yaml`` and
``configs/angio_vessel_enhance.yaml``: every shipped config loads.
ROADMAP.md lists what follows.

    import torch, mies_tpu_torch
    cfg = mies_tpu_torch.load_config("configs/ct_lowdose_nlm.yaml")
    out = mies_tpu_torch.compile_pipeline(cfg, batched=True)(hu)  # on the card
    ref = mies_tpu_torch.compile_pipeline(cfg, batched=True, device="cpu")(hu)

``compile_pipeline`` runs on the card unless asked otherwise: it moves its
input (a tensor or a numpy array) to ``device`` ("cuda" by default, where
the kernels launch) and raises where there is no card; ``device="cpu"``
runs the plain PyTorch versions.
"""

import torch

__version__ = "0.1.0"  # the reference's

# float32 stays float32 on the card: no TF32 in cuBLAS or cuDNN (the
# reference's ops run at full f32 precision; cuFFT has no TF32 mode)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mies_tpu_torch.pipeline.compiler import compile_pipeline  # noqa: E402
from mies_tpu_torch.pipeline.config import (  # noqa: E402
    PipelineConfig,
    StageConfig,
    load_config,
)

__all__ = ["PipelineConfig", "StageConfig", "load_config", "compile_pipeline",
           "__version__"]
