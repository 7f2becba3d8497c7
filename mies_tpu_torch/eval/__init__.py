"""Quality evaluation: the full-reference metric suite and the reports
(the port of ``mies_tpu.eval``)."""

from mies_tpu_torch.eval.metrics import (
    METRIC_REGISTRY,
    ergas,
    evaluate,
    evaluate_volume,
    msssim,
    mse,
    psnr,
    psnrb,
    rase,
    rmse,
    sam,
    scc,
    ssim,
    uqi,
    vifp,
)

__all__ = [
    "mse", "rmse", "psnr", "uqi", "ssim", "msssim", "ergas", "scc",
    "rase", "sam", "vifp", "psnrb", "evaluate", "evaluate_volume", "METRIC_REGISTRY",
]
