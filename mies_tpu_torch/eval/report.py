"""Visual and structured reports: a copy of ``mies_tpu.eval.report``.

Before/after panels with histograms (matplotlib, imported only where a
panel is drawn: the card's machine need not have it), plus a
machine-readable JSON run report {config hash, timings, quality metrics}.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


def reference_u8(input_path, cfg) -> np.ndarray:
    """The uint8 'original' an enhanced output should be scored against.

    float/uint8 sources: the loaded image on the 0..255 scale. int16 HU
    (single-file DICOM): raw HU vs [0,1] output is meaningless, so the
    clinically meaningful original is the SAME window the chain applies
    (its ``window_hu`` stage; 1st..99th percentile if the chain has
    none). The CLI's --report and --run-report score against it.
    """
    import torch

    from mies_tpu_torch.io.image import from_float, load_image

    raw = load_image(
        input_path, dtype="raw", channels=cfg.io_dict().get("channels")
    )
    if raw.dtype == np.int16:
        from mies_tpu_torch.ops.intensity import window_hu

        wstage = next(
            (s for s in cfg.stages if s.op == "window_hu"), None
        )
        if wstage is not None:
            return from_float(window_hu(torch.from_numpy(raw),
                                        **wstage.kwargs()).numpy())
        lo, hi = np.percentile(raw, (1.0, 99.0))
        return from_float(
            np.clip(
                (raw.astype(np.float32) - lo) / max(hi - lo, 1e-6), 0.0, 1.0
            )
        )
    return from_float(
        load_image(input_path, channels=cfg.io_dict().get("channels"))
    )


def save_comparison_report(
    original: np.ndarray,
    enhanced: np.ndarray,
    path: str | Path,
    title: str = "enhancement report",
    metrics: dict | None = None,
) -> None:
    """Side-by-side panels + intensity histograms -> one PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def display_form(img):
        """uint8 -> (img, 0..255); float -> (img, 0..1); signed ints
        (raw HU) -> percentile-windowed [0, 1] so the panel shows
        anatomy instead of clipping everything to white."""
        img = np.asarray(img)
        if img.dtype == np.uint8:
            return img, (0, 255)
        if np.issubdtype(img.dtype, np.signedinteger):
            lo, hi = np.percentile(img, (1.0, 99.0))
            img = np.clip(
                (img.astype(np.float32) - lo) / max(hi - lo, 1e-6), 0.0, 1.0
            )
        return img, (0.0, 1.0)

    fig, axes = plt.subplots(2, 2, figsize=(10, 9))
    for ax, img, name in (
        (axes[0, 0], original, "original"),
        (axes[0, 1], enhanced, "enhanced"),
    ):
        disp, rng = display_form(img)
        ax.imshow(disp, cmap="gray", vmin=rng[0], vmax=rng[1])
        ax.set_title(name)
        ax.axis("off")
    for ax, img, name in (
        (axes[1, 0], original, "original histogram"),
        (axes[1, 1], enhanced, "enhanced histogram"),
    ):
        disp, rng = display_form(img)
        ax.hist(disp.ravel(), bins=64, range=rng, color="#444")
        ax.set_title(name)
    sup = title
    if metrics:
        sup += "  |  " + "  ".join(f"{k}={v:.4g}" for k, v in metrics.items())
    fig.suptitle(sup)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def write_run_report(
    path: str | Path,
    cfg,
    metrics: dict | None = None,
    timings: dict | None = None,
    extra: dict | None = None,
) -> dict:
    """Structured JSON run report; returns the dict it wrote."""
    def finite(v):
        """inf/nan values anywhere in the record (psnr on identical
        images is inf by design) serialize as strings — bare
        Infinity/NaN is not valid RFC-8259 JSON and strict parsers reject
        the report."""
        if isinstance(v, dict):
            return {k: finite(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [finite(x) for x in v]
        if isinstance(v, float) and not np.isfinite(v):
            return str(v)
        return v

    rec = finite({
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "config_name": cfg.name,
        "config_hash": cfg.cache_key(),
        "config": cfg.to_dict(),
        "metrics": metrics or {},
        "timings": timings or {},
        **(extra or {}),
    })
    Path(path).write_text(json.dumps(rec, indent=2, allow_nan=False) + "\n")
    return rec
