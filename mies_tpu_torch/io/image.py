"""2-D image ingest/save (PNG/JPEG/TIFF via Pillow — host C codecs).

A copy of ``mies_tpu.io.image`` (the reference's pillow role, SURVEY.md
section 2b D8): X-ray / mammogram ingest to arrays, uint8 save of
enhanced outputs. Pillow is imported only by the calls that read or
write PNG/JPEG/TIFF (and the 'gray' collapse of a color DICOM), so DICOM,
``.npy`` and ``.nc`` work where Pillow is not installed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_image(
    path: str | Path,
    as_gray: bool = True,
    dtype: str = "float32",
    channels: str | None = None,
) -> np.ndarray:
    """Load an image file to a NumPy array.

    as_gray=True, dtype="float32": float32 [H, W] in [0, 1] (16-bit
    sources keep their precision: /65535). dtype="raw" returns the
    integer pixels (uint8/uint16) — callers ship those to the device and
    normalize ON CHIP, quartering host->device traffic (the pipeline
    compiler's ingest cast makes the two paths bit-identical).
    as_gray=False returns the raw PIL array.

    ``channels`` is the multi-channel policy (config key
    ``io.channels``; kornia's op surface is natively [B, C, H, W] —
    reference pyproject.toml:8):
      * None (default): multi-channel input is an ERROR with guidance —
        never a silent luminance collapse;
      * "gray": explicit luminance conversion (PIL convert("L"));
      * "per-channel": returns [C, H, W] with every band kept; the
        pipeline processes each channel independently.
    Grayscale sources are unaffected by the policy.

    A single ``.dcm``/``.dicom`` file (the north star's named format —
    BASELINE.json workloads 4-5) dispatches to the framework's own
    DICOM reader: int16 HU pixels that the pipeline's ``window_hu``
    stage ingests directly (the compiler's ``_ingest`` passes int16
    through).
    """
    path = Path(path)
    if path.suffix.lower() in (".dcm", ".dicom"):
        return _load_dicom_slice(path, dtype, channels)
    from PIL import Image

    img = Image.open(path)
    if not as_gray:
        return np.asarray(img)
    if img.mode in ("I", "I;16", "I;16B", "I;16L"):
        arr = np.asarray(img.convert("I"))
        if dtype == "raw":
            return arr.astype(np.uint16)
        return arr.astype(np.float32) / 65535.0
    if img.mode != "L" and len(img.getbands()) == 1:
        # single-band non-L modes ('1' bilevel, 'P' palette, 'F' float)
        # keep the pre-multichannel behavior: convert to L
        img = img.convert("L")
    if img.mode != "L":
        if channels is None:
            raise ValueError(
                f"{path}: {img.mode} input has multiple channels; set the "
                f"config's io.channels to 'gray' (explicit luminance "
                f"collapse) or 'per-channel' (process each channel "
                f"independently)"
            )
        if channels == "per-channel":
            arr = np.asarray(img)  # [H, W, C] uint8 (all bands kept)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            chw = np.ascontiguousarray(arr.transpose(2, 0, 1))
            if dtype == "raw":
                return chw
            return chw.astype(np.float32) / 255.0
        if channels != "gray":
            raise ValueError(
                f"unknown channels policy {channels!r}; use 'gray' or "
                f"'per-channel'"
            )
        img = img.convert("L")
    arr = np.asarray(img)
    if dtype == "raw":
        return arr
    return arr.astype(np.float32) / 255.0


def _load_dicom_slice(path: Path, dtype: str,
                      channels: str | None = None) -> np.ndarray:
    """Single-file DICOM -> [H, W] array for the 2-D pipeline path.

    dtype="raw": pixels exactly as decoded (int16 HU when a rescale is
    present, else the stored uint8/uint16) — chains starting with
    ``window_hu`` take this. dtype="float32": unsigned stored pixels
    normalize like any image; int16 HU has no canonical [0,1] mapping,
    so that combination is an explicit error instead of a silent guess.

    Color slices (SamplesPerPixel=3 — ultrasound / secondary capture,
    decoded to RGB) follow the same ``io.channels`` policy as color
    PNGs: None errors with guidance, 'gray' is the ITU-R 601 luminance
    collapse (PIL convert("L"), identical to the image path),
    'per-channel' returns [3, H, W].
    """
    from mies_tpu_torch import native
    from mies_tpu_torch.io.dicom import read_dicom, read_dicom_header

    hdr = read_dicom_header(path)  # header-only: photometric/BitsStored
    if native.available():
        try:
            px, _ = native.read_dicom_native(path)
        except ValueError:
            # the Python reader handles forms the C parser doesn't
            # (e.g. preamble-less implicit-VR dumps) — fall back rather
            # than fail on a file the framework CAN decode
            px = read_dicom(path).pixels
    else:
        px = read_dicom(path).pixels
    if hdr.get("photometric", "MONOCHROME2") == "MONOCHROME1":
        # PS3.3 C.7.6.3.1.2: MONOCHROME1 displays LOW values bright —
        # common for CR/DX X-rays. Invert unsigned stored pixels over
        # their BitsStored range so the chain sees display-convention
        # data (what every viewer renders); signed/rescaled pixels have
        # no canonical inversion, so that combination is an explicit
        # error instead of silently wrong-contrast output.
        if px.dtype == np.int16:
            raise ValueError(
                f"{path}: MONOCHROME1 with signed/rescaled pixels has "
                "no canonical inversion; load the file with the DICOM "
                "API and handle the VOI mapping explicitly"
            )
        top = (1 << hdr.get("bits_stored",
                            16 if px.dtype == np.uint16 else 8)) - 1
        px = (top - px.astype(np.int32)).clip(0, top).astype(px.dtype)
    if px.ndim == 3:  # color slice: the io.channels policy applies
        if channels is None:
            raise ValueError(
                f"{path}: color DICOM (SamplesPerPixel=3) has multiple "
                "channels; set the config's io.channels to 'gray' or "
                "'per-channel'"
            )
        if channels == "per-channel":
            px = np.ascontiguousarray(px.transpose(2, 0, 1))
        elif channels == "gray":
            from PIL import Image

            px = np.asarray(Image.fromarray(px).convert("L"))
        else:
            raise ValueError(
                f"unknown channels policy {channels!r}; use 'gray' or "
                f"'per-channel'"
            )
    if dtype == "raw":
        return px
    if px.dtype == np.int16:
        raise ValueError(
            f"{path}: int16 HU pixels have no canonical float [0,1] "
            f"mapping; load with dtype='raw' and start the chain with a "
            f"window_hu stage"
        )
    return to_float(px)


def save_image(path: str | Path, arr: np.ndarray) -> None:
    """Save uint8 [H, W] (or float [0,1], quantized) as PNG/JPEG/TIFF —
    or as a minimal Part-10 DICOM when the path ends in .dcm/.dicom."""
    path = Path(path)
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = from_float(arr)
    if arr.ndim == 3 and arr.shape[0] <= 4 < arr.shape[-1]:
        # pipeline outputs are channels-first [C, H, W]; PIL wants HWC
        arr = arr.transpose(1, 2, 0)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    if path.suffix.lower() in (".dcm", ".dicom"):
        from mies_tpu_torch.io.dicom import write_dicom

        write_dicom(path, arr)
        return
    from PIL import Image

    Image.fromarray(arr).save(path)


def to_float(arr: np.ndarray) -> np.ndarray:
    """uint8/uint16 -> float32 [0, 1]; float passes through as float32."""
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def from_float(arr: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with round-half-even (matches on-device path)."""
    return np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)
