"""Native (C++) host-runtime components, bound via ctypes.

The compute path is PyTorch and the hand-written CUDA kernels; the HOST
runtime around it (the DICOM decoders that feed file batches and volume
streaming, the JPEG 2000 / JPEG / HTJ2K entropy coders) is native C++,
the same sources as ``mies_tpu/native``. The shared object builds on
first use with g++ into the git-ignored ``mies_tpu_torch/_build/`` (as
the CUDA kernels do) and is rebuilt when a source is newer; every native
entry point has a pure-Python twin in ``mies_tpu_torch.io`` that defines
the semantics and serves as fallback.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
BUILD_DIR = _DIR.parent / "_build"
_SO = BUILD_DIR / "_dicomfast.so"

_lib = None
_build_error: str | None = None
_build_lock = threading.Lock()


class _Meta(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("is_signed", ctypes.c_int32),
        ("instance", ctypes.c_int32),
        ("has_slice_loc", ctypes.c_int32),
        ("has_ipp_z", ctypes.c_int32),
        ("slope", ctypes.c_double),
        ("intercept", ctypes.c_double),
        ("slice_loc", ctypes.c_double),
        ("ipp_z", ctypes.c_double),
    ]


def _compile() -> bool:
    """g++ to a temp path + atomic rename (a concurrent loader must
    never see a half-written .so)."""
    global _build_error
    import os

    srcs = [_DIR / "dicomfast.cpp", _DIR / "jpeg2k_t1.cpp",
            _DIR / "jpegdct_scan.cpp", _DIR / "htj2k_t1.cpp"]
    tmp = BUILD_DIR / f"_dicomfast.tmp{os.getpid()}.so"
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp)] + [str(s) for s in srcs],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        _build_error = getattr(e, "stderr", str(e))
        tmp.unlink(missing_ok=True)
        return False


def _load() -> bool:
    global _lib, _build_error
    try:
        lib = ctypes.CDLL(str(_SO))
        lib.mies_dicom_read_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_Meta), ctypes.c_void_p,
        ]
        lib.mies_dicom_read_file.restype = ctypes.c_int
        lib.mies_dicom_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_Meta),
            ctypes.c_void_p,
        ]
        lib.mies_dicom_parse.restype = ctypes.c_int
        lib.mies_j2k_t1_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.mies_j2k_t1_decode.restype = ctypes.c_int
        lib.mies_j2k_t1_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ]
        lib.mies_j2k_t1_encode.restype = ctypes.c_int
        lib.mies_jpeg_scan_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.mies_jpeg_scan_decode.restype = ctypes.c_int
        lib.mies_ht_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.mies_ht_decode.restype = ctypes.c_int
        lib.mies_ht_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ]
        lib.mies_ht_encode.restype = ctypes.c_int
        _lib = lib
        return True
    except OSError as e:
        _build_error = str(e)
        return False


def build(force: bool = False) -> bool:
    """Compile + load the shared object (idempotent, thread-safe).

    A stale/foreign .so that fails to dlopen triggers ONE recompile
    with the local toolchain before giving up (a checked-out binary
    built elsewhere must not permanently disable the native path).
    The lock serializes first-use from enhance_batch's decode pool —
    concurrent g++ runs to one output corrupted the library.
    """
    global _lib, _build_error
    if _lib is not None and not force:
        return True
    with _build_lock:
        if _lib is not None and not force:
            return True
        srcs = (_DIR / "dicomfast.cpp", _DIR / "jpeg2k_t1.cpp",
                _DIR / "jpegdct_scan.cpp", _DIR / "htj2k_t1.cpp")
        stale = (
            force
            or not _SO.exists()
            or any(_SO.stat().st_mtime < s.stat().st_mtime
                   for s in srcs)
        )
        if stale and not _compile():
            return False
        if _load():
            return True
        # the existing .so didn't load (wrong arch/glibc): rebuild once
        return (not stale) and _compile() and _load()


def available() -> bool:
    return build()


_ERRORS = {
    -1: "truncated or garbled dataset",
    -2: "unsupported transfer syntax (only uncompressed LE / RLE Lossless)",
    -3: "missing PixelData / Rows / Columns",
    -4: "unsupported BitsAllocated",
    -5: "cannot read file",
    -6: "out of memory",
    -7: "corrupt RLE PixelData",
    -8: "multi-fragment (multi-frame) RLE PixelData",
    -9: "corrupt/unsupported JPEG-LS PixelData",
    -10: "color (SamplesPerPixel != 1) pixel data",
}


def read_dicom_native(path: str | Path) -> tuple[np.ndarray, dict]:
    """Read one slice with the native parser. Raises on failure.

    Dtype contract MATCHES the Python twin (io.dicom.read_dicom):
    int16 when a rescale applies or pixels are signed; otherwise the
    STORED unsigned dtype (uint16/uint8). The C core emits an int16
    buffer; for unsigned-no-rescale data its modulo-2^16 cast preserves
    the bit pattern, so the uint16 view recovers the stored values —
    without it a uint16 MR slice would decode machine-dependently.
    """
    if not build():
        raise RuntimeError(f"native dicom parser unavailable: {_build_error}")
    meta = _Meta()
    data = Path(path).read_bytes()  # one disk read; both parses in memory
    rc = _lib.mies_dicom_parse(data, len(data), ctypes.byref(meta), None)
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, rc)}")
    out = np.empty((meta.rows, meta.cols), np.int16)
    rc = _lib.mies_dicom_parse(
        data, len(data), ctypes.byref(meta),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, rc)}")
    rescale = meta.slope != 1.0 or meta.intercept != 0.0
    if not rescale and not meta.is_signed:
        out = out.view(np.uint16) if meta.bits == 16 else out.astype(np.uint8)
    return out, {
        "instance": meta.instance if meta.instance >= 0 else None,
        "slice_loc": meta.slice_loc if meta.has_slice_loc else None,
        "ipp_z": meta.ipp_z if meta.has_ipp_z else None,
    }


def read_dicom_series_native(
    directory: str | Path, pattern: str = "*.dcm", workers: int = 8
) -> np.ndarray:
    """Parallel native series read -> [Z, H, W] int16 HU volume.

    ctypes calls release the GIL, so a thread pool gives true parallel
    file decode — the reference's rationale for native loaders. Slice
    order: ImagePositionPatient z, then SliceLocation, then
    InstanceNumber, then filename (same contract as the Python reader).
    """
    paths = sorted(Path(directory).glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files in {directory}")

    def _read_one(p):
        try:
            return read_dicom_native(p)
        except ValueError as e:
            # syntaxes the C core doesn't know (JPEG Lossless) and
            # color files (its -10 refusal) fall back per-file to the
            # Python twin — a mixed series still streams, supported
            # files stay on the fast path (the color frame then fails
            # at np.stack/int16 with the shape named, not silently)
            if ("unsupported transfer syntax" not in str(e)
                    and "color" not in str(e)):
                raise
            from mies_tpu_torch.io.dicom import read_dicom

            s = read_dicom(p)
            return s.pixels, {
                "instance": s.instance_number,
                "slice_loc": s.slice_location,
                "ipp_z": s.image_position_z,
            }

    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(_read_one, paths))

    def key(item):
        # same merged-position ordering as io.dicom.read_dicom_series
        i, (_, m) = item
        z = m["ipp_z"] if m["ipp_z"] is not None else m["slice_loc"]
        if z is not None:
            return (0, z, 0)
        if m["instance"] is not None:
            return (1, m["instance"], 0)
        return (2, 0, i)

    from mies_tpu_torch.io.dicom import _to_int16_sat

    ordered = [r for _, r in sorted(enumerate(results), key=lambda t: key(t))]
    # the series contract is int16 (matching io.dicom.read_dicom_series,
    # which saturates out-of-range values the same way)
    return np.stack([_to_int16_sat(px) for px, _ in ordered], axis=0)


_T1_BANDS = {"LL": 0, "HL": 1, "LH": 2, "HH": 3}


def t1_decode(data: bytes, w: int, h: int, band: str, npasses: int,
              numbps: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Native EBCOT Tier-1 block decode — the C++ twin of
    io.jpeg2k._t1_decode_block (bit-equal; tests pin it). Caller must
    have checked available()."""
    mag = np.zeros((h, w), np.int32)
    chi = np.zeros((h, w), np.uint8)
    und = _lib.mies_j2k_t1_decode(
        data, len(data), w, h, _T1_BANDS[band], npasses, numbps,
        mag.ctypes.data_as(ctypes.c_void_p),
        chi.ctypes.data_as(ctypes.c_void_p),
    )
    return mag, chi, und


def t1_encode(mag: np.ndarray, chi: np.ndarray, band: str,
              numbps: int) -> tuple[bytes, int]:
    """Native EBCOT Tier-1 block encode — the C++ twin of
    io.jpeg2k._t1_encode_block (bit-equal; tests pin it)."""
    h, w = mag.shape
    mag = np.ascontiguousarray(mag, np.int32)
    chi = np.ascontiguousarray(chi, np.uint8)
    # absolute bound: <= 1 byte per coded decision + flush margin
    cap = 3 * numbps * w * h + 64
    out = np.empty(cap, np.uint8)
    np_out = ctypes.c_int(0)
    n = _lib.mies_j2k_t1_encode(
        mag.ctypes.data_as(ctypes.c_void_p),
        chi.ctypes.data_as(ctypes.c_void_p),
        w, h, _T1_BANDS[band], numbps,
        out.ctypes.data_as(ctypes.c_void_p), cap,
        ctypes.byref(np_out),
    )
    if n < 0:
        raise RuntimeError("native t1_encode: output capacity exceeded")
    return out[:n].tobytes(), int(np_out.value)


def jpeg_scan_decode(data: bytes, start: int, comp_geom: list,
                     tables: bytes, mcux: int, mcuy: int,
                     ri: int) -> list[np.ndarray]:
    """Native T.81 sequential-DCT entropy scan — the C++ twin of
    io.jpegdct's Python scan loops (bit-equal int32 zigzag coeffs).
    ``comp_geom`` is per-component [h, v, bw, bh]; caller must have
    checked available()."""
    ncomp = len(comp_geom)
    geom = np.asarray(comp_geom, np.int32).reshape(-1)
    outs = [np.zeros((g[3] * g[2], 64), np.int32) for g in comp_geom]
    flat = np.concatenate([o.reshape(-1) for o in outs]) if ncomp > 1 \
        else outs[0].reshape(-1)
    flat = np.ascontiguousarray(flat)
    rc = _lib.mies_jpeg_scan_decode(
        data, len(data), start, ncomp,
        geom.ctypes.data_as(ctypes.c_void_p), tables, len(tables),
        mcux, mcuy, ri, flat.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        msgs = {-1: "truncated or corrupt entropy-coded data",
                -2: "corrupt Huffman stream",
                -3: "restart marker out of order",
                -4: "bad Huffman table"}
        raise ValueError(f"jpeg scan: {msgs.get(rc, rc)}")
    out, off = [], 0
    for g in comp_geom:
        n = g[3] * g[2] * 64
        out.append(flat[off:off + n].reshape(g[3] * g[2], 64))
        off += n
    return out


_HT_TBL = None


def _ht_tables():
    """The CxtVLC decode tables as C-contiguous uint16 arrays (single
    source of truth: io/htj2k_tables.py)."""
    global _HT_TBL
    if _HT_TBL is None:
        from mies_tpu_torch.io.htj2k_tables import VLC_TBL0, VLC_TBL1

        _HT_TBL = (np.asarray(VLC_TBL0, np.uint16),
                   np.asarray(VLC_TBL1, np.uint16))
    return _HT_TBL


_HT_ERRORS = {
    -1: "invalid cleanup segment length / Scup",
    -2: "VLC stream over-read",
    -3: "U_q larger than zero bitplanes + 1",
    -4: "VLC significance outside the codeblock area",
    -5: "no valid CxtVLC entry",
    -6: "magnitude unencodable / exponent overflow",
    -7: "output buffer too small",
    -8: "UVLC value out of range",
}


def ht_decode(data: bytes, w: int, h: int, zbp: int):
    """HT cleanup decode -> (mag int32 [h, w], sign uint8 [h, w]).
    Twin of io.htj2k.decode_ht_cleanup (bit-equal; tests pin it)."""
    if _lib is None and not build():
        raise RuntimeError(f"native HT coder unavailable: {_build_error}")
    t0, t1 = _ht_tables()
    mag = np.empty((h, w), np.int32)
    sgn = np.empty((h, w), np.uint8)
    rc = _lib.mies_ht_decode(
        data, len(data), w, h, zbp,
        t0.ctypes.data, t1.ctypes.data,
        mag.ctypes.data, sgn.ctypes.data,
    )
    if rc != 0:
        from mies_tpu_torch.io.htj2k import HTError

        raise HTError(
            f"native HT decode: {_HT_ERRORS.get(rc, rc)}"
        )
    return mag, sgn


def ht_encode(coeffs: np.ndarray, B: int):
    """Lossless cleanup-only HT encode -> (segment bytes, zbp).
    Twin of io.htj2k.encode_ht_block (bit-equal; tests pin it)."""
    if _lib is None and not build():
        raise RuntimeError(f"native HT coder unavailable: {_build_error}")
    t0, t1 = _ht_tables()
    c = np.ascontiguousarray(coeffs, np.int32)
    h, w = c.shape
    cap = 4 * c.nbytes + 4096
    out = np.empty(cap, np.uint8)
    zbp = ctypes.c_int(0)
    rc = _lib.mies_ht_encode(
        c.ctypes.data, w, h, B,
        t0.ctypes.data, t1.ctypes.data,
        out.ctypes.data, cap, ctypes.byref(zbp),
    )
    if rc < 0:
        from mies_tpu_torch.io.htj2k import HTError

        raise HTError(
            f"native HT encode: {_HT_ERRORS.get(rc, rc)}"
        )
    return out[:rc].tobytes(), zbp.value
