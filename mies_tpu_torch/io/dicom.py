"""Self-contained minimal DICOM reader/writer (no pydicom available).

A copy of ``mies_tpu.io.dicom``. The north star names DICOM CT ingest
(SURVEY.md section 2b D9 note: DICOM is a north-star addition) and the
project depends on no pydicom, so the format support is implemented here
directly:

* Part-10 files (128-byte preamble + 'DICM' + explicit-VR-LE meta group)
* datasets in Implicit VR Little Endian (1.2.840.10008.1.2),
  Explicit VR Little Endian (1.2.840.10008.1.2.1) and, read-only,
  the retired Explicit VR Big Endian (1.2.840.10008.1.2.2 — legacy
  GE archives; fixed-width values normalized to LE at parse time)
* uncompressed PixelData, 8/16 bits allocated, signed or unsigned
* RLE Lossless (1.2.840.10008.1.2.5) — PS3.5 Annex G segment-table +
  PackBits codec, decode AND encode (clinical archives are
  predominantly compressed; RLE is the one syntax implementable with
  zero new dependencies)
* JPEG Lossless (1.2.840.10008.1.2.4.57 / .4.70 SV1) — the T.81
  process-14 SOF3 codec in io/jpegll.py, decode AND encode (the other
  dominant lossless archive syntax)
* Deflated Explicit VR LE (1.2.840.10008.1.2.1.99) — the post-meta
  dataset is one raw-deflate stream (PS3.5 A.5), decode AND encode
  via zlib (structured-report exports and some PACS archives)
* Rescale slope/intercept -> int16 Hounsfield units
* series loading: sort slices by InstanceNumber / ImagePositionPatient z

* JPEG Baseline / Extended (1.2.840.10008.1.2.4.50 / .4.51) — the T.81
  sequential-DCT LOSSY codec in io/jpegdct.py (8/12-bit grayscale),
  decode AND encode (ultrasound/endoscopy archives are predominantly
  .4.50); writing requires choosing the syntax explicitly.
* JPEG-LS (1.2.840.10008.1.2.4.80 lossless / .4.81 near-lossless) —
  the T.87 LOCO-I codec in io/jpegls.py, decode AND encode (the
  dominant modern lossless PACS syntax; CharLS pin via
  tools/verify_jpegls_golden.py).
* JPEG 2000 (1.2.840.10008.1.2.4.90 lossless / .4.91) — the 15444-1
  EBCOT codec in io/jpeg2k.py, decode (raw codestreams and JP2
  containers; golden-tested against Pillow's OpenJPEG in-tree).

The remaining families (HTJ2K, MPEG video) are refused with the
syntax NAMED and transcode guidance.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"  # retired; read-only support
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"  # any predictor 1-7
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"  # predictor 1 (the default)
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"  # process 1, 8-bit LOSSY
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"  # processes 2 & 4, 8/12-bit LOSSY
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"  # T.87, NEAR = 0
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"  # T.87 near-lossless, NEAR >= 1
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"  # 5/3 reversible only
JPEG_2000 = "1.2.840.10008.1.2.4.91"  # 9/7 (or 5/3) — may be lossy
HTJ2K_LOSSLESS = "1.2.840.10008.1.2.4.201"  # T.814 HT, reversible
HTJ2K_LOSSLESS_RPCL = "1.2.840.10008.1.2.4.202"  # + RPCL progression
HTJ2K = "1.2.840.10008.1.2.4.203"  # HT, may be lossy (9/7)

# encapsulated (undefined-length, fragment-item) PixelData syntaxes
_ENCAPSULATED = (
    RLE_LOSSLESS,
    JPEG_LOSSLESS_P14,
    JPEG_LOSSLESS_SV1,
    JPEG_BASELINE,
    JPEG_EXTENDED,
    JPEG_LS_LOSSLESS,
    JPEG_LS_NEAR,
    JPEG_2000_LOSSLESS,
    JPEG_2000,
    HTJ2K_LOSSLESS,
    HTJ2K_LOSSLESS_RPCL,
    HTJ2K,
)
_JPEG_DCT = (JPEG_BASELINE, JPEG_EXTENDED)
_JPEG_LS = (JPEG_LS_LOSSLESS, JPEG_LS_NEAR)
_JPEG_2K = (JPEG_2000_LOSSLESS, JPEG_2000, HTJ2K_LOSSLESS,
            HTJ2K_LOSSLESS_RPCL, HTJ2K)

# Known-but-unsupported syntaxes, named in refusal messages so users
# know exactly what to transcode (gdcmconv --raw / dcmdjpeg).
_TS_NAMES = {
    "1.2.840.10008.1.2.4.100": "MPEG2",
    "1.2.840.10008.1.2.4.102": "MPEG-4 AVC/H.264",
}


def _ts_explicit(ts: str, path) -> bool:
    """Explicit-VR flag for a supported transfer syntax; raises the
    guidance-bearing NotImplementedError for everything else."""
    if ts == IMPLICIT_VR_LE:
        return False
    if (
        ts == EXPLICIT_VR_LE
        or ts == EXPLICIT_VR_BE
        or ts == DEFLATED_EXPLICIT_VR_LE
        or ts in _ENCAPSULATED
    ):
        return True  # encapsulated syntaxes are always explicit VR LE
    name = _TS_NAMES.get(ts, "unrecognized")
    raise NotImplementedError(
        f"{path}: transfer syntax {ts} ({name}) is not supported — "
        f"supported: uncompressed little/big endian ({IMPLICIT_VR_LE}, "
        f"{EXPLICIT_VR_LE}, {EXPLICIT_VR_BE}), Deflated "
        f"({DEFLATED_EXPLICIT_VR_LE}), RLE Lossless ({RLE_LOSSLESS}), "
        f"JPEG Lossless ({JPEG_LOSSLESS_P14}, {JPEG_LOSSLESS_SV1}), "
        f"JPEG-LS ({JPEG_LS_LOSSLESS}, {JPEG_LS_NEAR}), JPEG 2000 "
        f"({JPEG_2000_LOSSLESS}, {JPEG_2000}) and lossy JPEG "
        f"({JPEG_BASELINE}, {JPEG_EXTENDED}); transcode first "
        f"(e.g. `gdcmconv --raw` or dcmtk's dcmdjpeg)"
    )


def _open_dataset(data: bytes, path) -> tuple["_Reader", str]:
    """Parse the file-meta group and return a positioned dataset reader.

    For Deflated Explicit VR LE (PS3.5 A.5) the entire post-meta byte
    stream is ONE raw-deflate (RFC 1951, no zlib header) compression of
    an Explicit VR LE dataset — inflate it and read from offset 0."""
    ts, offset = _parse_meta(data)
    explicit = _ts_explicit(ts, path)
    if ts == DEFLATED_EXPLICIT_VR_LE:
        try:
            body = zlib.decompressobj(wbits=-15).decompress(data[offset:])
        except zlib.error as e:
            raise ValueError(
                f"{path}: Deflated Explicit VR LE dataset failed to "
                f"inflate ({e}) — file is corrupt or not raw-deflate"
            ) from e
        r = _Reader(body, explicit=True)
        return r, ts
    r = _Reader(data, explicit=explicit,
                big_endian=ts == EXPLICIT_VR_BE)
    r.pos = offset
    return r, ts

# VRs with a 2-byte reserved field and 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}

_TAG_ROWS = (0x0028, 0x0010)
_TAG_COLS = (0x0028, 0x0011)
_TAG_BITS_ALLOC = (0x0028, 0x0100)
_TAG_PIXEL_REP = (0x0028, 0x0103)
_TAG_INTERCEPT = (0x0028, 0x1052)
_TAG_SLOPE = (0x0028, 0x1053)
_TAG_SLICE_THICK = (0x0018, 0x0050)
_TAG_PIXEL_SPACING = (0x0028, 0x0030)
_TAG_INSTANCE = (0x0020, 0x0013)
_TAG_IPP = (0x0020, 0x0032)
_TAG_SLICE_LOC = (0x0020, 0x1041)
_TAG_PHOTOMETRIC = (0x0028, 0x0004)  # PhotometricInterpretation (CS)
_TAG_SAMPLES = (0x0028, 0x0002)  # SamplesPerPixel (US)
_TAG_PLANAR = (0x0028, 0x0006)  # PlanarConfiguration (US)
_TAG_FRAMES = (0x0028, 0x0008)  # NumberOfFrames (IS)
_TAG_BITS_STORED = (0x0028, 0x0101)
_TAG_WIN_CENTER = (0x0028, 0x1050)  # WindowCenter (DS, may be multi)
_TAG_WIN_WIDTH = (0x0028, 0x1051)
_TAG_PIXEL_DATA = (0x7FE0, 0x0010)
_TAG_TS_UID = (0x0002, 0x0010)
_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)


@dataclasses.dataclass
class DicomSlice:
    """Decoded pixel array + the geometry/scaling metadata the pipeline uses."""

    pixels: np.ndarray  # [H, W] int16 (HU if rescale present) or uint8/uint16
    rows: int
    cols: int
    instance_number: int | None = None
    slice_location: float | None = None
    image_position_z: float | None = None
    pixel_spacing: tuple[float, float] | None = None  # (row, col) mm
    slice_thickness: float | None = None  # mm
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    photometric: str = "MONOCHROME2"
    bits_stored: int | None = None
    transfer_syntax: str = EXPLICIT_VR_LE


_SWAP_VRS = {  # fixed-width binary VRs: value byte-swap width (BE data)
    b"US": 2, b"SS": 2, b"OW": 2, b"AT": 2,
    b"UL": 4, b"SL": 4, b"OL": 4, b"FL": 4, b"OF": 4,
    b"FD": 8, b"OD": 8,
}


class _Reader:
    def __init__(self, data: bytes, explicit: bool,
                 big_endian: bool = False):
        self.d = data
        self.pos = 0
        self.explicit = explicit
        self.big_endian = big_endian
        self._e = ">" if big_endian else "<"
        self._last_vr = b""

    def eof(self) -> bool:
        return self.pos >= len(self.d)

    def _need(self, n: int) -> None:
        # truncated files must surface as ValueError (the per-item
        # failure contract), never struct.error/IndexError crashes
        if self.pos + n > len(self.d):
            raise ValueError(
                f"truncated DICOM: element runs past byte {len(self.d)}"
            )

    def tag(self) -> tuple[int, int]:
        self._need(4)
        g, e = struct.unpack_from(self._e + "HH", self.d, self.pos)
        self.pos += 4
        return g, e

    def element(self) -> tuple[tuple[int, int], bytes, int]:
        """Read one data element header; returns (tag, vr, length)."""
        t = self.tag()
        if t in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
            self._need(4)
            (length,) = struct.unpack_from(self._e + "I", self.d, self.pos)
            self.pos += 4
            self._last_vr = b""
            return t, b"", length
        if self.explicit:
            self._need(2)
            vr = self.d[self.pos : self.pos + 2]
            self.pos += 2
            if vr in _LONG_VRS:
                self._need(6)
                self.pos += 2  # reserved
                (length,) = struct.unpack_from(
                    self._e + "I", self.d, self.pos
                )
                self.pos += 4
            else:
                self._need(2)
                (length,) = struct.unpack_from(
                    self._e + "H", self.d, self.pos
                )
                self.pos += 2
        else:
            vr = b""
            self._need(4)
            (length,) = struct.unpack_from(self._e + "I", self.d, self.pos)
            self.pos += 4
        self._last_vr = vr
        return t, vr, length

    def value(self, length: int) -> bytes:
        self._need(length)
        v = self.d[self.pos : self.pos + length]
        self.pos += length
        if self.big_endian:
            sz = _SWAP_VRS.get(self._last_vr)
            if sz and length >= sz:
                # normalize fixed-width binary values to little endian
                # so every downstream '<'-unpack and frombuffer works
                n = length // sz
                v = (
                    np.frombuffer(v, f">u{sz}", count=n)
                    .astype(f"<u{sz}")
                    .tobytes()
                    + v[n * sz :]
                )
        return v

    def skip_undefined(self, vr: bytes) -> None:
        """Skip an element of undefined length (SQ or encapsulated data)."""
        depth = 1
        while depth > 0 and not self.eof():
            t, _, length = self.element()
            if t == _SEQ_DELIM:
                depth -= 1
            elif t == _ITEM and length == 0xFFFFFFFF:
                pass  # item contents parsed element-by-element
            elif t == _ITEM_DELIM:
                pass
            elif length == 0xFFFFFFFF:
                depth += 1
            else:
                self.pos += length


def _parse_geometry_tag(t, v: bytes, meta: dict) -> bool:
    """Parse the ordering/geometry tags shared by read_dicom and
    read_dicom_header into ``meta``; returns True when ``t`` was one of
    them (one decoder — the two parsers must never drift)."""
    if t == _TAG_INSTANCE:
        try:
            meta["instance"] = int(v.decode("ascii").strip(" \x00"))
        except ValueError:
            pass
    elif t == _TAG_SLICE_LOC:
        try:
            meta["slice_loc"] = float(v.decode("ascii").strip(" \x00"))
        except ValueError:
            pass
    elif t == _TAG_IPP:
        parts = v.decode("ascii").strip(" \x00").split("\\")
        if len(parts) == 3:
            meta["ipp_z"] = float(parts[2])
    elif t == _TAG_PIXEL_SPACING:
        parts = v.decode("ascii").strip(" \x00").split("\\")
        if len(parts) == 2:
            try:
                meta["pixel_spacing"] = (float(parts[0]), float(parts[1]))
            except ValueError:
                pass
    elif t == _TAG_SLICE_THICK:
        try:
            meta["slice_thickness"] = float(v.decode("ascii").strip(" \x00"))
        except ValueError:
            pass
    elif t == _TAG_WIN_CENTER:
        # modality-recommended display window (first value of a
        # possibly multi-valued DS) — surfaced so CLI/users can window
        # with the file's own recommendation instead of guessing
        try:
            meta["window_center"] = float(
                v.decode("ascii").strip(" \x00").split("\\")[0]
            )
        except ValueError:
            pass
    elif t == _TAG_WIN_WIDTH:
        try:
            meta["window_width"] = float(
                v.decode("ascii").strip(" \x00").split("\\")[0]
            )
        except ValueError:
            pass
    else:
        return False
    return True


# ---------------------------------------------------------------------------
# RLE Lossless codec (PS3.5 Annex G): a 64-byte segment table + one
# PackBits byte stream per byte plane (MSB plane first), each image row
# encoded independently. Grayscale 8/16-bit only (the framework's pixel
# model); the native C parser implements the same decode for the
# streaming path (native/dicomfast.cpp), this is the defining twin.
# ---------------------------------------------------------------------------


def _read_encapsulated(r: _Reader, path) -> list[bytes]:
    """Fragments of an undefined-length (encapsulated) PixelData value:
    the Basic Offset Table item first (skipped — RLE puts one frame per
    fragment, PS3.5 A.4.2, so offsets are redundant), then one item per
    fragment, closed by the sequence delimiter."""
    frags: list[bytes] = []
    first = True
    while not r.eof():
        t, _, length = r.element()
        if t == _SEQ_DELIM:
            return frags
        if t != _ITEM or length == 0xFFFFFFFF:
            raise ValueError(
                f"{path}: malformed encapsulated PixelData (tag {t}, "
                f"length {length:#x})"
            )
        v = r.value(length)
        if first:
            first = False  # Basic Offset Table
        else:
            frags.append(v)
    raise ValueError(
        f"{path}: encapsulated PixelData missing its sequence delimiter"
    )


def _packbits_decode(seg: bytes, expected: int, ctx) -> np.ndarray:
    """PackBits (PS3.5 G.3.2) -> exactly ``expected`` uint8 bytes.
    Control byte n: 0..127 = copy the next n+1 literally; 129..255 =
    repeat the next byte 257-n times; 128 = no-op. Output past
    ``expected`` (trailing pad replication) is discarded."""
    buf = np.frombuffer(seg, np.uint8)
    out = np.empty(expected, np.uint8)
    i, o, L = 0, 0, len(buf)
    while o < expected:
        if i >= L:
            raise ValueError(
                f"{ctx}: RLE segment exhausted at byte {o}/{expected}"
            )
        n = int(buf[i])
        i += 1
        if n < 128:
            cnt = n + 1
            if i + cnt > L:
                raise ValueError(f"{ctx}: truncated RLE literal run")
            take = min(cnt, expected - o)
            out[o : o + take] = buf[i : i + take]
            i += cnt
            o += take
        elif n > 128:
            if i >= L:
                raise ValueError(f"{ctx}: truncated RLE replicate run")
            take = min(257 - n, expected - o)
            out[o : o + take] = buf[i]
            i += 1
            o += take
        # n == 128: no-op
    return out


def _rle_decode_frame(blob: bytes, rows: int, cols: int, bits: int, ctx,
                      spp: int = 1) -> np.ndarray:
    """One RLE fragment -> [rows, cols] uint8/uint16 (stored bits) or
    [rows, cols, 3] uint8 when ``spp=3`` (PS3.5 G.2: one segment per
    color plane — the ultrasound archive form)."""
    if len(blob) < 64:
        raise ValueError(f"{ctx}: RLE frame shorter than its 64-byte header")
    hdr = struct.unpack_from("<16I", blob, 0)
    nseg, nbytes = hdr[0], (bits // 8) * spp
    if nseg != nbytes:
        want = (f"{spp}-component {bits}-bit" if spp != 1
                else f"grayscale {bits}-bit")
        raise ValueError(
            f"{ctx}: RLE header declares {nseg} segment(s); {want} "
            f"needs {nbytes}"
        )
    npx = rows * cols
    offs = list(hdr[1 : 1 + nseg]) + [len(blob)]
    planes = []
    for k in range(nseg):
        a, b = offs[k], offs[k + 1]
        if not (64 <= a <= b <= len(blob)):
            raise ValueError(f"{ctx}: bad RLE segment offsets {offs[:-1]}")
        planes.append(_packbits_decode(blob[a:b], npx, ctx))
    if spp == 3:  # one 8-bit segment per plane, R then G then B
        return np.stack(
            [p.reshape(rows, cols) for p in planes], axis=-1)
    if nbytes == 1:
        return planes[0].reshape(rows, cols)
    # segment 0 carries the MSBs (big-endian composite, PS3.5 G.2)
    u16 = (planes[0].astype(np.uint16) << 8) | planes[1]
    return u16.reshape(rows, cols)


def _decode_rle_pixeldata(
    frags: list[bytes], meta: dict, path
) -> np.ndarray:
    """All fragments -> [N, rows, cols] in the STORED dtype (signedness
    applied bit-preservingly); rescale stays with the callers."""
    rows, cols = meta["rows"], meta["cols"]
    bits = meta.get("bits", 16)
    spp = meta.get("samples", 1)
    if bits not in (8, 16):
        raise NotImplementedError(f"{path}: RLE BitsAllocated={bits}")
    if spp == 3 and bits != 8:
        raise NotImplementedError(
            f"{path}: {bits}-bit color RLE (8-bit RGB supported)")
    n = meta.get("frames", len(frags))
    if len(frags) != n:
        raise ValueError(
            f"{path}: {len(frags)} RLE fragments but NumberOfFrames={n} "
            f"(PS3.5 A.4.2 requires exactly one frame per fragment)"
        )
    px = np.stack(
        [_rle_decode_frame(b, rows, cols, bits, path, spp)
         for b in frags], axis=0
    )
    if spp == 3:
        if meta.get("photometric", "RGB") == "YBR_FULL":
            from mies_tpu_torch.io.jpegdct import _ycbcr_to_rgb

            px = _ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2])
        return px
    if bits == 16 and meta.get("signed", False):
        px = px.view(np.int16)
    return px


def _decode_jpegll_pixeldata(
    frags: list[bytes], meta: dict, path, ts: str = JPEG_LOSSLESS_SV1
) -> np.ndarray:
    """JPEG fragments -> [N, rows, cols] in the STORED dtype. Routes to
    the lossless (SOF3, io/jpegll.py) or sequential-DCT (SOF0/SOF1,
    io/jpegdct.py) codec by transfer syntax.

    PS3.5 A.4: a frame may span several fragments. Without a Basic
    Offset Table the only unambiguous layouts are one-fragment-per-
    frame (len(frags) == NumberOfFrames) or a single frame (all
    fragments concatenated) — both handled; anything else is refused
    with the counts named."""
    if ts in _JPEG_DCT:
        from mies_tpu_torch.io.jpegdct import decode_jpeg_dct as _decode_blob
    elif ts in _JPEG_LS:
        from mies_tpu_torch.io.jpegls import decode_jpegls as _decode_blob
    elif ts in _JPEG_2K:
        from mies_tpu_torch.io.jpeg2k import decode_jpeg2k as _decode_blob
    else:
        from mies_tpu_torch.io.jpegll import (
            decode_jpeg_lossless as _decode_blob,
        )

    rows, cols = meta["rows"], meta["cols"]
    bits = meta.get("bits", 16)
    if bits not in (8, 16):
        raise NotImplementedError(f"{path}: JPEG BitsAllocated={bits}")
    n = meta.get("frames", len(frags))
    if len(frags) == n:
        blobs = frags
    elif n == 1:
        blobs = [b"".join(frags)]
    else:
        raise ValueError(
            f"{path}: {len(frags)} JPEG fragments for NumberOfFrames="
            f"{n} — multi-fragment frames need a Basic Offset Table "
            "layout this reader does not reconstruct"
        )
    spp = meta.get("samples", 1)
    if spp == 3 and ts not in _JPEG_DCT + _JPEG_2K:
        raise NotImplementedError(
            f"{path}: color (SamplesPerPixel=3) frames in "
            f"{_TS_NAMES.get(ts, ts)} — color decode is supported for "
            "JPEG Baseline/Extended (.4.50/.4.51) and JPEG 2000 "
            "(.4.90/.4.91); transcode other color codecs with gdcmconv"
        )
    want_shape = (rows, cols, 3) if spp == 3 else (rows, cols)
    frames = []
    for i, blob in enumerate(blobs):
        px = _decode_blob(blob, f"{path}[frame {i}]")
        if px.shape != want_shape:
            raise ValueError(
                f"{path}[frame {i}]: codestream is "
                f"{'x'.join(map(str, px.shape))} but the dataset says "
                f"{'x'.join(map(str, want_shape))} "
                "(Rows/Columns/SamplesPerPixel)"
            )
        frames.append(px)
    px = np.stack(frames, axis=0)
    if spp == 3:
        return px  # 8-bit RGB (the DCT decoder's JFIF output)
    if bits == 16 and px.dtype == np.uint8:
        # a <=8-bit codestream inside a 16-bit container: widen
        px = px.astype(np.uint16)
    elif bits == 8 and px.dtype == np.uint16:
        raise ValueError(
            f"{path}: 16-bit JPEG codestream but BitsAllocated=8"
        )
    if bits == 16 and meta.get("signed", False):
        px = px.view(np.int16)
    return px


def _decode_encapsulated_pixeldata(
    frags: list[bytes], meta: dict, path, ts: str
) -> np.ndarray:
    """Dispatch the encapsulated-PixelData codec by transfer syntax."""
    if ts == RLE_LOSSLESS:
        return _decode_rle_pixeldata(frags, meta, path)
    return _decode_jpegll_pixeldata(frags, meta, path, ts)


def _packbits_encode_row(row: bytes) -> bytearray:
    """PackBits-encode one image row (Annex G.3.1: rows never share a
    run). Runs >= 2 become replicates; literals break when a 3-run
    starts (a 2-run inside a literal costs the same either way)."""
    out = bytearray()
    i, L = 0, len(row)
    while i < L:
        j = i
        while j + 1 < L and row[j + 1] == row[j] and j - i < 127:
            j += 1
        if j > i:
            out.append(257 - (j - i + 1))
            out.append(row[i])
            i = j + 1
            continue
        j = i + 1
        while (
            j < L
            and j - i < 128
            and not (j + 2 < L and row[j] == row[j + 1] == row[j + 2])
        ):
            j += 1
        out.append(j - i - 1)
        out += row[i:j]
        i = j
    return out


def _rle_encode_frame(frame: np.ndarray) -> bytes:
    """[H, W] uint8/int16/uint16 (or [H, W, 3] uint8 color — one
    segment per plane, PS3.5 G.2) -> one RLE Lossless frame (header +
    even-padded PackBits segments, MSB plane first)."""
    frame = np.ascontiguousarray(frame)
    if frame.ndim == 3:  # color: R, G, B segments in order
        b = frame
        nseg = 3
    else:
        b = frame[..., None].view(np.uint8)  # [H, W, it], LE bytes
        nseg = frame.dtype.itemsize
    itemsize = b.shape[-1]
    segs = []
    for k in range(nseg):  # MSB plane first (identity for color)
        plane = b[:, :, k if frame.ndim == 3 else itemsize - 1 - k]
        s = bytearray()
        for r in plane:
            s += _packbits_encode_row(r.tobytes())
        if len(s) % 2:
            s.append(0)
        segs.append(bytes(s))
    hdr = [len(segs)]
    off = 64
    for s in segs:
        hdr.append(off)
        off += len(s)
    hdr += [0] * (16 - len(hdr))
    return struct.pack("<16I", *hdr) + b"".join(segs)


def _parse_meta(data: bytes) -> tuple[str, int]:
    """Parse the file-meta group (always explicit VR LE); return
    (transfer_syntax_uid, offset_of_dataset)."""
    if data[128:132] != b"DICM":
        # some exporters omit the preamble; treat as a raw dataset and
        # SNIFF the VR form: in explicit VR, bytes 4:6 of the first
        # element are a two-uppercase-letter VR code; implicit VR (the
        # DEFAULT transfer syntax, which headerless dumps usually are)
        # has a 4-byte length there instead
        vr = data[4:6]
        if len(vr) == 2 and vr.isalpha() and vr == vr.upper():
            return EXPLICIT_VR_LE, 0
        return IMPLICIT_VR_LE, 0
    r = _Reader(data, explicit=True)
    r.pos = 132
    ts = EXPLICIT_VR_LE
    # (0002,0000) group length tells us the meta extent if present
    meta_end = None
    while not r.eof():
        start = r.pos
        t, vr, length = r.element()
        if t[0] != 0x0002:
            r.pos = start
            break
        v = r.value(length)
        if t == (0x0002, 0x0000):
            if len(v) < 4:
                raise ValueError("truncated DICOM: bad meta group length")
            meta_end = r.pos + struct.unpack("<I", v[:4])[0]
        elif t == _TAG_TS_UID:
            ts = v.rstrip(b"\x00 ").decode("ascii")
        if meta_end is not None and r.pos >= meta_end:
            break
    return ts, r.pos


def read_dicom(path: str | Path) -> DicomSlice:
    """Read a single little-endian (or RLE Lossless) DICOM file."""
    data = Path(path).read_bytes()
    r, ts = _open_dataset(data, path)

    meta: dict = {}
    pixel_bytes = None
    rle_frags = None
    while not r.eof():
        t, vr, length = r.element()
        if length == 0xFFFFFFFF:
            if t == _TAG_PIXEL_DATA and ts in _ENCAPSULATED:
                rle_frags = _read_encapsulated(r, path)
                continue
            r.skip_undefined(vr)
            continue
        if t == _TAG_PIXEL_DATA:
            pixel_bytes = r.value(length)
            continue
        v = r.value(length)
        if t == _TAG_ROWS:
            meta["rows"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_COLS:
            meta["cols"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_BITS_ALLOC:
            meta["bits"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_PIXEL_REP:
            meta["signed"] = struct.unpack("<H", v[:2])[0] == 1
        elif t == _TAG_FRAMES:
            try:
                meta["frames"] = int(v.decode("ascii").strip(" \x00") or 1)
            except ValueError:
                pass
        elif t == _TAG_PHOTOMETRIC:
            meta["photometric"] = v.decode("ascii", "replace").strip(" \x00")
        elif t == _TAG_SAMPLES:
            meta["samples"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_PLANAR:
            meta["planar"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_BITS_STORED:
            meta["bits_stored"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_INTERCEPT:
            meta["intercept"] = float(v.decode("ascii").strip(" \x00") or 0)
        elif t == _TAG_SLOPE:
            meta["slope"] = float(v.decode("ascii").strip(" \x00") or 1)
        elif _parse_geometry_tag(t, v, meta):
            pass

    if (
        (pixel_bytes is None and rle_frags is None)
        or "rows" not in meta
        or "cols" not in meta
    ):
        raise ValueError(f"{path}: missing PixelData / Rows / Columns")

    rows, cols = meta["rows"], meta["cols"]
    nframes = meta.get(
        "frames", len(rle_frags) if rle_frags is not None else 1
    )
    if nframes > 1:
        raise ValueError(
            f"{path}: multi-frame DICOM (NumberOfFrames={nframes}) — "
            "read_dicom returns ONE slice and would silently drop "
            f"{nframes - 1} frames; use read_dicom_frames (cine / "
            "tomosynthesis stack -> [N, H, W]) or the volume pipeline"
        )
    bits = meta.get("bits", 16)
    if bits == 16:
        dt = np.int16 if meta.get("signed", False) else np.uint16
    elif bits == 8:
        dt = np.uint8
    else:
        raise NotImplementedError(f"BitsAllocated={bits}")
    spp = meta.get("samples", 1)
    if spp not in (1, 3):
        raise NotImplementedError(
            f"{path}: SamplesPerPixel={spp} (1 grayscale or 3 color)")
    if spp == 3 and bits != 8:
        raise NotImplementedError(
            f"{path}: {bits}-bit color DICOM (8-bit RGB/YBR supported)")
    if rle_frags is not None:
        px = _decode_encapsulated_pixeldata(rle_frags, meta, path, ts)[0]
    elif spp == 3:
        need = rows * cols * 3
        if len(pixel_bytes) < need:
            raise ValueError(
                f"{path}: PixelData holds {len(pixel_bytes)} bytes but "
                f"{rows}x{cols}x3x8bit needs {need} (truncated file, "
                "or subsampled YBR_FULL_422 raw data — transcode)"
            )
        flat = np.frombuffer(pixel_bytes[:need], np.uint8)
        if meta.get("planar", 0) == 1:  # RRR... GGG... BBB...
            px = flat.reshape(3, rows, cols).transpose(1, 2, 0)
        else:  # interleaved RGB RGB ...
            px = flat.reshape(rows, cols, 3)
        if meta.get("photometric", "RGB") == "YBR_FULL":
            from mies_tpu_torch.io.jpegdct import _ycbcr_to_rgb

            px = _ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2])
    else:
        px = np.frombuffer(
            pixel_bytes[: rows * cols * (bits // 8)], dtype=dt
        ).reshape(rows, cols)

    slope = meta.get("slope", 1.0)
    intercept = meta.get("intercept", 0.0)
    if slope != 1.0 or intercept != 0.0:
        # saturate instead of wrapping: uint16 40000 with intercept
        # -1024 must clamp at int16 max, not flip sign
        px = np.clip(
            px.astype(np.float32) * slope + intercept, -32768, 32767
        ).astype(np.int16)

    return DicomSlice(
        pixels=np.ascontiguousarray(px),
        rows=rows,
        cols=cols,
        instance_number=meta.get("instance"),
        slice_location=meta.get("slice_loc"),
        image_position_z=meta.get("ipp_z"),
        pixel_spacing=meta.get("pixel_spacing"),
        slice_thickness=meta.get("slice_thickness"),
        rescale_slope=slope,
        rescale_intercept=intercept,
        photometric=meta.get("photometric", "MONOCHROME2"),
        bits_stored=meta.get("bits_stored"),
        transfer_syntax=ts,
    )


def read_dicom_header(path: str | Path) -> dict:
    """Parse ordering/shape metadata WITHOUT decoding pixels.

    Returns {rows, cols, instance, slice_loc, ipp_z} (missing keys
    omitted). Used by the slab-streaming ordering pass — a full
    read_dicom would pay the O(pixels) frombuffer + rescale per file
    just to read three tags.
    """
    data = Path(path).read_bytes()
    # encapsulated (RLE) PixelData has undefined length, skipped by the
    # generic skip_undefined walk below — header-only stays O(tags)
    r, ts = _open_dataset(data, path)
    meta: dict = {}
    while not r.eof():
        t, vr, length = r.element()
        if length == 0xFFFFFFFF:
            r.skip_undefined(vr)
            continue
        if t == _TAG_PIXEL_DATA:
            r.pos += length  # skip the pixels — header-only parse
            continue
        v = r.value(length)
        if t == _TAG_ROWS:
            meta["rows"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_COLS:
            meta["cols"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_FRAMES:
            try:
                meta["frames"] = int(v.decode("ascii").strip(" \x00") or 1)
            except ValueError:
                pass
        elif t == _TAG_PHOTOMETRIC:
            meta["photometric"] = v.decode("ascii", "replace").strip(" \x00")
        elif t == _TAG_BITS_STORED:
            meta["bits_stored"] = struct.unpack("<H", v[:2])[0]
        elif _parse_geometry_tag(t, v, meta):
            pass
    return meta


def read_dicom_frames(path: str | Path) -> tuple[np.ndarray, "DicomSlice"]:
    """Read a MULTI-frame uncompressed DICOM (cine ultrasound loop,
    breast-tomosynthesis stack, enhanced CT): [N, rows, cols] int16
    (HU-rescaled like read_dicom) plus a DicomSlice carrying the
    shared metadata. Single-frame files return [1, rows, cols].

    PS3.5: multi-frame PixelData is the N frames concatenated
    frame-major — exactly a reshape, no per-frame offsets. The 2-D
    reader REFUSES these files (it would silently drop N-1 frames)."""
    data = Path(path).read_bytes()
    r, ts = _open_dataset(data, path)
    meta: dict = {}
    pixel_bytes = None
    rle_frags = None
    while not r.eof():
        t, vr, length = r.element()
        if length == 0xFFFFFFFF:
            if t == _TAG_PIXEL_DATA and ts in _ENCAPSULATED:
                rle_frags = _read_encapsulated(r, path)
                continue
            r.skip_undefined(vr)
            continue
        if t == _TAG_PIXEL_DATA:
            pixel_bytes = r.value(length)
            continue
        v = r.value(length)
        if t == _TAG_ROWS:
            meta["rows"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_COLS:
            meta["cols"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_BITS_ALLOC:
            meta["bits"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_PIXEL_REP:
            meta["signed"] = struct.unpack("<H", v[:2])[0] == 1
        elif t == _TAG_FRAMES:
            try:
                meta["frames"] = int(v.decode("ascii").strip(" \x00") or 1)
            except ValueError:
                pass
        elif t == _TAG_PHOTOMETRIC:
            meta["photometric"] = v.decode("ascii", "replace").strip(" \x00")
        elif t == _TAG_SAMPLES:
            meta["samples"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_PLANAR:
            meta["planar"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_BITS_STORED:
            meta["bits_stored"] = struct.unpack("<H", v[:2])[0]
        elif t == _TAG_INTERCEPT:
            meta["intercept"] = float(v.decode("ascii").strip(" \x00") or 0)
        elif t == _TAG_SLOPE:
            meta["slope"] = float(v.decode("ascii").strip(" \x00") or 1)
        elif _parse_geometry_tag(t, v, meta):
            pass
    if (
        (pixel_bytes is None and rle_frags is None)
        or "rows" not in meta
        or "cols" not in meta
    ):
        raise ValueError(f"{path}: missing PixelData / Rows / Columns")
    rows, cols = meta["rows"], meta["cols"]
    bits = meta.get("bits", 16)
    if bits == 16:
        dt = np.int16 if meta.get("signed", False) else np.uint16
    elif bits == 8:
        dt = np.uint8
    else:
        raise NotImplementedError(f"BitsAllocated={bits}")
    spp = meta.get("samples", 1)
    if spp not in (1, 3):
        raise NotImplementedError(
            f"{path}: SamplesPerPixel={spp} (1 grayscale or 3 color)")
    if spp == 3 and bits != 8:
        raise NotImplementedError(
            f"{path}: {bits}-bit color DICOM (8-bit RGB/YBR supported)")
    if rle_frags is not None:
        px = _decode_encapsulated_pixeldata(rle_frags, meta, path, ts)
    elif spp == 3:
        n = max(1, meta.get("frames", 1))
        need = n * rows * cols * 3
        if len(pixel_bytes) < need:
            raise ValueError(
                f"{path}: PixelData holds {len(pixel_bytes)} bytes but "
                f"NumberOfFrames={n} at {rows}x{cols}x3x8bit needs "
                f"{need}"
            )
        flat = np.frombuffer(pixel_bytes[:need], np.uint8)
        if meta.get("planar", 0) == 1:
            px = flat.reshape(n, 3, rows, cols).transpose(0, 2, 3, 1)
        else:
            px = flat.reshape(n, rows, cols, 3)
        if meta.get("photometric", "RGB") == "YBR_FULL":
            from mies_tpu_torch.io.jpegdct import _ycbcr_to_rgb

            px = _ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2])
    else:
        n = max(1, meta.get("frames", 1))
        need = n * rows * cols * (bits // 8)
        if len(pixel_bytes) < need:
            raise ValueError(
                f"{path}: PixelData holds {len(pixel_bytes)} bytes but "
                f"NumberOfFrames={n} at {rows}x{cols}x{bits}bit needs {need}"
            )
        px = np.frombuffer(pixel_bytes[:need], dtype=dt).reshape(
            n, rows, cols
        )
    slope = meta.get("slope", 1.0)
    intercept = meta.get("intercept", 0.0)
    if slope != 1.0 or intercept != 0.0:
        px = np.clip(
            px.astype(np.float32) * slope + intercept, -32768, 32767
        ).astype(np.int16)
    info = DicomSlice(
        pixels=np.ascontiguousarray(px[0]),
        rows=rows,
        cols=cols,
        instance_number=meta.get("instance"),
        slice_location=meta.get("slice_loc"),
        image_position_z=meta.get("ipp_z"),
        pixel_spacing=meta.get("pixel_spacing"),
        slice_thickness=meta.get("slice_thickness"),
        rescale_slope=slope,
        rescale_intercept=intercept,
        photometric=meta.get("photometric", "MONOCHROME2"),
        bits_stored=meta.get("bits_stored"),
        transfer_syntax=ts,
    )
    return np.ascontiguousarray(px), info


def read_dicom_series(directory: str | Path, pattern: str = "*.dcm") -> np.ndarray:
    """Load a directory of DICOM slices into one [Z, H, W] int16 HU volume.

    Slices are ordered by ImagePositionPatient z, falling back to
    SliceLocation, then InstanceNumber, then filename.
    """
    paths = sorted(Path(directory).glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files in {directory}")
    slices = [read_dicom(p) for p in paths]

    def key(i_s):
        # IPP z and SliceLocation are both mm positions on the same
        # axis, so a slice missing one but carrying the other sorts in
        # the SAME tier (a tiered sort relocated mixed-metadata slices
        # to the end — silent anatomical misordering)
        i, s = i_s
        z = (
            s.image_position_z
            if s.image_position_z is not None
            else s.slice_location
        )
        if z is not None:
            return (0, z, 0)
        if s.instance_number is not None:
            return (1, s.instance_number, 0)
        return (2, 0, i)

    slices = [s for _, s in sorted(enumerate(slices), key=lambda t: key(t))]
    return np.stack([_to_int16_sat(s.pixels) for s in slices], axis=0)


def series_spacing(
    directory: str | Path, pattern: str = "*.dcm",
    max_headers: int = 16,
) -> tuple[float, float, float] | None:
    """(dz, dy, dx) voxel spacing in mm for a DICOM series, or None.

    dz is the MEDIAN z interval between position-sorted slices (the
    actual reconstruction interval — robust to one missing slice),
    falling back to SliceThickness; (dy, dx) from PixelSpacing
    (row, col). Header-only parses of at most ``max_headers`` files
    (filename-ordered — exported series name slices in scan order), so
    load_volume can call it unconditionally without a second
    full-series I/O pass.
    """
    paths = sorted(Path(directory).glob(pattern))[:max_headers]
    if not paths:
        return None
    heads = [read_dicom_header(p) for p in paths]
    spacing = next(
        (h.get("pixel_spacing") for h in heads if h.get("pixel_spacing")),
        None,
    )
    if spacing is None:
        return None
    zs = sorted(h["ipp_z"] for h in heads if "ipp_z" in h)
    dz = None
    if len(zs) >= 2:
        deltas = sorted(
            b - a for a, b in zip(zs, zs[1:]) if b - a > 0
        )
        if deltas:
            dz = deltas[len(deltas) // 2]  # median adjacent interval
    if dz is None:
        dz = next(
            (h.get("slice_thickness") for h in heads
             if h.get("slice_thickness")),
            None,
        )
    if dz is None or dz <= 0:
        return None
    dy, dx = spacing
    if dy <= 0 or dx <= 0:
        return None
    return (float(dz), float(dy), float(dx))


def _to_int16_sat(px: np.ndarray) -> np.ndarray:
    """Saturating int16 cast (np.clip on a uint8 array rejects an
    int16-range bound under numpy 2 — widen first)."""
    if px.dtype == np.int16:
        return px
    return np.clip(px.astype(np.int32), -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# Writer (explicit VR LE) — used by tests and the synthetic-data tools
# ---------------------------------------------------------------------------


def _el_short(tag: tuple[int, int], vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        # UI pads with NUL, text VRs pad with space (PS3.5 6.2)
        value += b"\x00" if vr == b"UI" else b" "
    return struct.pack("<HH", *tag) + vr + struct.pack("<H", len(value)) + value


def _el_long(tag: tuple[int, int], vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00"
    return struct.pack("<HH", *tag) + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value


def write_dicom(
    path: str | Path,
    pixels: np.ndarray,
    instance_number: int = 1,
    photometric: str | None = None,
    bits_stored: int | None = None,
    window: tuple[float, float] | None = None,
    slice_location: float | None = None,
    rescale_slope: float = 1.0,
    rescale_intercept: float = 0.0,
    image_position: tuple[float, float, float] | None = None,
    pixel_spacing: tuple[float, float] | None = None,
    slice_thickness: float | None = None,
    transfer_syntax: str = EXPLICIT_VR_LE,
    jpeg_quality: int = 90,
    jpegls_near: int | None = None,
    encoded_frames: list[bytes] | None = None,
    samples_per_pixel: int | None = None,
) -> None:
    """Write a minimal explicit-VR-LE Part-10 DICOM file (int16/uint8).

    ``pixels`` may be [H, W] (single frame) or [N, H, W] — the latter
    writes a MULTI-frame file (NumberOfFrames + frame-major PixelData,
    PS3.5's layout; read back with read_dicom_frames).
    ``transfer_syntax=RLE_LOSSLESS`` writes encapsulated PixelData
    (empty Basic Offset Table + one PS3.5 Annex G RLE fragment per
    frame); ``JPEG_LOSSLESS_SV1`` / ``JPEG_LOSSLESS_P14`` write one
    T.81 SOF3 codestream per frame (predictor 1);
    ``DEFLATED_EXPLICIT_VR_LE`` raw-deflates the whole post-meta
    dataset (PS3.5 A.5).

    ``JPEG_BASELINE`` (.4.50, uint8) / ``JPEG_EXTENDED`` (.4.51,
    uint8 or 12-bit uint16) write LOSSY sequential-DCT codestreams at
    ``jpeg_quality`` — choosing the syntax IS the lossy opt-in; pixel
    round-trips are NOT bit-exact (use RLE/JPEG Lossless for archives).

    ``JPEG_LS_LOSSLESS`` (.4.80) writes T.87 NEAR=0 (bit-exact);
    ``JPEG_LS_NEAR`` (.4.81) bounds each sample's error by
    ``jpegls_near`` (default 2, must be >= 1 for this syntax).

    ``JPEG_2000_LOSSLESS`` (.4.90) writes reversible-5/3 codestreams
    natively (io/jpeg2k.py's encoder: single tile, one quality layer,
    LRCP — bit-exact round trips, cross-checked against OpenJPEG);
    ``bits_stored`` tightens the declared sample depth.

    Color: pixels shaped ``[H, W, 3]`` / ``[N, H, W, 3]`` (uint8) are
    inferred as interleaved RGB (SamplesPerPixel=3); pass
    ``samples_per_pixel=1`` to pin the pathological [N, H, 3]
    3-px-wide grayscale reading, or 3 to assert color.

    ``encoded_frames`` is the transcode passthrough: pre-encoded
    codestream blobs (one per frame) written verbatim as the
    encapsulated fragments — the only way to WRITE lossy JPEG 2000
    (.4.91, no in-tree rate control).  ``pixels`` still supplies
    Rows/Columns/BitsAllocated and must match what the blobs decode
    to; the caller owns that consistency.
    """
    if transfer_syntax not in (
        EXPLICIT_VR_LE,
        DEFLATED_EXPLICIT_VR_LE,
    ) + _ENCAPSULATED:
        accepted = ", ".join(
            (EXPLICIT_VR_LE, DEFLATED_EXPLICIT_VR_LE) + _ENCAPSULATED
        )
        raise ValueError(
            f"write_dicom accepts transfer_syntax in [{accepted}] "
            f"(Explicit VR LE plain/Deflated and the encapsulated "
            f"codecs; lossy JPEG 2000 .4.91 needs encoded_frames=), "
            f"got {transfer_syntax!r}"
        )
    pixels = np.asarray(pixels)
    if pixels.dtype == np.int16:
        bits, signed = 16, 1
    elif pixels.dtype == np.uint16:
        bits, signed = 16, 0
    elif pixels.dtype == np.uint8:
        bits, signed = 8, 0
    else:
        raise TypeError(f"unsupported dtype {pixels.dtype}")
    # color: a trailing length-3 axis is inferred as interleaved RGB
    # ([H, W, 3] single frame or [N, H, W, 3] multi-frame,
    # SamplesPerPixel=3, PlanarConfiguration=0). A [N, H, 3] array is
    # AMBIGUOUS (one color frame vs N frames of 3-px-wide grayscale) —
    # the inference picks color; pass samples_per_pixel=1 to pin the
    # pathological grayscale reading.
    if samples_per_pixel is None:
        spp = 3 if pixels.ndim in (3, 4) and pixels.shape[-1] == 3 \
            else 1
    elif samples_per_pixel in (1, 3):
        spp = samples_per_pixel
        if spp == 3 and (pixels.ndim not in (3, 4)
                         or pixels.shape[-1] != 3):
            raise ValueError(
                f"samples_per_pixel=3 needs [H, W, 3] or [N, H, W, 3] "
                f"pixels, got {pixels.shape}")
    else:
        raise ValueError(
            f"samples_per_pixel must be None, 1 or 3, got "
            f"{samples_per_pixel!r}")
    if pixels.ndim == 4 and spp != 3:
        raise ValueError(f"pixels must be [H, W], [N, H, W], "
                         f"[H, W, 3] or [N, H, W, 3], got {pixels.shape}")
    if spp == 3:
        if pixels.dtype != np.uint8:
            raise TypeError(
                f"color pixels must be uint8, got {pixels.dtype}")
        if pixels.ndim == 4:
            nframes = pixels.shape[0]
            rows, cols = pixels.shape[1:3]
        else:
            nframes = 1
            rows, cols = pixels.shape[:2]
    elif pixels.ndim == 3:
        nframes = pixels.shape[0]
        rows, cols = pixels.shape[1:]
    elif pixels.ndim == 2:
        nframes = 1
        rows, cols = pixels.shape
    else:
        raise ValueError(f"pixels must be [H, W] or [N, H, W], got "
                         f"{pixels.shape}")
    if spp == 3 and photometric is None:
        # PS3.3 C.7.6.3.1.3: .4.90's reversible RCT is YBR_RCT
        photometric = ("YBR_RCT"
                       if transfer_syntax in (JPEG_2000_LOSSLESS,
                                              HTJ2K_LOSSLESS,
                                              HTJ2K_LOSSLESS_RPCL)
                       and encoded_frames is None else "RGB")

    meta_body = _el_short(_TAG_TS_UID, b"UI", transfer_syntax.encode())
    meta = _el_short((0x0002, 0x0000), b"UL", struct.pack("<I", len(meta_body))) + meta_body

    # PS3.5 7.1: data-set elements must appear in ascending tag order
    # (strict readers binary-search or bail on regressions; our linear
    # scanner doesn't care, but written files must conform)
    ds = b""
    if slice_thickness is not None:  # (0018,0050)
        ds += _el_short(
            _TAG_SLICE_THICK, b"DS", f"{slice_thickness:.4f}".encode())
    ds += _el_short(_TAG_INSTANCE, b"IS", str(instance_number).encode())
    if image_position is not None:  # (0020,0032)
        ds += _el_short(
            _TAG_IPP, b"DS",
            "\\".join(f"{v:.3f}" for v in image_position).encode(),
        )
    if slice_location is not None:  # (0020,1041)
        ds += _el_short(_TAG_SLICE_LOC, b"DS", f"{slice_location:.3f}".encode())
    if spp == 3:  # (0028,0002) sorts before photometric (0028,0004)
        ds += _el_short(_TAG_SAMPLES, b"US", struct.pack("<H", 3))
    if photometric is not None:  # (0028,0004)
        ds += _el_short(
            _TAG_PHOTOMETRIC, b"CS",
            photometric.encode() + (b" " if len(photometric) % 2 else b""),
        )
    if spp == 3:  # (0028,0006): interleaved
        ds += _el_short(_TAG_PLANAR, b"US", struct.pack("<H", 0))
    if nframes > 1:  # (0028,0008) sorts before Rows (0028,0010)
        ds += _el_short(_TAG_FRAMES, b"IS", str(nframes).encode())
    ds += _el_short(_TAG_ROWS, b"US", struct.pack("<H", rows))
    ds += _el_short(_TAG_COLS, b"US", struct.pack("<H", cols))
    if pixel_spacing is not None:  # (0028,0030)
        ds += _el_short(
            _TAG_PIXEL_SPACING, b"DS",
            "\\".join(f"{v:.4f}" for v in pixel_spacing).encode(),
        )
    ds += _el_short(_TAG_BITS_ALLOC, b"US", struct.pack("<H", bits))
    if bits_stored is not None:  # (0028,0101) between 0100 and 0103
        ds += _el_short(_TAG_BITS_STORED, b"US",
                        struct.pack("<H", bits_stored))
    ds += _el_short(_TAG_PIXEL_REP, b"US", struct.pack("<H", signed))
    if window is not None:  # (0028,1050/1051) before rescale 1052/1053
        ds += _el_short(_TAG_WIN_CENTER, b"DS", f"{window[0]:g}".encode())
        ds += _el_short(_TAG_WIN_WIDTH, b"DS", f"{window[1]:g}".encode())
    if rescale_intercept != 0.0 or rescale_slope != 1.0:
        ds += _el_short(_TAG_INTERCEPT, b"DS", f"{rescale_intercept:g}".encode())
        ds += _el_short(_TAG_SLOPE, b"DS", f"{rescale_slope:g}".encode())
    if transfer_syntax in (JPEG_2000, HTJ2K) and encoded_frames is None:
        raise NotImplementedError(
            "write_dicom does not rate-control the lossy JPEG 2000 "
            f"syntaxes ({JPEG_2000}, {HTJ2K}) — pass pre-encoded "
            "codestreams via encoded_frames=, or use "
            f"JPEG_2000_LOSSLESS (.4.90) / HTJ2K_LOSSLESS (.4.201): "
            "the in-tree reversible 5/3 encoders write those natively"
        )
    if encoded_frames is not None and transfer_syntax not in _ENCAPSULATED:
        raise ValueError(
            f"encoded_frames requires an encapsulated transfer syntax, "
            f"got {transfer_syntax!r}"
        )
    if transfer_syntax in _ENCAPSULATED:
        # encapsulated: undefined-length OB + BOT item + frame items
        if spp == 3:
            if encoded_frames is None and transfer_syntax not in (
                    JPEG_2000_LOSSLESS, HTJ2K_LOSSLESS,
                    HTJ2K_LOSSLESS_RPCL, RLE_LOSSLESS):
                raise NotImplementedError(
                    "write_dicom's native color encoders are JPEG "
                    "2000 Lossless (.4.90, reversible RCT) and RLE "
                    "Lossless — use those, encoded_frames= (e.g. "
                    "Pillow JPEG blobs for JPEG Baseline), or "
                    "uncompressed Explicit VR LE"
                )
            frames = pixels if pixels.ndim == 4 else pixels[None]
        else:
            frames = pixels if pixels.ndim == 3 else pixels[None]
        if encoded_frames is not None and len(encoded_frames) != len(frames):
            raise ValueError(
                f"{len(encoded_frames)} encoded_frames for "
                f"{len(frames)} frame(s) of pixel metadata"
            )
        ds += (
            struct.pack("<HH", *_TAG_PIXEL_DATA)
            + b"OB\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF)
        )
        ds += struct.pack("<HHI", *_ITEM, 0)  # empty Basic Offset Table
        if transfer_syntax in _JPEG_DCT:
            if transfer_syntax == JPEG_BASELINE and bits != 8:
                raise TypeError(
                    "JPEG Baseline (.4.50) carries 8-bit samples; got "
                    f"{pixels.dtype} — use JPEG_EXTENDED (12-bit) or a "
                    "lossless syntax"
                )
            if pixels.dtype == np.int16:
                raise TypeError(
                    "lossy JPEG has no bit-preserving signed convention; "
                    "rescale to uint8/uint16 first or use RLE/JPEG "
                    "Lossless for int16 HU data"
                )
            if bits == 16 and int(pixels.max(initial=0)) >= 4096:
                raise ValueError(
                    "JPEG Extended 12-bit samples must be < 4096; got "
                    f"max {int(pixels.max())}"
                )
        if transfer_syntax in _JPEG_LS:
            if transfer_syntax == JPEG_LS_LOSSLESS:
                if jpegls_near not in (None, 0):
                    raise ValueError(
                        "JPEG-LS Lossless (.4.80) is NEAR=0 by "
                        f"definition; got jpegls_near={jpegls_near} — "
                        "use JPEG_LS_NEAR (.4.81) for near-lossless"
                    )
                near = 0
            else:
                near = 2 if jpegls_near is None else jpegls_near
                if near < 1:
                    raise ValueError(
                        "JPEG-LS Near-Lossless (.4.81) needs "
                        f"jpegls_near >= 1, got {near} — use "
                        "JPEG_LS_LOSSLESS (.4.80) for exact coding"
                    )
        for i, fr in enumerate(frames):
            if encoded_frames is not None:
                blob = bytes(encoded_frames[i])
            elif transfer_syntax == RLE_LOSSLESS:
                blob = _rle_encode_frame(fr)
            elif transfer_syntax in _JPEG_DCT:
                from mies_tpu_torch.io.jpegdct import encode_jpeg_dct

                blob = encode_jpeg_dct(fr, quality=jpeg_quality)
            elif transfer_syntax in _JPEG_LS:
                from mies_tpu_torch.io.jpegls import encode_jpegls

                blob = encode_jpegls(fr, near=near)
            elif transfer_syntax in (JPEG_2000_LOSSLESS, HTJ2K_LOSSLESS,
                                     HTJ2K_LOSSLESS_RPCL):
                from mies_tpu_torch.io.jpeg2k import encode_jpeg2k

                # reversible 5/3, single tile/layer — the clinical
                # archive profile; BitsStored tightens the declared
                # depth (values are range-checked there).  The HT
                # syntaxes swap the classic EBCOT coder for T.814
                # cleanup-only HT codeblocks (io/htj2k.py); .4.202
                # additionally mandates RPCL packet progression
                blob = encode_jpeg2k(
                    fr, depth=bits_stored,
                    ctx=f"{path} frame {i}" if nframes > 1 else str(path),
                    ht=transfer_syntax != JPEG_2000_LOSSLESS,
                    prog=2 if transfer_syntax == HTJ2K_LOSSLESS_RPCL
                    else 0,
                )
            else:
                from mies_tpu_torch.io.jpegll import encode_jpeg_lossless

                blob = encode_jpeg_lossless(fr, predictor=1)
            if len(blob) % 2:
                blob += b"\x00"
            ds += struct.pack("<HHI", *_ITEM, len(blob)) + blob
        ds += struct.pack("<HHI", *_SEQ_DELIM, 0)
    else:
        ds += _el_long(
            _TAG_PIXEL_DATA, b"OW" if bits == 16 else b"OB", pixels.tobytes()
        )

    if transfer_syntax == DEFLATED_EXPLICIT_VR_LE:
        co = zlib.compressobj(level=6, wbits=-15)  # raw deflate, PS3.5 A.5
        ds = co.compress(ds) + co.flush()

    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + meta + ds)
