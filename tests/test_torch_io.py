"""The port's file I/O (``mies_tpu_torch.io``, ``mies_tpu_torch.native``)
against the JAX package's (``mies_tpu.io``, ``mies_tpu.native``).

Every format is written by the JAX package's writer or encoder and read
back through both packages: equal arrays, dtypes and metadata. The
port's writers and encoders give files byte-identical to the JAX
package's on the same input, and the port's native (C++) decoders, built
into ``mies_tpu_torch/_build/``, equal their Python twins. Frames are
about 64x48 so the Python J2K paths stay fast.
"""

from __future__ import annotations

import dataclasses
import struct

import h5py
import numpy as np
import pytest
from PIL import Image

import mies_tpu.io.dicom as jdicom
import mies_tpu.io.htj2k as jht
import mies_tpu.io.image as jimage
import mies_tpu.io.jpeg2k as jj2k
import mies_tpu.io.jpegdct as jdct
import mies_tpu.io.jpegll as jll
import mies_tpu.io.jpegls as jls
import mies_tpu.io.netcdf3 as jnc
import mies_tpu.io.volume as jvolume
import mies_tpu_torch.io.dicom as tdicom
import mies_tpu_torch.io.htj2k as tht
import mies_tpu_torch.io.image as timage
import mies_tpu_torch.io.jpeg2k as tj2k
import mies_tpu_torch.io.jpegdct as tdct
import mies_tpu_torch.io.jpegll as tll
import mies_tpu_torch.io.jpegls as tls
import mies_tpu_torch.io.netcdf3 as tnc
import mies_tpu_torch.io.volume as tvolume
from mies_tpu_torch import native as tnative

H, W = 48, 64


def _frames(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    smooth = (np.sin(y / 5.0) + np.cos(x / 7.0) + 2.0) / 4.0  # [0, 1]
    return {
        "u8": (smooth * 200 + rng.integers(0, 40, (H, W))).astype(np.uint8),
        "u16": (smooth * 3500 + rng.integers(0, 500, (H, W))).astype(np.uint16),
        "i16": (smooth * 2000 - 1000 + rng.integers(0, 60, (H, W))).astype(np.int16),
        "rgb": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
    }


FRAMES = _frames()


def _slice_meta(s) -> dict:
    d = dataclasses.asdict(s)
    d.pop("pixels")
    return d


def _same_arrays(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# DICOM: every transfer syntax the writer takes, written by both packages
# ---------------------------------------------------------------------------

DICOM_CASES = {
    "explicit-i16-rescale": ("EXPLICIT_VR_LE", "i16", dict(
        rescale_slope=1.0, rescale_intercept=-1024.0, window=(40.0, 400.0),
        image_position=(0.0, 0.0, 12.5), pixel_spacing=(0.7, 0.7),
        slice_thickness=1.25, instance_number=7, slice_location=12.5)),
    "explicit-u16": ("EXPLICIT_VR_LE", "u16", dict(bits_stored=12)),
    "explicit-u8-mono1": ("EXPLICIT_VR_LE", "u8", dict(photometric="MONOCHROME1")),
    "explicit-rgb": ("EXPLICIT_VR_LE", "rgb", {}),
    "deflate-i16": ("DEFLATED_EXPLICIT_VR_LE", "i16", {}),
    "rle-i16": ("RLE_LOSSLESS", "i16", {}),
    "rle-u8": ("RLE_LOSSLESS", "u8", {}),
    "rle-rgb": ("RLE_LOSSLESS", "rgb", {}),
    "jpegll-sv1-u16": ("JPEG_LOSSLESS_SV1", "u16", {}),
    "jpegll-p14-i16": ("JPEG_LOSSLESS_P14", "i16", {}),
    "jpeg-baseline-u8": ("JPEG_BASELINE", "u8", dict(jpeg_quality=85)),
    "jpeg-extended-u16": ("JPEG_EXTENDED", "u16", {}),
    "jpegls-u16": ("JPEG_LS_LOSSLESS", "u16", {}),
    "jpegls-near-u8": ("JPEG_LS_NEAR", "u8", dict(jpegls_near=2)),
    "j2k-u16": ("JPEG_2000_LOSSLESS", "u16", dict(bits_stored=12)),
    "j2k-rgb": ("JPEG_2000_LOSSLESS", "rgb", {}),
    "htj2k-u16": ("HTJ2K_LOSSLESS", "u16", {}),
    "htj2k-rpcl-i16": ("HTJ2K_LOSSLESS_RPCL", "i16", {}),
}
LOSSLESS = {"EXPLICIT_VR_LE", "DEFLATED_EXPLICIT_VR_LE", "RLE_LOSSLESS",
            "JPEG_LOSSLESS_SV1", "JPEG_LOSSLESS_P14", "JPEG_LS_LOSSLESS",
            "JPEG_2000_LOSSLESS", "HTJ2K_LOSSLESS", "HTJ2K_LOSSLESS_RPCL"}


@pytest.mark.parametrize("case", sorted(DICOM_CASES))
def test_write_dicom_is_byte_identical_and_reads_alike(tmp_path, case):
    ts, frame, kw = DICOM_CASES[case]
    px = FRAMES[frame]
    a, b = tmp_path / "jax.dcm", tmp_path / "port.dcm"
    jdicom.write_dicom(a, px, transfer_syntax=getattr(jdicom, ts), **kw)
    tdicom.write_dicom(b, px, transfer_syntax=getattr(tdicom, ts), **kw)
    assert a.read_bytes() == b.read_bytes()
    ref, got = jdicom.read_dicom(a), tdicom.read_dicom(a)
    _same_arrays(ref.pixels, got.pixels)
    assert _slice_meta(ref) == _slice_meta(got)
    assert jdicom.read_dicom_header(a) == tdicom.read_dicom_header(a)
    channels = "per-channel" if frame == "rgb" else None
    _same_arrays(jimage.load_image(a, dtype="raw", channels=channels),
                 timage.load_image(a, dtype="raw", channels=channels))
    if ts in LOSSLESS and "rescale_intercept" not in kw:
        np.testing.assert_array_equal(got.pixels, px)


def test_dicom_multiframe_reads_alike(tmp_path):
    vol = np.stack([FRAMES["i16"] + k for k in range(3)]).astype(np.int16)
    p = tmp_path / "mf.dcm"
    jdicom.write_dicom(p, vol, transfer_syntax=jdicom.RLE_LOSSLESS,
                       slice_thickness=2.0, pixel_spacing=(0.5, 0.5))
    (rv, rs), (tv, ts) = jdicom.read_dicom_frames(p), tdicom.read_dicom_frames(p)
    _same_arrays(rv, tv)
    assert _slice_meta(rs) == _slice_meta(ts)
    (ra, rm), (ta, tm) = jvolume.load_volume(p), tvolume.load_volume(p)
    _same_arrays(ra, ta)
    assert dataclasses.asdict(rm) == dataclasses.asdict(tm)


def _implicit_dataset(px: np.ndarray) -> bytes:
    def el(group, elem, value):
        return struct.pack("<HHI", group, elem, len(value)) + value

    return (el(0x0020, 0x0013, b"5 ")
            + el(0x0028, 0x0010, struct.pack("<H", px.shape[0]))
            + el(0x0028, 0x0011, struct.pack("<H", px.shape[1]))
            + el(0x0028, 0x0100, struct.pack("<H", 16))
            + el(0x0028, 0x0103, struct.pack("<H", 1))
            + el(0x7FE0, 0x0010, px.tobytes()))


@pytest.mark.parametrize("form", ["part10", "bare"])
def test_implicit_vr_reads_alike(tmp_path, form):
    """Implicit VR Little Endian (1.2.840.10008.1.2), as a Part-10 file
    and as a preamble-less dump (the native parser refuses the latter;
    both packages fall back to the Python reader)."""
    px = FRAMES["i16"]
    ds = _implicit_dataset(px)
    if form == "part10":
        uid = b"1.2.840.10008.1.2\x00"
        body = struct.pack("<HH", 2, 0x10) + b"UI" + struct.pack("<H", len(uid)) + uid
        meta = (struct.pack("<HH", 2, 0) + b"UL" + struct.pack("<H", 4)
                + struct.pack("<I", len(body)) + body)
        ds = b"\x00" * 128 + b"DICM" + meta + ds
    p = tmp_path / "implicit.dcm"
    p.write_bytes(ds)
    ref, got = jdicom.read_dicom(p), tdicom.read_dicom(p)
    _same_arrays(ref.pixels, got.pixels)
    np.testing.assert_array_equal(got.pixels, px)
    assert _slice_meta(ref) == _slice_meta(got)
    _same_arrays(jimage.load_image(p, dtype="raw"),
                 timage.load_image(p, dtype="raw"))


def _write_series(d, writer, n=5):
    """A shuffled-order CT series: positions descending in file order."""
    d.mkdir()
    for i in range(n):
        writer(d / f"s{i:02d}.dcm", (FRAMES["i16"] + 10 * i).astype(np.int16),
               instance_number=n - i, slice_location=float(n - i),
               image_position=(0.0, 0.0, 2.5 * (n - i)),
               pixel_spacing=(0.8, 0.8), rescale_intercept=0.0)


def test_dicom_series_directory_reads_alike(tmp_path):
    d = tmp_path / "series"
    _write_series(d, jdicom.write_dicom)
    (rv, rm), (tv, tm) = jvolume.load_volume(d), tvolume.load_volume(d)
    _same_arrays(rv, tv)
    assert dataclasses.asdict(rm) == dataclasses.asdict(tm)
    assert tm.source.startswith("dicom-series-native:")
    _same_arrays(jdicom.read_dicom_series(d), tdicom.read_dicom_series(d))
    assert jdicom.series_spacing(d) == tdicom.series_spacing(d)
    (rm2, rs), (tm2, ts) = (jvolume.open_volume_slabs(d, slab_size=2),
                            tvolume.open_volume_slabs(d, slab_size=2))
    assert dataclasses.asdict(rm2) == dataclasses.asdict(tm2)
    for a, b in zip(rs, ts, strict=True):
        _same_arrays(a, b)
    # slice order follows the positions, not the file names
    np.testing.assert_array_equal(tv[0], FRAMES["i16"] + 40)


# ---------------------------------------------------------------------------
# Codecs: byte-identical encodes, equal decodes
# ---------------------------------------------------------------------------

CODEC_CASES = {
    "jpegll-p1-u16": (jll.encode_jpeg_lossless, tll.encode_jpeg_lossless,
                      jll.decode_jpeg_lossless, tll.decode_jpeg_lossless,
                      "u16", dict(predictor=1)),
    "jpegll-p7-u8-restart": (jll.encode_jpeg_lossless, tll.encode_jpeg_lossless,
                             jll.decode_jpeg_lossless, tll.decode_jpeg_lossless,
                             "u8", dict(predictor=7, restart_rows=5)),
    "jpegdct-u8": (jdct.encode_jpeg_dct, tdct.encode_jpeg_dct,
                   jdct.decode_jpeg_dct, tdct.decode_jpeg_dct, "u8",
                   dict(quality=75)),
    "jpegdct-u16-12bit": (jdct.encode_jpeg_dct, tdct.encode_jpeg_dct,
                          jdct.decode_jpeg_dct, tdct.decode_jpeg_dct, "u16",
                          dict(quality=90, restart_blocks=4)),
    "jpegls-i16": (jls.encode_jpegls, tls.encode_jpegls, jls.decode_jpegls,
                   tls.decode_jpegls, "i16", {}),
    "jpegls-near3-u16": (jls.encode_jpegls, tls.encode_jpegls,
                         jls.decode_jpegls, tls.decode_jpegls, "u16",
                         dict(near=3)),
    "j2k-u8": (jj2k.encode_jpeg2k, tj2k.encode_jpeg2k, jj2k.decode_jpeg2k,
               tj2k.decode_jpeg2k, "u8", dict(levels=3)),
    "j2k-ht-u16": (jj2k.encode_jpeg2k, tj2k.encode_jpeg2k, jj2k.decode_jpeg2k,
                   tj2k.decode_jpeg2k, "u16", dict(depth=12, ht=True)),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_encodes_byte_identical_and_decodes_alike(case):
    jenc, tenc, jdec, tdec, frame, kw = CODEC_CASES[case]
    px = FRAMES[frame]
    blob = jenc(px, **kw)
    assert tenc(px, **kw) == blob
    _same_arrays(jdec(blob), tdec(blob))


def test_ht_block_encodes_byte_identical_and_decodes_alike():
    rng = np.random.default_rng(3)
    coeffs = rng.integers(-300, 300, (16, 24)).astype(np.int32)
    coeffs[rng.random((16, 24)) < 0.4] = 0
    seg, zbp = jht.encode_ht_block(coeffs, 12)
    assert tht.encode_ht_block(coeffs, 12) == (seg, zbp)
    ref = jht.decode_ht_block(seg, 24, 16, zbp, 1, 12)
    got = tht.decode_ht_block(seg, 24, 16, zbp, 1, 12)
    _same_arrays(np.asarray(ref), np.asarray(got))


# ---------------------------------------------------------------------------
# 2-D images: PNG 8/16-bit, the channels policy, save_image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["png8", "png16", "rgb-gray", "rgb-per-channel",
                                  "rgb-refused"])
@pytest.mark.parametrize("dtype", ["raw", "float32"])
def test_load_image_png_reads_alike(tmp_path, kind, dtype):
    p = tmp_path / "img.png"
    if kind == "png8":
        Image.fromarray(FRAMES["u8"]).save(p)
    elif kind == "png16":
        Image.fromarray(FRAMES["u16"]).save(p)
    else:
        Image.fromarray(FRAMES["rgb"]).save(p)
    channels = {"rgb-gray": "gray", "rgb-per-channel": "per-channel"}.get(kind)
    if kind == "rgb-refused":
        for mod in (jimage, timage):
            with pytest.raises(ValueError, match="multiple channels"):
                mod.load_image(p, dtype=dtype, channels=channels)
        return
    _same_arrays(jimage.load_image(p, dtype=dtype, channels=channels),
                 timage.load_image(p, dtype=dtype, channels=channels))


@pytest.mark.parametrize("suffix", [".png", ".tif", ".dcm"])
@pytest.mark.parametrize("arr", ["u8", "float", "chw"])
def test_save_image_is_byte_identical(tmp_path, suffix, arr):
    a = {"u8": FRAMES["u8"],
         "float": FRAMES["u8"].astype(np.float32) / 255.0,
         "chw": np.ascontiguousarray(FRAMES["rgb"].transpose(2, 0, 1))}[arr]
    jimage.save_image(tmp_path / f"j{suffix}", a)
    timage.save_image(tmp_path / f"t{suffix}", a)
    assert (tmp_path / f"j{suffix}").read_bytes() == (tmp_path / f"t{suffix}").read_bytes()


def test_to_float_from_float_equal():
    for a in (FRAMES["u8"], FRAMES["u16"], FRAMES["i16"]):
        _same_arrays(jimage.to_float(a), timage.to_float(a))
    f = np.linspace(-0.1, 1.1, H * W, dtype=np.float32).reshape(H, W)
    _same_arrays(jimage.from_float(f), timage.from_float(f))


# ---------------------------------------------------------------------------
# Volumes: .npy, .npz, classic and CDF-2 .nc, HDF5 .nc, DICOM directories
# ---------------------------------------------------------------------------

def _volume(dtype) -> np.ndarray:
    rng = np.random.default_rng(11)
    if dtype == np.int16:
        return rng.integers(-1000, 2000, (6, H, W), dtype=np.int16)
    if dtype == np.uint8:
        return rng.integers(0, 256, (6, H, W), dtype=np.uint8)
    return rng.random((6, H, W), dtype=np.float32)


def _read_both(p, var=None, slab=4):
    (rv, rm), (tv, tm) = jvolume.load_volume(p, var), tvolume.load_volume(p, var)
    _same_arrays(rv, tv)
    assert dataclasses.asdict(rm) == dataclasses.asdict(tm)
    (rm2, rs), (tm2, ts) = (jvolume.open_volume_slabs(p, slab, var),
                            tvolume.open_volume_slabs(p, slab, var))
    assert dataclasses.asdict(rm2) == dataclasses.asdict(tm2)
    slabs = list(ts)
    for a, b in zip(rs, slabs, strict=True):
        _same_arrays(a, b)
    _same_arrays(np.concatenate(slabs), tv)
    return tv


@pytest.mark.parametrize("suffix", [".npy", ".nc", ".npz", ""])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_save_volume_is_byte_identical_and_reads_alike(tmp_path, suffix, dtype):
    if suffix == "" and dtype == np.float32:
        for mod in (jvolume, tvolume):  # DICOM carries no float32
            with pytest.raises(TypeError):
                mod.save_volume(tmp_path / "f", _volume(dtype))
        return
    vol = _volume(dtype)
    a, b = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    jvolume.save_volume(a, vol)
    tvolume.save_volume(b, vol)
    if suffix in (".npy", ".nc"):
        assert a.read_bytes() == b.read_bytes()
    elif suffix == "":
        names = sorted(f.name for f in a.iterdir())
        assert names == sorted(f.name for f in b.iterdir()) and len(names) == 6
        for n in names:
            assert (a / n).read_bytes() == (b / n).read_bytes()
    got = _read_both(a)
    np.testing.assert_array_equal(got, vol if suffix else vol.astype(np.int16))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_netcdf3_writer_appends_byte_identical(tmp_path, dtype):
    vol = _volume(dtype)
    for mod, name in ((jnc, "j.nc"), (tnc, "t.nc")):
        with mod.NetCDF3VolumeWriter(tmp_path / name, vol.shape, dtype,
                                     var_name="v", attrs={"units": "HU"}) as w:
            for k in (0, 1, 4):
                w.append(vol[k : {0: 1, 1: 4, 4: 6}[k]])
    assert (tmp_path / "j.nc").read_bytes() == (tmp_path / "t.nc").read_bytes()
    _read_both(tmp_path / "t.nc", var="v")


def test_netcdf_cdf2_reads_alike(tmp_path):
    """A CDF-2 (64-bit offset) classic file, as scipy writes it."""
    from scipy.io import netcdf_file

    vol = _volume(np.int16)
    p = tmp_path / "cdf2.nc"
    with netcdf_file(p, "w", version=2) as f:
        for n, s in zip("zyx", vol.shape):
            f.createDimension(n, s)
        f.createVariable("other", "f4", ("x",))[:] = np.arange(W)
        f.createVariable("ct", "i2", ("z", "y", "x"))[:] = vol
    assert p.read_bytes()[:4] == b"CDF\x02"
    got = _read_both(p)
    np.testing.assert_array_equal(got, vol)
    _read_both(p, var="ct", slab=5)


@pytest.mark.parametrize("layout", ["contiguous", "chunked-gzip-shuffle",
                                    "chunked-ragged"])
def test_hdf5_netcdf4_reads_alike(tmp_path, layout):
    vol = _volume(np.int16)
    p = tmp_path / "v.nc"
    with h5py.File(p, "w") as f:
        if layout == "contiguous":
            f.create_dataset("ct", data=vol)
        elif layout == "chunked-gzip-shuffle":
            f.create_dataset("ct", data=vol, chunks=(2, 16, 32),
                             compression="gzip", shuffle=True)
        else:
            f.create_dataset("ct", data=vol, chunks=(4, 20, 30))
        f.create_dataset("aux", data=np.arange(7, dtype=np.float32))
    got = _read_both(p)
    np.testing.assert_array_equal(got, vol)


# ---------------------------------------------------------------------------
# Native (C++) twins on the port's copy, built into mies_tpu_torch/_build/
# ---------------------------------------------------------------------------

def test_native_builds_into_the_port_build_dir():
    assert tnative.available(), tnative._build_error
    assert tnative._SO.parent.name == "_build"
    assert tnative._SO.parent.parent.name == "mies_tpu_torch"
    assert tnative._SO.is_file()


@pytest.mark.parametrize("frame,kw", [
    ("i16", dict(rescale_slope=1.0, rescale_intercept=-1024.0)),
    ("i16", {}), ("u16", {}), ("u8", {}),
    ("u16", dict(transfer_syntax=tdicom.RLE_LOSSLESS)),
    ("u8", dict(transfer_syntax=tdicom.JPEG_LS_LOSSLESS)),
])
def test_native_read_equals_python_twin(tmp_path, frame, kw):
    p = tmp_path / "s.dcm"
    tdicom.write_dicom(p, FRAMES[frame], instance_number=3, slice_location=7.5, **kw)
    px, meta = tnative.read_dicom_native(p)
    _same_arrays(px, tdicom.read_dicom(p).pixels)
    assert meta["instance"] == 3 and meta["slice_loc"] == 7.5


def test_native_series_equals_python_twin(tmp_path):
    d = tmp_path / "series"
    _write_series(d, tdicom.write_dicom)
    _same_arrays(tnative.read_dicom_series_native(d), tdicom.read_dicom_series(d))


def test_native_refuses_garbage(tmp_path):
    p = tmp_path / "bad.dcm"
    p.write_bytes(b"not a dicom file at all")
    with pytest.raises(ValueError):
        tnative.read_dicom_native(p)


def test_native_t1_and_ht_equal_python_twins():
    rng = np.random.default_rng(5)
    for t in range(6):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        numbps = int(rng.integers(1, 13))
        band = ["LL", "HL", "LH", "HH"][t % 4]
        mag = rng.integers(0, 1 << numbps, (h, w)).astype(np.int32)
        chi = rng.integers(0, 2, (h, w)).astype(np.uint8)
        pd, pn = tj2k._t1_encode_block(mag, chi, band, numbps)
        assert tnative.t1_encode(mag, chi, band, numbps) == (pd, pn)
        m1, c1, u1 = tj2k._t1_decode_block(w, h, band, pd, pn, numbps)
        m2, c2, u2 = tnative.t1_decode(pd, w, h, band, pn, numbps)
        _same_arrays(m1, m2)
        _same_arrays(c1, c2)
        assert u1 == u2
    coeffs = rng.integers(-200, 200, (16, 16)).astype(np.int32)
    seg, zbp = tnative.ht_encode(coeffs, 10)
    mag, sgn = tnative.ht_decode(seg, 16, 16, zbp)
    np.testing.assert_array_equal(np.where(sgn == 1, -mag, mag), coeffs)


@pytest.mark.parametrize("codec", ["j2k", "jpegdct"])
def test_native_stream_paths_equal_python(monkeypatch, codec):
    if codec == "j2k":
        img = FRAMES["u16"]
        monkeypatch.setenv("MIES_TPU_J2K_NATIVE", "0")
        blob_py = tj2k.encode_jpeg2k(img, depth=12)
        out_py = tj2k.decode_jpeg2k(blob_py)
        monkeypatch.setenv("MIES_TPU_J2K_NATIVE", "1")
        assert tj2k.encode_jpeg2k(img, depth=12) == blob_py
        _same_arrays(tj2k.decode_jpeg2k(blob_py), out_py)
        np.testing.assert_array_equal(out_py, img)
    else:
        blob = tdct.encode_jpeg_dct(FRAMES["u8"], quality=80, restart_blocks=3)
        monkeypatch.setenv("MIES_TPU_JPEG_NATIVE", "0")
        out_py = tdct.decode_jpeg_dct(blob)
        monkeypatch.setenv("MIES_TPU_JPEG_NATIVE", "1")
        _same_arrays(tdct.decode_jpeg_dct(blob), out_py)


# ---------------------------------------------------------------------------
# The port's own repairs of the codec copies (faults the reference shares)
# ---------------------------------------------------------------------------


def _two_layer_ht_stream(frame: np.ndarray) -> tuple[bytes, bytes]:
    """(two-layer stream, one-layer stream) of one uint8 frame of at most
    64x64 at 0 DWT levels: one code-block, one packet a layer. Layer 1
    carries its HT cleanup pass, layer 2 its SigProp and MagRef passes in
    the second codeword segment, each packet header written as B.10
    signals it (an included code-block's later contribution: one
    inclusion bit, its pass count, one length of Lblock + floor(log2 2)
    bits). The one-layer stream is the port's encoder's 3-pass form."""
    one = tj2k.encode_jpeg2k(frame, levels=0, ht=True, ht_passes=3)
    mb = 2 + 8 - 1  # guard bits + the LL band's exponent (depth 8) - 1
    cu, ref, zbp = tht.encode_ht_block_3pass(
        frame.astype(np.int64) - 128, mb)
    lblock = 3

    def length(wr, n, nbits):
        nonlocal lblock
        extra = max(0, n.bit_length() - nbits)
        for _ in range(extra):
            wr.bit(1)
        wr.bit(0)
        lblock += extra
        wr.bits(n, nbits + extra)

    wr = tj2k._HdrWriter()
    wr.bit(1)  # packet not empty
    tj2k._TagTreeEnc(1, 1, np.zeros((1, 1))).encode(0, 0, 1, wr)  # layer 0
    tj2k._TagTreeEnc(1, 1, np.full((1, 1), zbp - 1)).encode_value(0, 0, wr)
    wr.bit(0)  # one pass: the cleanup
    length(wr, len(cu), lblock)
    pkt1 = wr.flush() + cu
    wr.bit(1)  # packet not empty
    wr.bit(1)  # the code-block is included again
    wr.bits(0b10, 2)  # two passes: SigProp, MagRef
    length(wr, len(ref), lblock + 1)
    pkt2 = wr.flush() + ref
    sot = one.index(b"\xff\x90")
    head = bytearray(one[:sot])
    cod = head.index(b"\xff\x52")
    head[cod + 6:cod + 8] = struct.pack(">H", 2)  # SGcod: two layers
    body = pkt1 + pkt2
    two = (bytes(head) + b"\xff\x90" + struct.pack(">HHIBB", 10, 0,
                                                   12 + 2 + len(body), 0, 1)
           + b"\xff\x93" + body + b"\xff\xd9")
    return two, one


def test_two_layer_ht_stream_decodes():
    """The HT two-length branch read two lengths for every HT contribution
    of more than one pass; a later layer's SigProp/MagRef contribution
    signals one. It now decodes, equal to the one-layer stream and the
    frame (lossless)."""
    frame = FRAMES["u8"][:40, :56].copy()
    two, one = _two_layer_ht_stream(frame)
    np.testing.assert_array_equal(tj2k.decode_jpeg2k(one), frame)
    np.testing.assert_array_equal(tj2k.decode_jpeg2k(two), frame)


def test_htj2k_write_dispatch_has_no_dead_tuple(tmp_path):
    """The unused ``_HTJ2K`` tuple is gone; the HT syntaxes dispatch through
    ``_JPEG_2K`` and round-trip."""
    assert not hasattr(tdicom, "_HTJ2K")
    assert {tdicom.HTJ2K_LOSSLESS, tdicom.HTJ2K_LOSSLESS_RPCL,
            tdicom.HTJ2K} <= set(tdicom._JPEG_2K)
    px = FRAMES["u16"]
    for ts in (tdicom.HTJ2K_LOSSLESS, tdicom.HTJ2K_LOSSLESS_RPCL):
        tdicom.write_dicom(tmp_path / "ht.dcm", px, transfer_syntax=ts)
        np.testing.assert_array_equal(
            tdicom.read_dicom(tmp_path / "ht.dcm").pixels, px)
