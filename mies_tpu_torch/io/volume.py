"""Volumetric I/O: NetCDF, raw .npy/.npz, and DICOM series.

Covers the reference's netcdf4 role (reference pyproject.toml:10;
SURVEY.md section 2b D9): volumetric CT/MRI ingest as [Z, H, W] int16
arrays, plus WRITING enhanced volumes back out.

NetCDF support is two-tier:
* classic (CDF-1/2) files read via scipy's pure-Python reader with lazy
  mmap slicing and WRITE via mies_tpu_torch.io.netcdf3's streaming writer —
  always available;
* NetCDF-4/HDF5 files read via the netCDF4 package when installed,
  else the in-tree pure-Python HDF5 reader (io/hdf5.py: contiguous +
  gzip/shuffle-chunked datasets, v0/v2/v3 superblocks — the
  default-writer subset, golden-pinned against h5py).

``open_volume_slabs`` is the disk-streamed ingest path (SURVEY.md
section 3.3): it yields [slab, H, W] chunks with O(slab) host memory
for .nc (classic mmap, HDF5 per-chunk slabs), .npy (memmap) and DICOM
directories (per-file decode); .npz is zip-compressed and falls back
to a full load (documented). ``open_volume_reader`` reads the same
formats into buffers the caller owns (the streamed runner's fixed pair).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Iterator

import numpy as np


@dataclasses.dataclass
class VolumeMeta:
    shape: tuple[int, int, int]
    dtype: str
    source: str
    var_name: str | None = None
    spacing: tuple[float, float, float] | None = None  # (dz, dy, dx) mm


def _is_classic_netcdf(path: Path) -> bool:
    with open(path, "rb") as f:
        magic = f.read(4)
    return magic[:3] == b"CDF" and magic[3:] in (b"\x01", b"\x02")


def _open_scipy_nc(path: Path, var_name: str | None, mmap: bool = True):
    """Open a classic .nc with scipy (lazy mmap). Returns (file, var,
    var_name, unsigned)."""
    from scipy.io import netcdf_file

    f = netcdf_file(str(path), "r", mmap=mmap)
    try:
        if var_name is None:
            var_name = next(
                (n for n, v in f.variables.items() if v.data.ndim == 3), None
            )
            if var_name is None:
                raise ValueError(f"no 3-D variable found in {path}")
        if var_name not in f.variables:
            raise KeyError(
                f"variable {var_name!r} not in {path}; has: "
                f"{sorted(f.variables)}"
            )
        var = f.variables[var_name]
    except Exception:
        f.close()  # don't leak the open mmap on a bad var_name
        raise
    # the netCDF convention puts _Unsigned on the variable; also accept
    # a global attribute (files written by early mies_tpu versions)
    flag = getattr(var, "_attributes", {}).get(
        "_Unsigned", getattr(f, "_attributes", {}).get("_Unsigned")
    )
    unsigned = flag == b"true" and var.data.dtype == np.int8
    return f, var, var_name, unsigned


def load_volume(
    path: str | Path, var_name: str | None = None
) -> tuple[np.ndarray, VolumeMeta]:
    """Load a [Z, H, W] volume from .nc / .npz / .npy / DICOM directory.

    Returns (volume, meta). int16 data stays int16 (HU); the pipeline's
    window_hu stage does the cast on-device.
    """
    path = Path(path)
    if path.is_dir():
        # native C++ parallel decoder when buildable; Python twin otherwise
        from mies_tpu_torch import native
        from mies_tpu_torch.io.dicom import read_dicom_header as _hdr

        probe = sorted(path.glob("*.dcm"))[:1]
        if probe and _hdr(probe[0]).get("frames", 1) > 1:
            raise ValueError(
                f"{probe[0]}: multi-frame file in a series directory — "
                "load it directly (load_volume on the FILE) instead; "
                "the per-slice series decoders would drop frames"
            )

        if native.available():
            vol = native.read_dicom_series_native(path)
            src = f"dicom-series-native:{path}"
        else:
            from mies_tpu_torch.io.dicom import read_dicom_series

            vol = read_dicom_series(path)
            src = f"dicom-series:{path}"
        from mies_tpu_torch.io.dicom import series_spacing

        return vol, VolumeMeta(
            vol.shape, str(vol.dtype), src,
            spacing=series_spacing(path),
        )
    suffix = path.suffix.lower()
    if suffix in (".dcm", ".dicom"):
        # single MULTI-frame file = a volume (cine loop / tomo stack)
        from mies_tpu_torch.io.dicom import read_dicom_frames

        vol, info = read_dicom_frames(path)
        spacing = None
        if info.slice_thickness and info.pixel_spacing:
            spacing = (float(info.slice_thickness),
                       float(info.pixel_spacing[0]),
                       float(info.pixel_spacing[1]))
        return vol, VolumeMeta(
            vol.shape, str(vol.dtype), f"dicom-frames:{path}",
            spacing=spacing,
        )
    if suffix == ".nc":
        if _is_classic_netcdf(path):
            # full load -> no mmap (avoids scipy's close-with-live-refs
            # warning); the streaming path below keeps the lazy mmap
            f, var, var_name, unsigned = _open_scipy_nc(path, var_name, mmap=False)
            try:
                vol = np.array(var[:]).astype(var.data.dtype.newbyteorder("="))
                if unsigned:
                    vol = vol.view(np.uint8)
            finally:
                f.close()
            return vol, VolumeMeta(
                vol.shape, str(vol.dtype), f"netcdf3:{path}", var_name
            )
        try:
            import netCDF4
        except ImportError:
            # in-tree pure-Python HDF5 reader (io/hdf5.py): contiguous
            # + gzip/shuffle-chunked datasets, old- and new-style
            # groups — the default-writer subset, golden-pinned vs
            # h5py in tests/test_io.py::TestHdf5
            from mies_tpu_torch.io.hdf5 import read_hdf5_volume

            vol, var_name = read_hdf5_volume(path, var_name)
            return vol, VolumeMeta(
                vol.shape, str(vol.dtype), f"hdf5:{path}", var_name)
        ds = netCDF4.Dataset(path, "r")
        try:
            if var_name is None:
                # first 3-D variable wins
                var_name = next(
                    (n for n, v in ds.variables.items() if v.ndim == 3), None
                )
                if var_name is None:
                    raise ValueError(f"no 3-D variable found in {path}")
            vol = np.asarray(ds.variables[var_name][:])
        finally:
            ds.close()
        return vol, VolumeMeta(vol.shape, str(vol.dtype), f"netcdf:{path}", var_name)
    if suffix == ".npz":
        with np.load(path) as z:
            if var_name is None:
                var_name = z.files[0]
            vol = z[var_name]
        return vol, VolumeMeta(vol.shape, str(vol.dtype), f"npz:{path}", var_name)
    if suffix == ".npy":
        vol = np.load(path)
        return vol, VolumeMeta(vol.shape, str(vol.dtype), f"npy:{path}")
    raise ValueError(f"unsupported volume format: {path}")


def save_volume(path: str | Path, vol: np.ndarray, var_name: str = "enhanced") -> None:
    """Save a volume as .nc (classic NetCDF-3), .npz (compressed), .npy,
    or a DICOM series.

    A path with no (known) suffix is treated as a directory and written
    as numbered DICOM slices (uint8 enhanced output stays uint8; int16
    stays int16) — round-trippable through load_volume.
    """
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".nc":
        from mies_tpu_torch.io.netcdf3 import NetCDF3VolumeWriter

        with NetCDF3VolumeWriter(path, vol.shape, vol.dtype, var_name) as w:
            w.append(vol)
    elif suffix == ".npz":
        np.savez_compressed(path, **{var_name: vol})
    elif suffix == ".npy":
        np.save(path, vol)
    elif suffix in ("", ".dcmdir"):
        from mies_tpu_torch.io.dicom import write_dicom

        path.mkdir(parents=True, exist_ok=True)
        for i, sl in enumerate(vol):
            write_dicom(
                path / f"slice{i:05d}.dcm",
                np.ascontiguousarray(sl),
                instance_number=i + 1,
                slice_location=float(i),
            )
    else:
        raise ValueError(f"unsupported output volume format: {path}")


# ---------------------------------------------------------------------------
# Disk-streamed slab ingest + incremental output (SURVEY.md section 3.3)
# ---------------------------------------------------------------------------


class SlabReader:
    """A [Z, H, W] volume opened for reading slab by slab into the
    caller's own buffers (``open_volume_reader``).

    ``meta`` is the volume's ``VolumeMeta``; ``dtype`` the slabs' numpy
    dtype in native byte order. ``read_into(k, out)`` fills ``out`` (a
    C-contiguous [n, H, W] array of ``dtype``) with slices [k, k + n) in
    one copy from the file's mapping or decoder, byte swap included, and
    returns it; ``close()`` releases the file (and the DICOM decode pool).
    """

    def __init__(self, meta: VolumeMeta, dtype, fill: Callable,
                 close: Callable[[], None] = lambda: None) -> None:
        self.meta, self.dtype = meta, np.dtype(dtype)
        self._fill, self._close = fill, close

    def read_into(self, k: int, out: np.ndarray) -> np.ndarray:
        self._fill(k, out)
        return out

    def close(self) -> None:
        self._close()

    def __enter__(self) -> "SlabReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_volume_slabs(
    path: str | Path, slab_size: int = 16, var_name: str | None = None
) -> tuple[VolumeMeta, Iterator[np.ndarray]]:
    """Open a volume for slab-streamed reading: (meta, slab iterator).

    Yields [z_i, H, W] chunks (last one may be short), each a fresh array
    in native byte order that stays valid after the next read, read in
    one copy through ``open_volume_reader``: O(slab) host memory for
      * classic .nc — scipy mmap, lazy per-slab slicing;
      * .npy        — numpy memmap;
      * DICOM dir   — header-ordering pass (one file in memory at a
                      time), then per-slab threaded decode (native C++
                      single-file decoder when buildable).
      * HDF5 .nc    — in-tree reader over an mmap: each slab reads
                      only the chunks (or contiguous rows) it
                      intersects.
    .npz (zip-compressed) falls back to a full load — the format
    cannot be range-read without decompressing.
    """
    reader = open_volume_reader(path, var_name)
    return reader.meta, _fresh_slabs(reader, slab_size)


def _fresh_slabs(reader: SlabReader, slab_size: int) -> Iterator[np.ndarray]:
    z, *hw = reader.meta.shape
    try:
        for k in range(0, z, slab_size):
            yield reader.read_into(
                k, np.empty((min(slab_size, z - k), *hw), reader.dtype))
    finally:
        reader.close()


def open_volume_reader(path: str | Path,
                       var_name: str | None = None) -> SlabReader:
    """Open a volume for reading slab by slab into the caller's buffers
    (``SlabReader``): the formats of ``open_volume_slabs``, which reads
    through it."""
    path = Path(path)
    if path.is_dir():
        return _dicom_series_reader(path)
    suffix = path.suffix.lower()
    if suffix in (".dcm", ".dicom"):
        # multi-frame file: frames are contiguous in ONE PixelData
        # element — a full parse is unavoidable, so slab-read the
        # in-memory array (bounded by the single file's size)
        vol, meta = load_volume(path)
        return _array_reader(vol, meta)
    if suffix == ".nc" and _is_classic_netcdf(path):
        f, var, var_name, unsigned = _open_scipy_nc(path, var_name)
        shape = tuple(int(s) for s in var.data.shape)
        native_dt = np.dtype(var.data.dtype.newbyteorder("="))
        dt = np.dtype(np.uint8) if unsigned else native_dt
        meta = VolumeMeta(shape, dt.name, f"netcdf3-stream:{path}", var_name)

        def fill_nc(k, out):
            src = var[k : k + len(out)]  # a view of the mmap
            np.copyto(out, src.view(np.uint8) if unsigned else src)

        def close_nc():
            # every slab was copied out; scipy still warns about closing
            # an mmap with live variable refs
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                f.close()

        return SlabReader(meta, dt, fill_nc, close_nc)
    if suffix == ".npy":
        mm = np.load(path, mmap_mode="r")
        if mm.ndim != 3:
            raise ValueError(f"expected a 3-D .npy volume, got {mm.shape}")
        meta = VolumeMeta(mm.shape, str(mm.dtype), f"npy-stream:{path}")

        def fill_npy(k, out):
            np.copyto(out, mm[k : k + len(out)])

        return SlabReader(meta, mm.dtype.newbyteorder("="), fill_npy)
    if suffix == ".nc":
        from mies_tpu_torch.io.hdf5 import H5File, is_hdf5

        if is_hdf5(path):
            # NetCDF-4/HDF5 via the in-tree reader: lazy z-slabs —
            # chunked layouts only read the chunks a slab intersects
            f5 = H5File(path)
            if var_name is None:
                var_name = next(
                    (n for n, d in f5.datasets.items() if d.ndim == 3),
                    None)
                if var_name is None:
                    raise ValueError(f"no 3-D variable found in {path}")
            if var_name not in f5.datasets:
                raise ValueError(
                    f"{path}: no dataset {var_name!r} (has: "
                    f"{sorted(f5.datasets)})")
            dset = f5.datasets[var_name]
            native_dt = np.dtype(dset.dtype.newbyteorder("="))
            meta = VolumeMeta(dset.shape, native_dt.name,
                              f"hdf5-stream:{path}", var_name)

            def fill_h5(k, out):
                dset.read_slab(k, k + len(out), out=out)

            return SlabReader(meta, native_dt, fill_h5)
    # full-load fallbacks (.npz) — documented, not silent
    vol, meta = load_volume(path, var_name=var_name)
    meta.source = f"full-load:{meta.source}"
    return _array_reader(vol, meta)


def _array_reader(vol: np.ndarray, meta: VolumeMeta) -> SlabReader:
    def fill(k, out):
        np.copyto(out, vol[k : k + len(out)])

    return SlabReader(meta, vol.dtype.newbyteorder("="), fill)


def _dicom_series_reader(directory: Path,
                         pattern: str = "*.dcm") -> SlabReader:
    """A DICOM series directory, ordered by position from the headers
    alone; ``read_into`` decodes its slices on a pool of 8 threads, each
    slice into its row of the caller's buffer (a worker holds one file's
    bytes and one decoded slice at a time)."""
    from concurrent.futures import ThreadPoolExecutor

    from mies_tpu_torch import native
    from mies_tpu_torch.io.dicom import read_dicom, read_dicom_header

    paths = sorted(directory.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files in {directory}")

    # ordering pass: HEADER-ONLY parse per file (no pixel decode) —
    # slabs are decoded on demand below, so pixels are touched once.
    # Missing or mismatched dims fail HERE, before the output header is
    # written from them (a mid-stream failure would leave a truncated,
    # wrong-shaped file on disk).
    order = []
    shape_hw = None
    for i, p in enumerate(paths):
        m = read_dicom_header(p)
        if "rows" not in m or "cols" not in m:
            raise ValueError(f"{p}: missing Rows/Columns — not streamable")
        if m.get("frames", 1) > 1:
            raise ValueError(
                f"{p}: multi-frame file inside a series directory "
                f"(NumberOfFrames={m['frames']}) — stream it directly "
                "as a single-file volume instead (the per-slice series "
                "decoders would silently drop its extra frames)"
            )
        hw = (m["rows"], m["cols"])
        if shape_hw is None:
            shape_hw = hw
        elif hw != shape_hw:
            raise ValueError(
                f"mixed slice sizes in series: {p} is {hw}, expected "
                f"{shape_hw} (exclude localizers/scouts before streaming)"
            )
        if m.get("ipp_z") is not None:
            order.append(((0, m["ipp_z"], i), p))
        elif m.get("slice_loc") is not None:
            order.append(((1, m["slice_loc"], i), p))
        elif m.get("instance") is not None:
            order.append(((2, m["instance"], i), p))
        else:
            order.append(((3, i, i), p))
    ordered = [p for _, p in sorted(order, key=lambda t: t[0])]
    z = len(ordered)
    meta = VolumeMeta(
        (z, *shape_hw), "int16", f"dicom-series-stream:{directory}"
    )

    use_native = native.available()

    def decode(p: Path) -> np.ndarray:
        if use_native:
            try:
                px, _ = native.read_dicom_native(p)
                return px
            except ValueError:
                # the Python reader handles forms the C parser doesn't
                # (e.g. preamble-less implicit-VR dumps) — same fallback
                # contract as the 2-D ingest (io/image.py)
                pass
        return read_dicom(p).pixels

    pool = ThreadPoolExecutor(max_workers=8)

    def fill(k, out):
        def one(i):
            # the unsafe cast is astype(np.int16): unsigned stored values
            # keep their 16-bit pattern
            np.copyto(out[i], decode(ordered[k + i]), casting="unsafe")

        list(pool.map(one, range(len(out))))

    return SlabReader(meta, np.int16, fill, pool.shutdown)


def open_volume_writer(
    path: str | Path,
    shape: tuple[int, int, int],
    dtype,
    var_name: str = "enhanced",
):
    """Open an incremental slab writer: .nc (streaming NetCDF-3), .npy
    (memmap), or a directory of DICOM slices. Returned object has
    ``append(slab)`` and ``close()``.
    """
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".nc":
        from mies_tpu_torch.io.netcdf3 import NetCDF3VolumeWriter

        return NetCDF3VolumeWriter(path, shape, dtype, var_name)
    if suffix == ".npy":
        return _NpyWriter(path, shape, dtype)
    if suffix in ("", ".dcmdir"):
        return _DicomDirWriter(path)
    raise ValueError(
        f"unsupported streaming output format: {path} (use .nc, .npy, or "
        "a directory)"
    )


class _NpyWriter:
    def __init__(self, path: Path, shape, dtype) -> None:
        self._mm = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.dtype(dtype), shape=tuple(shape)
        )
        self._z = 0

    def append(self, slab: np.ndarray) -> None:
        self._mm[self._z : self._z + slab.shape[0]] = slab
        self._z += slab.shape[0]

    def close(self) -> None:
        self._mm.flush()
        del self._mm


class _DicomDirWriter:
    def __init__(self, path: Path) -> None:
        self._dir = Path(path)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._z = 0

    def append(self, slab: np.ndarray) -> None:
        from mies_tpu_torch.io.dicom import write_dicom

        for sl in slab:
            write_dicom(
                self._dir / f"slice{self._z:05d}.dcm",
                np.ascontiguousarray(sl),
                instance_number=self._z + 1,
                slice_location=float(self._z),
            )
            self._z += 1

    def close(self) -> None:
        pass
