"""Minimal streaming NetCDF-3 (classic) writer.

Covers the reference's netcdf4 output role (reference pyproject.toml:10;
SURVEY.md section 2b D9) without the netCDF4/HDF5 C stack: the classic
format is a fixed header followed by contiguous big-endian array data,
so an enhanced volume can be APPENDED slab by slab with O(slab) host
memory — exactly what the streamed volume path needs (SURVEY.md
section 3.3). Files are readable by any NetCDF implementation
(scipy.io.netcdf_file, netCDF4, ncdump).

Format reference: the NetCDF classic format specification (CDF-1 magic
'CDF\\x01'; CDF-2 'CDF\\x02' with 64-bit data offsets is emitted
automatically when the data region exceeds the 32-bit limit).

uint8 data is stored as NC_BYTE with the conventional ``_Unsigned =
"true"`` attribute (classic NetCDF has no unsigned types); the reader in
``mies_tpu_torch.io.volume`` restores the uint8 view.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_ABSENT = b"\x00\x00\x00\x00\x00\x00\x00\x00"
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_NC_CHAR = 2

# numpy dtype -> (nc_type id, big-endian dtype)
_NC_TYPES = {
    np.dtype(np.int8): (1, ">i1"),
    np.dtype(np.int16): (3, ">i2"),
    np.dtype(np.int32): (4, ">i4"),
    np.dtype(np.float32): (5, ">f4"),
    np.dtype(np.float64): (6, ">f8"),
}


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * ((4 - len(b) % 4) % 4)


def _name(s: str) -> bytes:
    raw = s.encode("ascii")
    return struct.pack(">i", len(raw)) + _pad4(raw)


def _char_attr(name: str, value: str) -> bytes:
    raw = value.encode("ascii")
    return (
        _name(name)
        + struct.pack(">ii", _NC_CHAR, len(raw))
        + _pad4(raw)
    )


class NetCDF3VolumeWriter:
    """Write one [Z, H, W] variable to a classic .nc file, slab by slab.

    Usage:
        w = NetCDF3VolumeWriter(path, shape=(512, 512, 512),
                                dtype=np.uint8, var_name="enhanced")
        for slab in slabs:      # [z_i, H, W] chunks, any z split
            w.append(slab)
        w.close()               # validates all Z rows were written
    """

    def __init__(
        self,
        path: str | Path,
        shape: tuple[int, int, int],
        dtype,
        var_name: str = "enhanced",
        dim_names: tuple[str, str, str] = ("z", "y", "x"),
        attrs: dict[str, str] | None = None,
    ) -> None:
        if len(shape) != 3:
            raise ValueError(f"expected a 3-D shape, got {shape}")
        dtype = np.dtype(dtype)
        attrs = dict(attrs or {})
        var_attrs: dict[str, str] = {}
        if dtype == np.uint8:
            dtype_store = np.dtype(np.int8)
            # the netCDF convention puts _Unsigned on the VARIABLE
            var_attrs["_Unsigned"] = "true"
        else:
            dtype_store = dtype
        if dtype_store not in _NC_TYPES:
            raise ValueError(f"unsupported NetCDF dtype: {dtype}")
        nc_type, be = _NC_TYPES[dtype_store]
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self._be = be
        self._z_written = 0
        nbytes = int(np.prod(self.shape)) * dtype_store.itemsize
        vsize = nbytes + ((4 - nbytes % 4) % 4)

        # header: magic numrecs dim_list gatt_list var_list
        dims = b"".join(
            _name(n) + struct.pack(">i", s)
            for n, s in zip(dim_names, self.shape)
        )
        dim_list = struct.pack(">ii", _NC_DIMENSION, 3) + dims
        if attrs:
            gatts = b"".join(_char_attr(k, v) for k, v in attrs.items())
            gatt_list = struct.pack(">ii", _NC_ATTRIBUTE, len(attrs)) + gatts
        else:
            gatt_list = _ABSENT

        if var_attrs:
            vatts = b"".join(_char_attr(k, v) for k, v in var_attrs.items())
            vatt_list = (
                struct.pack(">ii", _NC_ATTRIBUTE, len(var_attrs)) + vatts
            )
        else:
            vatt_list = _ABSENT
        # vsize is unsigned; the spec says to write 2^32 - 1 when the
        # (single, large) variable exceeds it — readers must not rely on
        # it for the last variable, and ours/scipy's compute from dims
        var_body = (
            _name(var_name)
            + struct.pack(">iiii", 3, 0, 1, 2)  # ndims + dimids
            + vatt_list
            + struct.pack(">iI", nc_type, min(vsize, 2**32 - 1))
        )
        # begin offset depends on header length, which depends on the
        # offset width — CDF-1 (32-bit) unless the file needs CDF-2
        for version, off_fmt in ((1, ">i"), (2, ">q")):
            header_len = (
                4  # magic
                + 4  # numrecs
                + len(dim_list)
                + len(gatt_list)
                + 8  # var_list tag + count
                + len(var_body)
                + struct.calcsize(off_fmt)
            )
            begin = header_len
            if version == 2 or begin + nbytes < 2**31 - 1:
                break
        magic = b"CDF" + bytes([version])
        header = (
            magic
            + struct.pack(">i", 0)  # numrecs (no record dims)
            + dim_list
            + gatt_list
            + struct.pack(">ii", _NC_VARIABLE, 1)
            + var_body
            + struct.pack(off_fmt, begin)
        )
        self._f = open(path, "wb")
        self._f.write(header)

    def append(self, slab: np.ndarray) -> None:
        """Append a [z_i, H, W] slab (z rows in order)."""
        if slab.ndim != 3 or slab.shape[1:] != self.shape[1:]:
            raise ValueError(
                f"slab shape {slab.shape} does not match volume {self.shape}"
            )
        if self._z_written + slab.shape[0] > self.shape[0]:
            raise ValueError(
                f"slab overflows volume: {self._z_written} + {slab.shape[0]} "
                f"> {self.shape[0]}"
            )
        if slab.dtype != self.dtype:
            raise ValueError(f"slab dtype {slab.dtype} != {self.dtype}")
        if self.dtype == np.uint8:
            slab = slab.view(np.int8)
        # written from the array's own buffer: a copy is made only where
        # the slab is not contiguous or its bytes need the big-endian swap
        # (a uint8 slab needs neither)
        self._f.write(np.ascontiguousarray(slab, dtype=self._be).data)
        self._z_written += slab.shape[0]

    def close(self) -> None:
        if self._f.closed:
            return
        if self._z_written != self.shape[0]:
            self._f.close()
            raise ValueError(
                f"volume incomplete: wrote {self._z_written} of "
                f"{self.shape[0]} z rows"
            )
        written = int(np.prod(self.shape)) * np.dtype(self._be).itemsize
        self._f.write(b"\x00" * ((4 - written % 4) % 4))
        self._f.close()

    def __enter__(self) -> "NetCDF3VolumeWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self._f.close()
