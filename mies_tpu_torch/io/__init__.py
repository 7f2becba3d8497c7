"""Host-side I/O: image/volume ingest and uint8 output save.

A copy of ``mies_tpu.io`` with its imports rewritten to this package: I/O
is host work (SURVEY.md section 1b): Pillow for PNG/JPEG/TIFF (imported
only where those formats are read or written), a self-contained DICOM
reader and writer with its codecs (no pydicom), NetCDF classic and
NetCDF-4/HDF5 without the netCDF4 package, and raw .npy/.npz volumes.
Device code never touches files; these functions produce and consume
NumPy arrays at the process<->device boundary.
"""

from mies_tpu_torch.io.image import load_image, save_image, to_float, from_float
from mies_tpu_torch.io.volume import load_volume, save_volume, VolumeMeta
from mies_tpu_torch.io.dicom import read_dicom, read_dicom_series

__all__ = [
    "load_image",
    "save_image",
    "to_float",
    "from_float",
    "load_volume",
    "save_volume",
    "VolumeMeta",
    "read_dicom",
    "read_dicom_series",
]
