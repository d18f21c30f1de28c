"""Analyze 7.5 (.hdr/.img) volume reader, OASIS-1's native format: the
numpy path of ``tpureg/data/analyze.py``, copied so that the port needs
nothing of tpureg. (The ctypes fast path, native/analyze_reader.cc, comes in
a later slice.)

The 348-byte header is parsed for dims, datatype and endianness and the .img
payload read in Fortran order. Volumes come back as float32 arrays of shape
(X, Y, Z[, V]) in the file's voxel order, the array nibabel's ``get_fdata``
gives.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

__all__ = ["read_analyze", "AnalyzeHeader"]

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    132: np.int16,  # DT_SIGNED_SHORT | planar quirk seen in some exporters
}


class AnalyzeHeader:
    """Parsed subset of the Analyze 7.5 header."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read(348)
        if len(raw) < 348:
            raise ValueError(f"{path}: truncated Analyze header")
        # endianness: sizeof_hdr must equal 348
        for endian in ("<", ">"):
            (sizeof_hdr,) = struct.unpack(endian + "i", raw[0:4])
            if sizeof_hdr == 348:
                self.endian = endian
                break
        else:
            raise ValueError(f"{path}: not an Analyze header (sizeof_hdr)")
        dim = struct.unpack(self.endian + "8h", raw[40:56])
        ndim = int(dim[0])
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: bad ndim {ndim}")
        self.shape: Tuple[int, ...] = tuple(int(d) for d in dim[1 : 1 + ndim])
        (self.datatype,) = struct.unpack(self.endian + "h", raw[70:72])
        (self.bitpix,) = struct.unpack(self.endian + "h", raw[72:74])
        pixdim = struct.unpack(self.endian + "8f", raw[76:108])
        self.pixdim = tuple(float(p) for p in pixdim[1 : 1 + ndim])
        (self.vox_offset,) = struct.unpack(self.endian + "f", raw[108:112])

    @property
    def np_dtype(self):
        if self.datatype not in _DTYPES:
            raise ValueError(f"unsupported Analyze datatype {self.datatype}")
        return np.dtype(_DTYPES[self.datatype]).newbyteorder(self.endian)


def _img_path(path: str) -> Tuple[str, str]:
    base, ext = os.path.splitext(path)
    if ext.lower() == ".img":
        return base + ".hdr", path
    if ext.lower() == ".hdr":
        return path, base + ".img"
    raise ValueError(f"expected .img/.hdr path, got {path}")


def read_analyze(path: str) -> np.ndarray:
    """Read an Analyze volume (either .img or .hdr path) as float32."""
    hdr_file, img_file = _img_path(path)
    hdr = AnalyzeHeader(hdr_file)
    count = int(np.prod(hdr.shape))
    data = np.fromfile(
        img_file, dtype=hdr.np_dtype, count=count, offset=int(hdr.vox_offset)
    )
    if data.size != count:
        raise ValueError(f"{img_file}: expected {count} voxels, got {data.size}")
    # Analyze stores Fortran (x fastest) order
    return data.reshape(hdr.shape, order="F").astype(np.float32)
