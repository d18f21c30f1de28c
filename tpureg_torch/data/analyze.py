"""Analyze 7.5 (.hdr/.img) volume reader, OASIS-1's native format: a copy
of ``tpureg/data/analyze.py``, so that the port needs nothing of tpureg.

The 348-byte header is parsed for dims, datatype and endianness and the .img
payload read in Fortran order. Volumes come back as float32 arrays of shape
(X, Y, Z[, V]) in the file's voxel order, the array nibabel's ``get_fdata``
gives.

Datatypes 2, 4, 8 and 16 are decoded by the native reader
(``csrc/analyze_reader.cc``, a copy of tpureg's ``native/analyze_reader.cc``),
bound with ctypes. It is compiled at first use with the host C++ compiler
(``$CXX``, else ``g++``) and ``native/Makefile``'s flags into
``build/tpureg_torch/``, keyed by a digest of the source and flags; a build
that fails raises. A non-zero return code of the decoder (a short file, say)
falls through to numpy, as tpureg's does; so do the other datatypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["read_analyze", "AnalyzeHeader", "build_native"]

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


def _read_numpy(hdr: AnalyzeHeader, img_file: str) -> np.ndarray:
    count = int(np.prod(hdr.shape))
    data = np.fromfile(
        img_file, dtype=hdr.np_dtype, count=count, offset=int(hdr.vox_offset)
    )
    if data.size != count:
        raise ValueError(f"{img_file}: expected {count} voxels, got {data.size}")
    # Analyze stores Fortran (x fastest) order
    return data.reshape(hdr.shape, order="F").astype(np.float32)


NATIVE_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "analyze_reader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpureg_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_native = None


def native_library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(NATIVE_SOURCE.read_bytes())
    return BUILD_DIR / f"libanalyze_{digest.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the native reader unless a library with the same digest is
    there; return its path. The library is moved into place atomically, so
    builders in other processes never see a partial file."""
    lib = native_library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found to build the Analyze reader "
                           "(set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="libanalyze-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(NATIVE_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building {lib.name} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load_native() -> ctypes.CDLL:
    global _native
    with _lock:
        if _native is None:
            lib = ctypes.CDLL(str(build_native()))
            lib.analyze_decode.argtypes = [
                ctypes.c_char_p,        # img path
                ctypes.c_longlong,      # voxel count
                ctypes.c_longlong,      # byte offset
                ctypes.c_int,           # datatype code
                ctypes.c_int,           # 1 if byteswap needed
                ctypes.POINTER(ctypes.c_float),  # out buffer
            ]
            lib.analyze_decode.restype = ctypes.c_int
            _native = lib
    return _native


def read_analyze(path: str, use_native: bool = True) -> np.ndarray:
    """Read an Analyze volume (either .img or .hdr path) as float32."""
    hdr_file, img_file = _img_path(path)
    hdr = AnalyzeHeader(hdr_file)
    if use_native and hdr.datatype in (2, 4, 8, 16):
        lib = _load_native()
        count = int(np.prod(hdr.shape))
        out = np.empty(count, np.float32)
        swap = int(hdr.np_dtype.byteorder == (">" if np.little_endian else "<"))
        rc = lib.analyze_decode(
            img_file.encode(), count, int(hdr.vox_offset), int(hdr.datatype),
            swap, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc == 0:
            return out.reshape(hdr.shape, order="F")
        # fall through to numpy on native failure
    return _read_numpy(hdr, img_file)
