"""The port's native Analyze decoder (``tpureg_torch/csrc/analyze_reader.cc``,
built at first use by ``tpureg_torch/data/analyze.py``) against tpureg's
``read_analyze(use_native=True)`` (its ``native/libanalyze.so``, which
tests/conftest.py builds) and the port's numpy path, bit for bit, for
datatypes 2, 4, 8 and 16 in both byte orders; the fall-through to numpy on
a non-zero return code; and a build that fails, which raises.
"""

import struct

import numpy as np
import pytest

import tpureg_torch.data.analyze as analyze
from tpureg.data.analyze import _load_native as jax_load_native
from tpureg.data.analyze import read_analyze as jax_read_analyze
from tpureg_torch.data import read_analyze

NP_TYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64}


def write_analyze(path_base, vol, datatype, endian="<"):
    """An Analyze 7.5 pair of ``datatype`` in byte order ``endian``."""
    np_dtype = np.dtype(NP_TYPES[datatype]).newbyteorder(endian)
    hdr = bytearray(348)
    struct.pack_into(endian + "i", hdr, 0, 348)
    dims = (len(vol.shape),) + vol.shape + (1,) * (7 - len(vol.shape))
    struct.pack_into(endian + "8h", hdr, 40, *dims)
    struct.pack_into(endian + "h", hdr, 70, datatype)
    struct.pack_into(endian + "h", hdr, 72, np_dtype.itemsize * 8)
    struct.pack_into(endian + "8f", hdr, 76, 0, 1, 1, 1, 1, 0, 0, 0)
    with open(path_base + ".hdr", "wb") as f:
        f.write(hdr)
    vol.astype(np_dtype).ravel(order="F").tofile(path_base + ".img")
    return path_base + ".img"


def volume(datatype, seed, shape=(7, 9, 5)):
    rng = np.random.default_rng(seed)
    if datatype in (16, 64):
        return rng.normal(0, 100, shape)
    info = np.iinfo(NP_TYPES[datatype])
    return rng.integers(info.min, info.max, shape, endpoint=True)


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("datatype", [2, 4, 8, 16])
def test_native_decoder_matches_tpureg_and_numpy(tmp_path, datatype, endian):
    if not jax_load_native():
        pytest.fail("tpureg's native decoder was not built (make -C native)")
    vol = volume(datatype, datatype)
    path = write_analyze(str(tmp_path / "v"), vol, datatype, endian)
    got = read_analyze(path, use_native=True)
    want = jax_read_analyze(path, use_native=True)
    plain = read_analyze(path, use_native=False)
    for other in (want, plain):
        assert got.dtype == other.dtype == np.float32
        assert got.shape == other.shape == vol.shape
        assert np.array_equal(got, other)
    assert got.flags.f_contiguous
    assert analyze._native is not None  # the native path ran


def test_other_datatypes_take_numpy(tmp_path):
    vol = volume(64, 0)
    path = write_analyze(str(tmp_path / "v"), vol, 64)
    assert np.array_equal(read_analyze(path), jax_read_analyze(path))
    assert np.array_equal(read_analyze(path), vol.astype(np.float32))


class _Failing:
    """A native library whose decoder returns a non-zero code."""

    def __init__(self):
        self.calls = 0

    def analyze_decode(self, *args):
        self.calls += 1
        return 3


def test_non_zero_return_falls_through_to_numpy(tmp_path, monkeypatch):
    vol = volume(4, 1)
    path = write_analyze(str(tmp_path / "v"), vol, 4)
    failing = _Failing()
    monkeypatch.setattr(analyze, "_native", failing)
    assert np.array_equal(read_analyze(path), vol.astype(np.float32))
    assert failing.calls == 1


def test_a_short_file_fails_on_both_paths_as_tpureg(tmp_path):
    path = write_analyze(str(tmp_path / "v"), volume(4, 2), 4)
    with open(path, "r+b") as f:
        f.truncate(100)
    for read in (read_analyze, jax_read_analyze):
        with pytest.raises(ValueError, match="expected 315 voxels, got 50"):
            read(path, use_native=True)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(analyze, "_native", None)
    monkeypatch.setattr(analyze, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    path = write_analyze(str(tmp_path / "v"), volume(4, 3), 4)
    with pytest.raises(RuntimeError, match="building libanalyze_.* failed"):
        read_analyze(path)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_build_is_reused(tmp_path, monkeypatch):
    """A second build of the same source finds the library in place."""
    monkeypatch.setattr(analyze, "BUILD_DIR", tmp_path / "build")
    lib = analyze.build_native()
    assert lib.parent == tmp_path / "build" and lib.exists()
    stamp = lib.stat().st_mtime_ns
    monkeypatch.setenv("CXX", "false")
    assert analyze.build_native() == lib and lib.stat().st_mtime_ns == stamp
