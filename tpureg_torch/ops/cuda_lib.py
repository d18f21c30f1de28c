"""Build and bind the port's hand-written CUDA kernels (``tpureg_torch/csrc``).

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all of
them started together, for ``sm_90a`` (the H100), and the objects are linked
into one shared library with a plain C interface under
``build/tpureg_torch/`` in the checkout. The library is bound with
``ctypes``. The build happens at first use, inside the process that needs a
kernel, and is cached by a digest of the sources and flags; nothing here runs
when the module is imported, so the CPU-only test machines import it freely.

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "DTYPE_CODES", "build", "load", "check", "ptxas_report",
           "stream_handle"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("correlation.cu", "correlation_bwd.cu", "warp2d.cu", "warp2d_grad.cu",
           "warp3d.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpureg_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# operand type codes shared with the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def _library_path(csrc: Path = CSRC, sources: tuple = SOURCES) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources:
        digest.update((csrc / name).read_bytes())
    return BUILD_DIR / f"libtpureg_torch_{digest.hexdigest()[:16]}.so"


def ptxas_report() -> str:
    """What ``nvcc -Xptxas -v`` said for each source at the last build."""
    return _library_path().with_suffix(".ptxas.txt").read_text()


def build(csrc: Path = CSRC, sources: tuple = SOURCES) -> Path:
    """Compile every source in parallel and link one ``.so``; return its path.

    ``csrc`` and ``sources`` default to this package's kernels; another
    tree's sources (an earlier version of a kernel, for an A/B timing) build
    the same way. A finished library with the same digest is reused. The
    library and its ptxas report are moved into place atomically, so
    concurrent builders in other processes never see a partial file.
    """
    lib = _library_path(csrc, sources)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    procs = []
    try:
        for name in sources:
            log = open(work / f"{name}.log", "w")
            procs.append((name, work / f"{name}.o", log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(csrc / name), "-o",
                 str(work / f"{name}.o")],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, _, log, proc in procs:
            proc.wait()
            log.close()
            if proc.returncode:
                failed.append(name)
        report = "\n".join(f"== {name}\n{(work / f'{name}.log').read_text()}"
                           for name, *_ in procs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
        tmp_lib = work / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _, _ in procs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}"
                               f"{link.stderr}")
        (work / "ptxas.txt").write_text(report)
        os.replace(work / "ptxas.txt", lib.with_suffix(".ptxas.txt"))
        os.replace(tmp_lib, lib)
    finally:
        for _, _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tpureg_correlation_fwd.argtypes = [
                vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
            lib.tpureg_correlation_fwd.restype = i32
            lib.tpureg_warp2d_fwd.argtypes = [
                vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
            lib.tpureg_warp2d_fwd.restype = i32
            lib.tpureg_correlation_bwd.argtypes = [
                vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
            lib.tpureg_correlation_bwd.restype = i32
            lib.tpureg_warp2d_dpos.argtypes = [
                vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
            lib.tpureg_warp2d_dpos.restype = i32
            lib.tpureg_warp2d_dimg.argtypes = [
                vp, vp, vp, vp, i32, i32, i32, i32, i64, vp]
            lib.tpureg_warp2d_dimg.restype = i32
            lib.tpureg_warp3d_fwd.argtypes = [
                vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i64, vp]
            lib.tpureg_warp3d_fwd.restype = i32
            lib.tpureg_warp3d_dpos.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                i64, vp]
            lib.tpureg_warp3d_dpos.restype = i32
            lib.tpureg_warp3d_dvol.argtypes = [
                vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
            lib.tpureg_warp3d_dvol.restype = i32
            lib.tpureg_error_string.argtypes = [i32]
            lib.tpureg_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as the raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().tpureg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
