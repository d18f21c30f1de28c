"""Time K1 (correlation forward) and K5 (the 2-D warp's image cotangent), as
built from several trees, on one card.

    python3 ab_correlation.py DIR [DIR ...]

Each DIR is a tree of this repository: ``.`` for this one, an earlier
commit unpacked with ``git archive <commit> | tar -x -C DIR``, or a copy
whose ``tpureg_torch/csrc/correlation.cu`` or ``warp2d_grad.cu`` was edited
to try a variant. Only those two files are read from each tree. Each is
built alone, with the flags of ``tpureg_torch/ops/cuda_lib.py``, and called
through the C entry point that every version shares
(``tpureg_correlation_fwd``, ``tpureg_warp2d_dimg``).

K1 runs at FlowNetC's shape (8, 256, 32, 32), md 20, s2 2, and at PWC's
(8, 64, 32, 32) and (2, 32, 64, 64), md 4, s2 1; K5 at the eval step's
stn positions (8, 1, 256, 256) (chip_smoke.py's phase 9), at a smooth field
of SyN's compose shape (1, 2, 256, 256) and at smooth positions of PWC's
level 2 (8, 32, 64, 64). K5's call is the whole of what
``sample2d_dimg_cuda`` does: the zeroed buffer, the kernel, the cast to the
image's dtype. Each version is first held against the plain version with
chip_smoke.py's tolerances; then, for each case, the versions are timed in
the order given and back (A, B, ..., B, A), three times over, beside the
library call where there is one (``grid_sampler_2d_backward`` d/dinput for
K5 in fp32). Prints the card, the medians in microseconds and one JSON
line of them. ``--no-check`` skips the agreement check, for ablation
variants that leave out part of a kernel's work to see what it costs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_warp2d import eval_positions
from chip_smoke import BATCH, SIZE, smooth_positions, time_ms
from tpureg_torch.ops import cuda_lib
from tpureg_torch.ops.correlation import correlation_reference, displacement_count
from tpureg_torch.ops.warp import sample2d_dimg_reference

DEV = torch.device("cuda")
ROUNDS = 3
K1_CASES = (("FlowNetC", (BATCH, 256, 32, 32), 20, 2, 50),
            ("PWC 32x32", (BATCH, 64, 32, 32), 4, 1, 200),
            ("PWC 64x64", (2, 32, 64, 64), 4, 1, 200))
K5_CASES = (("eval stn", (BATCH, 1, SIZE, SIZE), None),
            ("SyN compose", (1, 2, SIZE, SIZE), 2.0),
            ("PWC level 2", (BATCH, 32, 64, 64), 2.0))


def load(tree: Path):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    csrc = tree / "tpureg_torch" / "csrc"
    k1 = ctypes.CDLL(str(cuda_lib.build(csrc, ("correlation.cu",))))
    k1.tpureg_correlation_fwd.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    k1.tpureg_correlation_fwd.restype = i32
    k5 = ctypes.CDLL(str(cuda_lib.build(csrc, ("warp2d_grad.cu",))))
    k5.tpureg_warp2d_dimg.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i64, vp]
    k5.tpureg_warp2d_dimg.restype = i32
    return k1, k5


def k1_call(lib, f1, f2, md, s2):
    b, c, h, w = f1.shape
    k = displacement_count(md, s2)
    out = torch.empty((b, k * k, h, w), dtype=f1.dtype, device=DEV)

    def run():
        code = lib.tpureg_correlation_fwd(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), cuda_lib.DTYPE_CODES[f1.dtype],
            b, c, h, w, md, s2, cuda_lib.stream_handle(f1))
        cuda_lib.check(code, "K1")
        return out
    return run


def k5_call(lib, grad, px, py, shape, dtype):
    b, c, h, w = shape

    def run():
        dimg = torch.zeros(shape, dtype=torch.float32, device=DEV)
        code = lib.tpureg_warp2d_dimg(
            px.data_ptr(), py.data_ptr(), grad.data_ptr(), dimg.data_ptr(), b, c, h, w,
            px.shape[1], cuda_lib.stream_handle(dimg))
        cuda_lib.check(code, "K5")
        return dimg.to(dtype)
    return run


def close(got, want, dtype, atol):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return bool(((got - want).abs() <= atol + atol * want.abs()).all())
    return bool(((got - want).abs() <= 2.0**-7 * want.abs() + atol).all())


def turns(calls, names, reps, library=None):
    """Median device time of each call over ROUNDS rounds of A, B, ..., B, A."""
    order = [*names, *reversed(names)]
    if library is not None:
        calls = {**calls, "library": library}
        order = ["library", *order, "library"]
    times = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name in order:
            times[name].append(time_ms(calls[name], reps) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="trees of this repository")
    parser.add_argument("--no-check", action="store_true",
                        help="time without holding each version to the plain one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_correlation.py: no CUDA card found")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    names = [str(t) for t in args.trees]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(load, args.trees)))
    results = {}
    g = torch.Generator(device=DEV).manual_seed(21)
    for label, shape, md, s2, reps in K1_CASES:
        f1 = torch.randn(shape, device=DEV, generator=g)
        f2 = torch.randn(shape, device=DEV, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            a, b = f1.to(dtype), f2.to(dtype)
            want = correlation_reference(a, b, md, s2)
            calls = {name: k1_call(k1, a, b, md, s2) for name, (k1, _) in libs.items()}
            for name, run in calls.items():
                if args.no_check:
                    break
                if not close(run(), want, dtype, 1e-5 if dtype == torch.float32 else 1e-6):
                    raise SystemExit(f"K1 of {name} disagrees with the plain version "
                                     f"({label}, {dtype})")
            key = f"K1 {label} md {md} s2 {s2} {str(dtype)[6:]}"
            results[key] = turns(calls, names, reps)
            print(f"  {key}: " + ", ".join(f"{n} {t:.2f}" for n, t in results[key].items()),
                  flush=True)
    moving, epx, epy = eval_positions()
    for label, shape, amp in K5_CASES:
        b, c, h, w = shape
        if amp is None:
            px, py = epx, epy
        else:
            px, py = smooth_positions(b, h, w, amp, seed=22)
        grad = torch.randn((b, c, px.shape[1]), device=DEV, generator=g)
        grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1],
                           -1).reshape(b, h, w, 2)
        for dtype in (torch.float32, torch.bfloat16):
            want = sample2d_dimg_reference(grad, px, py, shape, dtype)
            calls = {name: k5_call(k5, grad, px, py, shape, dtype)
                     for name, (_, k5) in libs.items()}
            for name, run in calls.items():
                if args.no_check:
                    break
                if not close(run(), want, dtype, 1e-5):
                    raise SystemExit(f"K5 of {name} disagrees with the plain version "
                                     f"({label}, {dtype})")
            library = None
            if dtype == torch.float32:
                img = torch.zeros(shape, device=DEV)
                cot = grad.reshape(shape)
                library = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
                    cot, img, grid, 0, 0, True, [True, False])
            key = f"K5 {label} {shape} {str(dtype)[6:]}"
            results[key] = turns(calls, names, 200, library)
            print(f"  {key}: " + ", ".join(f"{n} {t:.2f}" for n, t in results[key].items()),
                  flush=True)
    del moving
    print(json.dumps({"card": smi, "us": results}))


if __name__ == "__main__":
    main()
