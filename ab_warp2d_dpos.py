"""Time the 2-D warp's node, its forward and its positions' backward, as
built from several trees, on one card; optionally the FlowNet2 and pwc-reg
train steps of each tree.

    python3 ab_warp2d_dpos.py DIR [DIR ...] [--steps DIR [DIR ...]]

Each DIR is a tree of this repository: ``.`` for this one, an earlier
commit unpacked with ``git archive <commit> | tar -x -C DIR``, or a
directory holding only ``tpureg_torch/csrc/warp2d.cu`` and
``warp2d_grad.cu`` (a variant). Those two files are read from each tree and
built alone, with the flags of ``tpureg_torch/ops/cuda_lib.py``. A tree
whose ``warp2d_grad.cu`` has ``tpureg_warp2d_dpos`` runs the node as this
tree does: K3 (``tpureg_warp2d_fwd``), then K4 on the cotangent. An older
tree's has ``tpureg_warp2d_taps``, which samples and writes two [B, C, P]
bases in the forward, and its backward contracts them with the cotangent
(``(g * base).sum(1)`` twice), as its node did. Each version must give the
plain sample bit for bit and the positions' cotangent within
Σ_c |g_c| (1e-6 + 1e-5 |basis_c|) of ``sample2d_dpos_reference``.

Six shapes, fp32: PWC's four feature warps at 256², batch 8 ((C, h) =
(128, 8), (96, 16), (64, 32), (32, 64), chip_smoke.py's phase 4d flows and
"pwc" positions), FlowNet2's head warp (8, 1, 256²) at the fp32 eval step's
own stn positions (ab_warp2d.py's), and SyN's composition (1, 2, 64²) of a
smooth 1 px field with itself. For each, the nodes are timed in the order
given and back (A, B, ..., B, A), three times over, with ``grid_sample``
plus ``grid_sampler_2d_backward``'s d/dgrid at both ends; K4 (or an older
tree's taps kernel) alone is timed beside the library's d/dgrid. ptxas's
registers and spills for each tree's K4 are printed first. ``--no-check``
times variants that leave out part of the kernel (ablations) without
holding them to the plain version.

``--steps`` runs, for each tree named there in the order given and back
and for each of FlowNet2 and pwc-reg, a process that imports that tree's
``tpureg_torch`` and ``chip_smoke`` and times the model's fp32 (TF32 off)
train step at 256², batch 8, on chip_smoke.py's phantom batch: the median
of 10 steps after 2; the medians of the forward (with the loss), the
backward and Adam, each ended by a synchronise, and of the time the host
takes to queue the first two; the peak memory above resident; and one
profiled step's device busy time, idle share and kernel count.

Prints the card, the times in microseconds (steps in ms) and one JSON line
of them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROUNDS, REPS = 3, 100
PWC_WARPS = ((5, 128, 8), (4, 96, 16), (3, 64, 32), (2, 32, 64))

# one model's train step in one tree, run from that tree's root (the model
# is argv[1]); prints one JSON line after "STEPS "
STEPS_CODE = r'''
import json, statistics, sys, time
import torch
from chip_smoke import BATCH, SIZE, phantom_batch
from tpureg_torch.reg import OpticalFlowReg
from tpureg_torch.train import create_train_state, default_loss_kwargs, make_train_step
from tpureg_torch.train.steps import _loss_terms
from torch.profiler import ProfilerActivity, profile

name = sys.argv[1]
imgs = phantom_batch(BATCH, SIZE, seed=6)[0].to("cuda")
model = OpticalFlowReg(name, generator=torch.Generator().manual_seed(
    {"flownet2": 1, "pwc-reg": 22}[name])).cuda()
state = create_train_state(model)
kw = default_loss_kwargs(name)
step = make_train_step(state, kw)
params = [p for p in model.parameters() if p.requires_grad]
times = []
for i in range(12):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(imgs)["loss"])
    torch.cuda.synchronize()
    if i >= 2:
        times.append((time.perf_counter() - t0) * 1e3)
# the step's phases, each ended by a synchronise: the forward and loss, the
# backward, Adam; "host" is the time until the host has queued the phase
phases = {k: [] for k in ("forward_host", "forward", "backward_host", "backward",
                          "adam")}
for i in range(12):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train()
    with torch.enable_grad():
        _, metrics = _loss_terms(model, imgs, None, kw, None)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = torch.autograd.grad(metrics["loss"], params, materialize_grads=True)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    for p, g in zip(params, grads):
        p.grad = g
    state.apply_gradients()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    if i >= 2:
        for k, v in zip(phases, (t1 - t0, t2 - t0, t3 - t2, t4 - t2, t5 - t4)):
            phases[k].append(v * 1e3)
resident = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
step(imgs)
torch.cuda.synchronize()
peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    step(imgs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation]
busy = sum(e.device_time_total for e in kernels) / 1e3
print("STEPS " + json.dumps({
    "median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
    **{k + "_ms": statistics.median(v) for k, v in phases.items()},
    "peak_gib": peak, "busy_ms": busy, "profiled_ms": wall, "idle": 1 - busy / wall,
    "kernels": len(kernels)}))
'''


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def load_warp(tree: Path):
    """The 2-D warp's kernels of ``tree``, bound; the node's backward is K4
    (``dpos``) or the taps kernel's bases (``taps``)."""
    from tpureg_torch.ops import cuda_lib

    path = cuda_lib.build(tree / "tpureg_torch" / "csrc", ("warp2d.cu", "warp2d_grad.cu"))
    report = path.with_suffix(".ptxas.txt").read_text().splitlines()
    for i, line in enumerate(report):
        if "Compiling entry" in line and ("dpos" in line or "taps" in line):
            regs = next((r for r in report[i + 1:i + 4] if "registers" in r), "")
            spill = next((r for r in report[i + 1:i + 4] if "spill" in r), "")
            print(f"  {tree}: {line.split('entry function')[1].split('Ev')[0][-40:]}: "
                  f"{regs.split(':')[-1].strip()}; {spill.strip()}")
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tpureg_warp2d_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
    lib.tpureg_warp2d_fwd.restype = i32
    kind = "dpos" if hasattr(lib, "tpureg_warp2d_dpos") else "taps"
    fn = getattr(lib, f"tpureg_warp2d_{kind}")
    fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
    fn.restype = i32
    return lib, kind


def node_call(lib, kind, img, px, py, cot):
    """The node's forward and positions' backward as ``lib``'s tree runs
    them; returns (sample, dpx, dpy)."""
    import torch
    from tpureg_torch.ops import cuda_lib

    b, c, h, w = img.shape
    p = px.shape[1]
    dt = cuda_lib.DTYPE_CODES[img.dtype]
    stream = cuda_lib.stream_handle(img)

    def dpos():
        out = torch.empty((b, c, p), dtype=torch.float32, device=img.device)
        cuda_lib.check(lib.tpureg_warp2d_fwd(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), dt, b, c, h, w,
            p, stream), "K3")
        dx, dy = torch.empty((2, b, p), dtype=torch.float32, device=img.device).unbind(0)
        cuda_lib.check(lib.tpureg_warp2d_dpos(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), cot.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), dt, b, c, h, w, p, stream), "K4")
        return out, dx, dy

    def taps():
        out, bx, by = torch.empty((3, b, c, p), dtype=torch.float32,
                                  device=img.device).unbind(0)
        cuda_lib.check(lib.tpureg_warp2d_taps(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), bx.data_ptr(),
            by.data_ptr(), dt, b, c, h, w, p, stream), "taps kernel")
        return out, (cot * bx).sum(1), (cot * by).sum(1)

    return dpos if kind == "dpos" else taps


def taps_call(lib, img, px, py):
    import torch
    from tpureg_torch.ops import cuda_lib

    b, c, h, w = img.shape
    p = px.shape[1]
    out = torch.empty((3, b, c, p), dtype=torch.float32, device=img.device)

    def run():
        cuda_lib.check(lib.tpureg_warp2d_taps(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), cuda_lib.DTYPE_CODES[img.dtype], b, c, h,
            w, p, cuda_lib.stream_handle(img)), "taps kernel")
        return out
    return run


def k4_call(lib, img, px, py, cot):
    import torch
    from tpureg_torch.ops import cuda_lib

    b, c, h, w = img.shape
    p = px.shape[1]
    dx, dy = torch.empty((2, b, p), dtype=torch.float32, device=img.device).unbind(0)

    def run():
        cuda_lib.check(lib.tpureg_warp2d_dpos(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), cot.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), cuda_lib.DTYPE_CODES[img.dtype], b, c, h, w, p,
            cuda_lib.stream_handle(img)), "K4")
        return dx, dy
    return run


def shapes():
    """(label, image, px, py, grid, align_corners) for the six shapes."""
    import torch
    from ab_warp2d import eval_positions
    from chip_smoke import BATCH, DEV, composition_positions, pwc_positions, smooth_flow

    cases = []
    for lvl, c, h in PWC_WARPS:
        flow = smooth_flow(BATCH, h, h, 2.0, seed=40 + lvl)
        px, py = pwc_positions(flow)
        img = torch.rand((BATCH, c, h, h), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(60 + lvl))
        grid = torch.stack([(2 * px + 1) / h - 1, (2 * py + 1) / h - 1],
                           -1).reshape(BATCH, h, h, 2)
        cases.append((f"PWC level {lvl}", img, px, py, grid, False))
    moving, px, py = eval_positions()
    s = moving.shape[-1]
    grid = torch.stack([px * (2 / (s - 1)) - 1, py * (2 / (s - 1)) - 1],
                       -1).reshape(BATCH, s, s, 2)
    cases.append(("FlowNet2's stn warp", moving, px, py, grid, True))
    field = smooth_flow(1, 64, 64, 1.0, seed=80).contiguous()
    px, py = composition_positions(field)
    grid = torch.stack([px * (2 / 63) - 1, py * (2 / 63) - 1], -1).reshape(1, 64, 64, 2)
    cases.append(("SyN's composition", field, px, py, grid, True))
    return cases


def time_kernels(trees, check=True):
    import torch
    import torch.nn.functional as F
    from chip_smoke import time_ms
    from tpureg_torch.ops.warp import (sample2d_dpos_reference, sample2d_gather,
                                       sample2d_taps_reference)

    names = [str(t) for t in trees]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(load_warp, trees)))
    print("trees: " + ", ".join(f"{n} ({k})" for n, (_, k) in libs.items()))
    backward = torch.ops.aten.grid_sampler_2d_backward
    rows = {}
    for label, img, px, py, grid, align in shapes():
        b, c = img.shape[:2]
        cot = torch.randn((b, c, px.shape[1]), device=img.device,
                          generator=torch.Generator(device=img.device).manual_seed(61))
        cot_img = cot.reshape(img.shape)
        want = sample2d_gather(img, px, py)
        wpos = sample2d_dpos_reference(cot, img, px, py)
        _, *bases = sample2d_taps_reference(img, px, py)
        calls = {}
        for name, (lib, kind) in libs.items():
            call = node_call(lib, kind, img, px, py, cot)
            out, *dpos = call()
            torch.cuda.synchronize()
            ok = not check or torch.equal(out, want) and all(
                bool(((k - r).abs() <= (cot.abs() * (1e-6 + 1e-5 * base.abs())).sum(1)).all())
                for k, r, base in zip(dpos, wpos, bases))
            if not ok:
                raise SystemExit(f"the node of {name} disagrees with the plain version "
                                 f"({label})")
            calls[f"node {name}"] = call
            if kind == "dpos":
                calls[f"K4 {name}"] = k4_call(lib, img, px, py, cot)
            else:
                calls[f"taps {name}"] = taps_call(lib, img, px, py)

        def library():
            F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=align)
            return backward(cot_img, img, grid, 0, 0, align, [False, True])

        calls["library node"] = library
        calls["library d/dgrid"] = lambda: backward(cot_img, img, grid, 0, 0, align,
                                                    [False, True])
        mid = [k for k in calls if k.startswith(("node ", "K4 ", "taps "))]
        order = ["library node", "library d/dgrid", *mid, *reversed(mid),
                 "library d/dgrid", "library node"]
        times = {}
        for _ in range(ROUNDS):
            for name in order:
                times.setdefault(name, []).append(
                    time_ms(calls[name], REPS, head_start_ms=50.0) * 1e3)
        key = f"{label} {tuple(img.shape)}"
        rows[key] = times
        print(f"  {key}:")
        for name, ts in times.items():
            print(f"    {name}: {' '.join(f'{t:.2f}' for t in ts)} us "
                  f"(median {statistics.median(ts):.2f})")
    return rows


def time_steps(trees):
    """Each model's train step in a process of its own, for each tree in the
    order given and back."""
    rows = []
    for tree in [*trees, *reversed(trees)]:
        for name in ("flownet2", "pwc-reg"):
            env = {**os.environ, "PYTHONPATH": ""}
            run = subprocess.run([sys.executable, "-c", STEPS_CODE, name], cwd=tree,
                                 env=env, capture_output=True, text=True)
            lines = [ln for ln in run.stdout.splitlines() if ln.startswith("STEPS ")]
            if run.returncode or not lines:
                raise SystemExit(f"the {name} train step of {tree} failed:\n"
                                 f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
            r = json.loads(lines[-1][6:])
            rows.append({"tree": str(tree), "model": name, **r})
            print(f"  {tree} {name} train step fp32: median {r['median_ms']:.3f} ms (min "
                  f"{r['min_ms']:.3f}, max {r['max_ms']:.3f}); phases: forward "
                  f"{r['forward_ms']:.3f} (queued in {r['forward_host_ms']:.3f}), backward "
                  f"{r['backward_ms']:.3f} (queued in {r['backward_host_ms']:.3f}), Adam "
                  f"{r['adam_ms']:.3f}; peak {r['peak_gib']:.3f} GiB above resident; busy "
                  f"{r['busy_ms']:.3f} of a {r['profiled_ms']:.3f} ms profiled step "
                  f"({100 * r['idle']:.1f}% idle), {r['kernels']} kernels", flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="trees of this repository")
    parser.add_argument("--steps", nargs="+", type=Path, default=[],
                        help="trees whose train steps to time, in this order and back")
    parser.add_argument("--no-check", action="store_true",
                        help="time ablation variants without the plain version's check")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_warp2d_dpos.py: no CUDA card found")
    smi = card_line()
    print(f"card: {smi}", flush=True)
    result = {"card": smi, "us": time_kernels(args.trees, not args.no_check)}
    if args.steps:
        result["steps"] = time_steps([t.resolve() for t in args.steps])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
