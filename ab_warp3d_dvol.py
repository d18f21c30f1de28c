"""Time K6c, the 3-D warp's volume cotangent, as built from several trees,
on one card.

    python3 ab_warp3d_dvol.py DIR [DIR ...]

Each DIR is a tree of this repository: ``.`` for this one, or an earlier
commit unpacked with ``git archive <commit> | tar -x -C DIR``. Only
``tpureg_torch/csrc/warp3d.cu`` is read from each tree. It is built alone,
with the flags of ``tpureg_torch/ops/cuda_lib.py``, and called through its C
entry point ``tpureg_warp3d_dvol``, which every version of K6c shares; a
call zeroes the fp32 output first, as the wrapper does.

K6c runs at a scaling-and-squaring composition's shape, (2, 3, 88, 128,
128), with chip_smoke.py's cotangent, at three sets of positions: the
voxel grid plus N(0, 0.5²) displacements (chip_smoke.py's composition
row), and the deform step's own first and last compositions. For those a
seeded VoxelMorph3D at full width (chip_smoke.py's phase 8c: seed 6,
velocity head scaled by 1e3) runs forward on the synthesised phantom
volumes of phase 8b; the first composition warps its velocity after
``exp_velocity3d``'s 2^-7 scaling by itself, the last the field after six
of the seven squarings. Each version must agree with the plain version
within 1e-5 abs + 1e-5 rel. Then, for each set of positions, the versions
are timed in the order given and back (A, B, ..., B, A), three times over,
with ``grid_sampler_3d_backward``'s d/dinput on the same positions at both
ends. Prints the card, the times in microseconds and one JSON line of them.
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

from chip_smoke import (VOL_BATCH, head_volumes, time_ms, unit_grid, warp3d_inputs)
from tpureg_torch.classical import exp_velocity3d
from tpureg_torch.data import VOLUME_SIZE
from tpureg_torch.data.pipeline import _process_volume
from tpureg_torch.models import VoxelMorph3D
from tpureg_torch.ops import cuda_lib
from tpureg_torch.ops.warp import sample3d_dvol_reference, voxel_grid

DEV = torch.device("cuda")
SHAPE = (VOL_BATCH, 3, 88, 128, 128)
ROUNDS, REPS = 3, 100


def load_k6c(tree: Path):
    lib = ctypes.CDLL(str(cuda_lib.build(tree / "tpureg_torch" / "csrc", ("warp3d.cu",))))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tpureg_warp3d_dvol.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
    lib.tpureg_warp3d_dvol.restype = i32
    return lib


def k6c_call(lib, cot, px, py, pz):
    b, c, d, h, w = SHAPE
    out = torch.empty(SHAPE, dtype=torch.float32, device=DEV)

    def run():
        out.zero_()
        code = lib.tpureg_warp3d_dvol(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), cot.data_ptr(), out.data_ptr(),
            b, c, d, h, w, px.shape[1], cuda_lib.stream_handle(out))
        cuda_lib.check(code, "K6c")
        return out
    return run


def step_fields():
    """The deform step's first and last composition fields at its start."""
    model = VoxelMorph3D(generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        model.flow_head.weight.mul_(1e3)
    model.to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(11)
    vols = _process_volume(head_volumes(10), VOLUME_SIZE, gen)["image_c"]
    with torch.no_grad():
        _, _, velocity = model(vols.permute(0, 4, 1, 2, 3).contiguous())
        first = (velocity / 2.0**7).contiguous()
        last = exp_velocity3d(velocity / 2.0, 6).contiguous()
    return first, last


def positions_of(field):
    d, h, w = field.shape[2:]
    zz, yy, xx = voxel_grid(d, h, w, DEV)
    return [(t + field[:, k]).reshape(field.shape[0], -1).contiguous()
            for k, t in enumerate((xx, yy, zz))]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="+", type=Path, help="trees of this repository")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_warp3d_dvol.py: no CUDA card found")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    names = [str(t) for t in args.trees]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(load_k6c, args.trees)))
    first, last = step_fields()
    _, noisy = warp3d_inputs(SHAPE, 0.5, 34)
    cot = torch.randn((SHAPE[0], SHAPE[1], noisy[0].shape[1]), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(35))
    cases = {"N(0, 0.5^2)": noisy, "step's first composition": positions_of(first),
             "step's last composition": positions_of(last)}
    del first, last
    rows = {}
    for label, pos in cases.items():
        want = sample3d_dvol_reference(cot, *pos, SHAPE)
        calls = {name: k6c_call(lib, cot, *pos) for name, lib in libs.items()}
        for name, run in calls.items():
            got = run()
            if not bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()):
                raise SystemExit(f"K6c of {name} disagrees with the plain version ({label})")
        del want
        grid = unit_grid(*pos, SHAPE)
        vol = torch.empty(SHAPE, device=DEV)
        calls["grid_sampler_3d_backward"] = lambda: torch.ops.aten.grid_sampler_3d_backward(
            cot.reshape(SHAPE), vol, grid, 0, 0, True, [True, False])
        order = ["grid_sampler_3d_backward", *names, *reversed(names),
                 "grid_sampler_3d_backward"]
        times = {}
        for _ in range(ROUNDS):
            for name in order:
                times.setdefault(name, []).append(time_ms(calls[name], REPS) * 1e3)
        rows[label] = times
        print(f"  {label}:")
        for name, ts in times.items():
            print(f"    {name}: {' '.join(f'{t:.2f}' for t in ts)} us "
                  f"(median {statistics.median(ts):.2f})")
        del grid, vol, calls
    print(json.dumps({"card": smi, "us": rows}))


if __name__ == "__main__":
    main()
