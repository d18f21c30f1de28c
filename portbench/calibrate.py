"""Readings that the limits of ``portbench/limits/<workload>.json`` are set
from, in one process on the card:

    python portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2]

For each of ``--seeds`` one run of the cell (a short window) and its gaps
against the reference: the lower readings. For each of ``--control-seeds``
the control, the reference in TF32 against the reference in fp32, and for
a training cell the half-batch fault (the reference on the first half of
each batch): the upper readings; and the reference against itself with
each batch in reverse order, with cuDNN's deterministic algorithms and
with its weights one ulp up (its own spread under rounding). One JSON line
each.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402

import torch  # noqa: E402

from portbench import cell as cell_mod, loops  # noqa: E402
from portbench.run import execute  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = cell_mod.load(args.workload)
    dev = torch.device("cuda", 0)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    for seed in ints(args.seeds):
        t0 = time.perf_counter()
        run = execute(cell, seed, args.seconds, False, [dev], t0)
        print(json.dumps({"reading": "program", "seed": seed, **run.gaps,
                          "setup_s": run.setup_s, "s": time.perf_counter() - t0}),
              flush=True)
        del run
        loops.free(dev)
    control = cell.loop().control
    for seed in ints(args.control_seeds):
        run = loops.Run(cell, seed, 0.0, False, dev, time.perf_counter())
        print(json.dumps({"reading": "control", "seed": seed, **control(run)}),
              flush=True)
        if cell.kind == "train":
            own = loops.precisions(cell.config)[0]
            print(json.dumps({"reading": "flipped", "seed": seed,
                              **control(run, own, flip=True)}), flush=True)
            print(json.dumps({"reading": "algorithms", "seed": seed,
                              **control(run, own, algorithms=True)}), flush=True)
            print(json.dumps({"reading": "nudged", "seed": seed,
                              **control(run, own, nudge=True)}), flush=True)
            half = cell.traffic["batch"] // 2
            print(json.dumps({"reading": "half_batch", "seed": seed,
                              **control(run, own, half)}), flush=True)
        loops.free(dev)


if __name__ == "__main__":
    main()
