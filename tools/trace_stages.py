"""The stage breakdown of one traced run of a benchmark cell:

    python3 tools/trace_stages.py --workload <name> --seed <n> --seconds <s>

runs the cell as ``portbench/run.py --trace 1`` does, on the card, and reads
the traced tail's profiler trace twice: with ``portbench.trace.summarize``
(the run's own ``breakdown`` and per-layer metrics) and with
``portbench.stages.summarize`` (device and idle seconds by the program's
spans, ``tpureg_torch/utils/profiling.py``). The last line of standard
output is run.py's result line with ``stages`` added to its ``breakdown``
(``[name, forward_s, backward_s, idle_s]``) and ``span_metrics``: device ms
a pair under ``tpureg.synth``, ``tpureg.model*`` and ``tpureg.loss``, a step
under ``tpureg.optimizer``, and the share of the traced tail idle while the
host was in a model stage. Standard error gets the shares of device and idle
time that no program span accounts for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def traced_stages(cell, seed: int, seconds: float, devices, t0: float):
    """(run.py's result line of ``cell``'s traced run, its ``Stages``)."""
    from portbench import run as run_mod
    from portbench import stages, trace

    found = {}
    summarize = trace.summarize

    def both(path, top=10):
        found["stages"] = stages.summarize(path)
        return summarize(path, top)

    trace.summarize = both
    try:
        run = run_mod.execute(cell, seed, seconds, True, devices, t0)
    finally:
        trace.summarize = summarize
    out = run_mod.result_line(run, cell)
    s = found["stages"]
    out["breakdown"]["stages"] = s.rows
    out["span_metrics"] = span_metrics(s, run)
    return out, s


def span_metrics(s, run) -> dict:
    """What the program's spans say of the traced tail, by layer."""
    rows = {n: r for n, *r in s.rows}
    pairs, units = run.traced_pairs, run.traced_units
    device = lambda n: sum(f + b for m, (f, b, _) in rows.items()
                           if m == n or m.startswith(n + "."))
    model_idle = sum(i for m, (_, _, i) in rows.items() if m.startswith("tpureg.model"))
    out = {"model_ms": 1e3 * device("tpureg.model") / pairs,
           "loss_ms": 1e3 * device("tpureg.loss") / pairs,
           "model_idle_pct": 100.0 * model_idle / run.summary.window_s}
    if run.kind == "train":
        out["synth_ms"] = 1e3 * device("tpureg.synth") / pairs
        out["optimizer_ms"] = 1e3 * device("tpureg.optimizer") / units
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    t0 = time.perf_counter()

    import torch

    from portbench import cell as cell_mod

    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available():
        print("trace_stages: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out, s = traced_stages(cell, args.seed, args.seconds,
                           [torch.device("cuda", i) for i in range(cell.chips)], t0)
    also = ("h2d", "d2h") if cell.kind == "reg" else ()
    print(f"stages: {100 * s.unspanned_device_share(also):.3f}% of the device time "
          f"and {100 * s.unspanned_dispatch_idle_share():.3f}% of the idle time under "
          "dispatch lie in no program span", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
