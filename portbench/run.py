"""Run one cell of the benchmark once and print its result.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, on a machine with
as many CUDA cards as the cell asks for. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).
``setup_s`` is taken from this file's first statement to the first timed
step. The kernels build into ``build/`` inside the checkout.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpureg")


def forbidden_modules():
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(run, cell) -> dict:
    """The result object of a finished ``run`` (``loops.Run``)."""
    from portbench import cell as cell_mod
    from portbench.checks import judge

    import torch

    correct, checks = judge(run.gaps, cell.limits)
    correct = correct and run.failed == 0
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            value = cell_mod.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = cell_mod.reader(m["name"], "end_to_end")(run)
            if value is None:
                raise RuntimeError(f"{m['name']} has no reading in {cell.name}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace:
        s = run.summary
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        out["breakdown"] = {"device_ops": [[n[:120], v] for n, v in s.device_ops],
                            "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    out["checks"] = checks
    return out


def execute(cell, seed: int, seconds: float, trace: bool, devices, t0: float):
    """Run ``cell`` on ``devices`` (one a chip it asks for) with the loop of
    its kind; return the finished ``loops.Run``."""
    from portbench import loops

    run = loops.Run(cell, seed, seconds, trace, devices[0], t0, list(devices))
    cell.loop().run(run)
    return run


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import cell as cell_mod

    cell = cell_mod.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, few threads: the host paces some cells
    run = execute(cell, args.seed, args.seconds, bool(args.trace),
                  [torch.device("cuda", i) for i in range(cell.chips)], _T0)
    # read after the window, so that set-up does not wait for it
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    out = result_line(run, cell)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port must not use",
              file=sys.stderr)
        return 3
    run.log("gaps: " + json.dumps(run.gaps))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
