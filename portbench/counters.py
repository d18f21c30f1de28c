"""What the per-layer metrics read from the program's own counters after a
run (``tpureg_torch/utils/profiling.py``); None where the program keeps no
such counter or the run is of another kind."""

from __future__ import annotations

from typing import Optional


def units(run) -> int:
    """Steps or requests the run made through the program: set-up's (the
    checked steps and the warm-up), the window's and the traced tail's."""
    t = run.cell.traffic
    before = (t["checked_steps"] + t["warmup_steps"] if run.kind == "train"
              else t["warmup_requests"])
    return before + run.attempted + run.traced_units


def kernel_launches(run, kind) -> Optional[float]:
    """Launches of the hand-written kernels K1-K6 a step or request, over
    every one the run made (each launches the same kernels)."""
    from tpureg_torch.utils import profiling

    count = getattr(profiling, "kernel_launches", None)
    if run.kind != kind or count is None or not units(run):
        return None
    return count() / units(run)
