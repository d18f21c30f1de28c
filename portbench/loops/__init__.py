"""The closed loops that drive a cell, one module a traffic kind, found by
the mix's ``kind``: ``portbench/loops/<kind>.py`` defines ``run(run)``,
which sets up, measures the window and judges the program against the
reference, and ``control(run, ...)``, the readings its limits are set
from. A later kind is a new module; this one holds what the kinds share:

- ``Run``, one run of a cell and everything its metrics are read from;
- the run's substreams of its seed, the benchmark's host spans, the
  set-up's end and the traced tail;
- the seeded weights, which the program and the reference each get a copy
  of, and the reference's predictor.

A kind that needs more than one card starts its ranks on ``run.devices``
itself and reports the fullest card's peak.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import weights
from .. import trace as trace_mod

# a configuration's precision -> (the reference's, the control's: one below)
PRECISIONS = {"fp32": ("fp32", "tf32")}


def kind(name: str):
    """The loop module ``portbench/loops/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")


def precisions(config) -> tuple:
    """(reference, control) precision of ``config``; refuses one that the
    reference does not implement."""
    if config["precision"] not in PRECISIONS:
        raise ValueError(f"precision {config['precision']!r} of {config['name']} "
                         f"is not one the benchmark implements: {sorted(PRECISIONS)}")
    return PRECISIONS[config["precision"]]


def substreams(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return [int(w >> np.uint64(1)) for w in words]


class Spans:
    """Host time of the benchmark's spans; inside a traced tail each is also
    a profiler range of that name."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(name) if self.profiled
              else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t)


@dataclass
class Run:
    """One run of a cell, and everything its metrics are read from."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device                # the first of ``devices``
    t0: float
    devices: List[torch.device] = field(default_factory=list)
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    pairs: int = 0                      # pairs the window completed
    window_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    spans: Spans = field(default_factory=Spans)
    peak_bytes: int = 0                 # the process's peak up to the window's end
    window_peak_bytes: int = 0          # the window's own peak
    traced_units: int = 0               # steps or requests in the traced tail
    traced_pairs: int = 0
    summary: Optional[trace_mod.Summary] = None
    gaps: Dict[str, float] = field(default_factory=dict)
    _work: object = None

    def __post_init__(self):
        if not self.devices:
            self.devices = [self.device]

    @property
    def kind(self) -> str:
        return self.cell.kind

    def log(self, msg: str) -> None:
        """A diagnostic line on standard error, with the time since start."""
        print(f"[{time.perf_counter() - self.t0:8.3f} s] {msg}", file=sys.stderr,
              flush=True)

    def work(self):
        """FLOP and kernel bounds of one step or request (counted once)."""
        if self._work is None:
            from ..work.count import count
            t = self.cell.traffic
            self._work = count(self.cell.reference().build, self.cell.config,
                               self.kind, t["batch"], t["image_size"])
        return self._work


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def settle(dev):
    """The end of set-up: the card idle, and the objects set-up made moved
    out of the collector's reach, so that a full collection inside the
    window walks only what the window makes."""
    sync(dev)
    gc.collect()
    gc.freeze()


def free(dev):
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def trace_tail(run: Run, units: int, body):
    """Run ``body(i)`` for ``units`` steps or requests under the profiler
    and summarise the trace."""
    dev = run.device
    window_spans = {k: list(v) for k, v in run.spans.times.items()}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    run.spans.profiled = True
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace_mod.WINDOW):
            for i in range(units):
                body(i)
            with run.spans("sync"):
                sync(dev)
    run.spans.profiled = False
    run.spans.times = window_spans  # the window's spans, not the tail's
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        run.summary = trace_mod.summarize(path)
    finally:
        os.remove(path)
    run.log(f"traced {units} units; {run.summary.unattributed} device operations "
            "with no launch in the trace")
    run.traced_units = units
    run.traced_pairs = units * run.cell.traffic["batch"]


def make_weights(run: Run, seed: int):
    """The seeded state dict of the cell's predictor on the run's card."""
    ref = run.cell.reference()
    with torch.device("meta"):
        shapes = ref.build(run.cell.config)
    return weights.make_state_dict(shapes, ref.init_rule, seed, run.device)


def reference_predictor(run: Run, seed: int):
    """The plain reference's predictor holding the seeded weights."""
    ref = run.cell.reference()
    with torch.device("meta"):
        predictor = ref.build(run.cell.config)
    predictor.load_state_dict(make_weights(run, seed), strict=True, assign=True)
    return predictor
