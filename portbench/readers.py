"""What the per-layer metrics read from a finished traced run
(``loops.Run``); each ``layer_metrics/<name>.py`` is one of these for the
cells of one kind, and returns None where the run is of another kind or
has nothing to read."""

from __future__ import annotations

from typing import Optional

import statistics

import torch

from .work.work import PEAK_FLOPS

FP32_PEAK = PEAK_FLOPS[torch.float32]


def _mine(run, kind) -> bool:
    return run.kind == kind


def dispatch_ms(run, kind) -> Optional[float]:
    """Median host time to enqueue one step or request in the window."""
    times = run.spans.times.get("dispatch")
    return statistics.median(times) * 1e3 if _mine(run, kind) and times else None


def mfu(run, kind) -> Optional[float]:
    """The window's algorithmic FLOP per second over fp32's 67 TFLOP/s, %."""
    if not _mine(run, kind) or not run.attempted:
        return None
    units = run.pairs / run.cell.traffic["batch"]
    return 100.0 * run.work().flops * units / run.window_s / FP32_PEAK


def conv_ms(run, kind) -> Optional[float]:
    """Device ms per pair under the convolutions and products, traced tail."""
    s = run.summary
    if not _mine(run, kind) or s is None or not s.products_s:
        return None
    return 1e3 * s.products_s / run.traced_pairs


def kernel_roofline_pct(run, kind) -> Optional[float]:
    """Σ least time of the correlation and sampling work over the device
    time under the program's tpureg::* ops, traced tail, %."""
    s = run.summary
    if not _mine(run, kind) or s is None or not s.program_ops_s:
        return None
    return 100.0 * run.work().kernel_bound_s * run.traced_units / s.program_ops_s


def device_idle_pct(run, kind) -> Optional[float]:
    """Share of the traced tail with no kernel, copy or fill on the card, %."""
    s = run.summary
    if not _mine(run, kind) or s is None or not s.window_s:
        return None
    return 100.0 * (s.window_s - s.busy_s) / s.window_s


def peak_mem_gib(run, kind) -> Optional[float]:
    """``max_memory_allocated`` over the window, GiB."""
    if not _mine(run, kind) or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
