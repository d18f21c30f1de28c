"""Tracing and timing helpers, the counterpart of
``tpureg/utils/profiling.py`` (reference flownet2/utils/tools.py:24-53,
98-128):

- ``TimerBlock``: context manager logging named sub-steps
- ``IteratorTimer``: wraps any iterator, accumulating per-item wall time
- ``device_memory_stats``: ``torch.cuda.memory_stats`` of each visible card
- ``trace``: context manager around ``torch.profiler`` over the CPU and the
  cards, writing a trace that TensorBoard's profile plugin reads
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

__all__ = ["TimerBlock", "IteratorTimer", "device_memory_stats", "trace"]


class TimerBlock:
    def __init__(self, title: str, log=print):
        self.title = title
        self.log = log

    def __enter__(self):
        self.start = time.perf_counter()
        self.log(f"{self.title}")
        return self

    def log_step(self, msg: str):
        self.log(f"  [{time.perf_counter() - self.start:8.3f}s] {msg}")

    def __exit__(self, *exc):
        self.log(f"  [{time.perf_counter() - self.start:8.3f}s] done")
        return False


class IteratorTimer:
    """Iterator wrapper accumulating time spent producing each item."""

    def __init__(self, iterable):
        self._it = iter(iterable)
        self.sum = 0.0
        self.count = 0

    def __iter__(self):
        return self

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self._it)
        self.sum += time.perf_counter() - t0
        self.count += 1
        return item


def device_memory_stats() -> dict:
    """``{device: torch.cuda.memory_stats(device)}`` for each visible card;
    ``{"cpu": {}}`` where there is none (the CPU keeps no statistics)."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    return {str(torch.device("cuda", i)): torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block, on the CPU and on the cards where there
    are any, into a ``*.pt.trace.json`` under ``logdir`` (TensorBoard's
    profile plugin). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
