"""Tracing of the port:

- ``span``: a named range at a layer boundary, recorded only while a
  ``torch.profiler`` session records, in the same trace (and on the same
  clock) as the kernels and copies it launches. The spans:

  - ``tpureg.train_step`` and ``tpureg.eval_step``: a call of a step of
    ``train/steps.py``;
  - ``tpureg.synth``: the elastic synthesis inside the train step;
  - ``tpureg.model``: the head's predictor (``reg/head.py``), and inside it
    ``tpureg.model.<stage>``: FlowNet2's ``flownetc``, ``flownets_1``,
    ``flownets_2``, ``flownets_d``, ``fusion``; PWC-Net's ``pyramid``,
    ``level6`` ... ``level2``, ``context``;
  - ``tpureg.warp``: the head's warps of images, labels and grid;
  - ``tpureg.loss``, ``tpureg.backward`` (each ``torch.autograd.grad`` of
    the steps), ``tpureg.grad_reduce`` (the data-parallel all-reduce),
    ``tpureg.optimizer`` (Adam's update, ``train/state.py``).

  The backward's kernels launch from autograd's engine, outside these
  ranges; the trace ties each ``autograd::engine::evaluate_function``
  node to its forward op by the op's sequence number, and through it to
  the stage whose range holds that op.
- ``kernel_launches``: the launches of the hand-written kernels so far
  (the sum of the ``.launches`` counters of ``ops/library.py``'s ``OPS``).
- ``trace``: context manager around ``torch.profiler`` over the CPU and the
  cards, writing a trace that TensorBoard's profile plugin reads, spans
  included.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["span", "kernel_launches", "trace"]

# returned by every span while nothing records: no allocation, no clock read
_NULL = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler session
    records on this thread; otherwise one shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


def kernel_launches() -> int:
    """Launches of the hand-written kernels K1-K6 in this process so far."""
    from ..ops.library import OPS

    return sum(launch.launches for _, _, launch in OPS)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block, on the CPU and on the cards where there
    are any, into a ``*.pt.trace.json`` under ``logdir`` (TensorBoard's
    profile plugin), with the port's spans. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
