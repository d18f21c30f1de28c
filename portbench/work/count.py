"""The work of one step or request of a cell, counted on the frozen
reference with meta tensors, so that it is the same whatever implements it.

- FLOP: the convolutions' and products' (``FlopCounterMode``, forward and,
  for a training step, backward), plus the correlation's own count (its
  forward, and its VJP where the backward reaches it).
- Kernel bounds: the least time of each correlation and sample call the
  reference makes at the cell's shapes (``work.bound``), with the VJPs the
  backward reaches: the correlation's, the positions' where they need a
  gradient, the image's where it needs one. A training step adds the
  synthesis's sample of the moving image.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import ops
from ..reference import steps as ref_steps
from . import work


@dataclass
class StepWork:
    flops: float            # algorithmic FLOP of one step or request
    kernel_bound_s: float   # Σ least time of its correlation and sampling work
    calls: int              # correlation and sample calls counted


def _bounds(calls, backward: bool):
    total = 0.0
    for c in calls:
        if c.kind == "correlation":
            total += work.bound(*work.correlation_work(c.shape, c.md, c.s2))[0]
            if backward and c.reached and c.grad_in:
                total += work.bound(*work.correlation_bwd_work(c.shape, c.md, c.s2))[0]
        else:
            total += work.bound(*work.warp_work(c.shape, c.positions))[0]
            if backward and c.reached and c.grad_pos:
                total += work.bound(*work.warp_dpos_work(c.shape, c.positions))[0]
            if backward and c.reached and c.grad_img:
                total += work.bound(*work.warp_dimg_work(c.shape, c.positions))[0]
    return total


def _corr_flops(calls, backward: bool):
    total = 0
    for c in calls:
        if c.kind == "correlation":
            total += work.correlation_work(c.shape, c.md, c.s2)[1]
            if backward and c.reached and c.grad_in:
                total += work.correlation_bwd_work(c.shape, c.md, c.s2)[1]
    return total


def count(build, config, kind: str, batch: int, size: int) -> StepWork:
    """The work of one training step (``kind`` "train") or one request
    ("reg") of ``batch`` pairs at ``size``² of the predictor ``build(config)``."""
    with torch.device("meta"):
        predictor = build(config)
    train = kind == "train"
    predictor.train(train)
    imgs = torch.empty((batch, 2, size, size), device="meta")
    segs = torch.empty((batch, 2, size, size), device="meta")
    with ops.recording() as rec, FlopCounterMode(display=False) as flop:
        if train:
            flows, warped, _, _ = ref_steps.register(predictor, imgs, None,
                                                     config["labels"])
            loss = ref_steps.ofe_loss(flows, warped, imgs[:, 0:1],
                                      config["loss"]["num_scales"])[3]
            params = [p for p in predictor.parameters()]
            torch.autograd.grad(loss, params, allow_unused=True)
        else:
            with torch.no_grad():
                ref_steps.register(predictor, imgs, segs, config["labels"])
    calls = list(rec.calls)
    if train:  # the moving image's elastic sample inside the step
        calls.append(ops.Call("sample", (batch, 1, size, size), positions=size * size))
    return StepWork(flop.get_total_flops() + _corr_flops(calls, train),
                    _bounds(calls, train), len(calls))
