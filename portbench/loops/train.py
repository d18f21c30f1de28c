"""The ``train`` kind: training steps back to back, the program's own train
step with the synthesis inside it, on specs ``(seed, corpus, rows)`` drawn
from the run's seed as the window consumes them (each epoch a fresh
permutation of the corpus's slices cut into batches; a seed a batch for
the synthesis). The window ends on time, in a synchronise, and counts
every pair its steps consumed.

Set-up takes the first ``checked_steps`` steps through the window's own
call and keeps what they gave (each step's loss terms, the first gradient
as Adam got it, the parameters' change); the reference repeats them from
the same weights and specs once the window has closed and the program's
state is freed.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import checks, corpus, system
from ..reference import ops as ref_ops
from ..reference import steps as ref_steps
from . import (Run, free, make_weights, peak, precisions, reference_predictor,
               reset_peak, settle, substreams, sync, trace_tail)


def specs(traffic, n_slices: int, seed: int, device):
    """Endless ``(seed, rows)`` of the mix: each epoch's permutation drawn
    when the epoch starts and copied to ``device`` without a wait."""
    rng = np.random.default_rng(seed)
    b = traffic["batch"]
    per_epoch = n_slices // b
    while True:
        rows = torch.from_numpy(rng.permutation(n_slices)[:per_epoch * b]
                                .reshape(per_epoch, b))
        seeds = rng.integers(0, 2**62, size=per_epoch)
        if device.type == "cuda":
            rows = rows.pin_memory()
        rows = rows.to(device, non_blocking=True)
        for s, r in zip(seeds, rows):
            yield int(s), r


@dataclass
class Steps:
    """What a run of checked steps gave."""

    losses: List[Dict[str, float]]      # each step's loss terms
    grads: Dict[str, float]             # the first gradient's leaf norms
    change: Dict[str, float]            # the parameters' change, leaf norms
    first: Optional[Dict[str, torch.Tensor]] = None   # the first gradient, on the host
    dirs: Optional[Dict[str, tuple]] = None   # checks.direction_parts against another's first


def run(run: Run):
    cell, t, dev = run.cell, run.cell.traffic, run.device
    s_weights, s_corpus, s_specs = substreams(run.seed, 3)
    images, _ = corpus.make_corpus(s_corpus, t["volumes"], dev)
    run.log("corpus made")
    feed = specs(t, images.shape[0], s_specs, dev)
    b = t["batch"]

    head = system.build_head(cell.config, make_weights(run, s_weights))
    run.log("weights made, head built")
    state, step = system.train_step(cell.config, t, head)
    run.log("train step built")
    names = {id(p): n.removeprefix("predictor.") for n, p in head.named_parameters()}
    checked, losses, first = [], [], None
    for i in range(t["checked_steps"]):
        seed, rows = next(feed)
        checked.append((seed, rows))
        losses.append(step((seed, images, rows)))
        run.log(f"checked step {i + 1} dispatched")
        if i == 0:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            first = {names[id(p)]: (state.optimizer.state[p]["exp_avg"] / (1 - b1)
                                    if p in state.optimizer.state else torch.zeros_like(p))
                     for p in head.parameters()}
            grads = checks.leaf_norms(first)
            first = {n: g.to("cpu") for n, g in first.items()}
    p0 = make_weights(run, s_weights)
    change = checks.leaf_norms({names[id(p)]: p.detach() - p0[names[id(p)]]
                                for p in head.parameters()})
    del p0
    prog = Steps([{k: float(v) for k, v in m.items()} for m in losses], grads, change,
                 first)
    run.log(f"{len(checked)} checked steps taken and read")
    for _ in range(t["warmup_steps"]):
        seed, rows = next(feed)
        step((seed, images, rows))
    settle(dev)
    run.setup_s = time.perf_counter() - run.t0
    run.log("set-up done")
    run.peak_bytes = peak(dev)
    reset_peak(dev)

    t_start = time.perf_counter()
    while time.perf_counter() - t_start < run.seconds:
        seed, rows = next(feed)
        with run.spans("dispatch"):
            step((seed, images, rows))
        run.attempted += 1
    sync(dev)
    run.window_s = time.perf_counter() - t_start
    run.pairs = run.attempted * b
    run.window_peak_bytes = peak(dev)
    run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)

    if run.trace:
        def one(_):
            seed, rows = next(feed)
            with run.spans("dispatch"):
                step((seed, images, rows))

        trace_tail(run, t["trace_steps"], one)

    del step, state, head, losses, feed
    free(dev)
    ref = reference(run, checked, images, s_weights, against=prog.first)
    run.gaps = checks.train_gaps(prog.losses, ref.losses, prog.grads, ref.grads,
                                 prog.change, ref.change, ref.dirs)
    for what, p, r in (("gradient", prog.grads, ref.grads),
                       ("change", prog.change, ref.change)):
        worst, med = checks.worst_leaves(p, r)
        run.log(f"worst leaves by {what} (program, reference; median {med!r}): "
                + "; ".join(f"{k} {a!r} {c!r}" for k, a, c in worst))
    med = statistics.median(ref.grads.values())
    moved = {k: checks.one_minus_cos(*v) for k, v in ref.dirs.items()
             if ref.grads[k] >= checks.GRAD_FLOOR * med}
    worst = sorted(moved.items(), key=lambda kv: -kv[1])[:5]
    run.log("worst leaves by the gradient's direction (1 - cos): "
            + "; ".join(f"{k} {v!r} (norm {ref.grads[k]!r})" for k, v in worst))
    run.log(f"losses: program {prog.losses!r}, reference {ref.losses!r}")


def reference(run: Run, checked, images, weights_seed, precision: Optional[str] = None,
              rows=None, flip=False, against=None, keep=False,
              algorithms: bool = False, nudge: bool = False) -> Steps:
    """The reference's steps on ``checked`` specs (``rows``: keep the first
    rows only; ``flip``: each batch in reverse order; ``algorithms``:
    cuDNN's deterministic algorithms, another rounding of the same sums;
    ``nudge``: every weight one unit in the last place up, a change of the
    forward's rounding alone) in
    ``precision`` (the configuration's by default); with ``against`` the
    direction of its first gradient against that one, with ``keep`` its
    first gradient on the host."""
    t, cfg = run.cell.traffic, run.cell.config
    precision = precision or precisions(cfg)[0]
    pred = reference_predictor(run, weights_seed)
    if nudge:
        with torch.no_grad():
            for p in pred.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or algorithms
    with ref_ops.precision(precision):
        losses, first = ref_steps.train_steps(
            pred, checked, images, t["image_size"], tuple(t["magnitude"]),
            t["learning_rate"], t["adam_eps"], cfg["loss"]["num_scales"],
            cfg["labels"], rows, flip)
    torch.backends.cudnn.deterministic = deterministic
    p0 = make_weights(run, weights_seed)
    change = checks.leaf_norms({n: p.detach() - p0[n] for n, p in pred.named_parameters()})
    out = Steps(losses, checks.leaf_norms(first), change)
    if against is not None:
        out.dirs = checks.direction_parts(against, first)
    if keep:
        out.first = {n: g.to("cpu") for n, g in first.items()}
    del pred, p0, first
    free(run.device)
    return out


def control(run: Run, precision: Optional[str] = None, rows: Optional[int] = None,
            flip: bool = False, algorithms: bool = False, nudge: bool = False):
    """The gaps of the reference put in the program's place (in
    ``precision``, by default the control's: one below the configuration's;
    with ``rows`` the half-batch fault; with ``flip`` each batch in reverse
    order, with ``algorithms`` cuDNN's deterministic algorithms and with
    ``nudge`` the weights one ulp up: the reference's own spread under
    rounding) against the reference on the run's first specs."""
    t, dev = run.cell.traffic, run.device
    s_weights, s_corpus, s_specs = substreams(run.seed, 3)
    images, _ = corpus.make_corpus(s_corpus, t["volumes"], dev)
    feed = specs(t, images.shape[0], s_specs, dev)
    checked = [next(feed) for _ in range(t["checked_steps"])]
    other = reference(run, checked, images, s_weights,
                      precision or precisions(run.cell.config)[1], rows, flip,
                      keep=True, algorithms=algorithms, nudge=nudge)
    base = reference(run, checked, images, s_weights, against=other.first)
    return checks.train_gaps(other.losses, base.losses, other.grads, base.grads,
                             other.change, base.change, base.dirs)
