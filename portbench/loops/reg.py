"""The ``reg`` kind: one client; a request is ``batch`` adjacent axial
slices of one volume, each fixed slice with an elastic moving image and
the labels, made at set-up by the reference's synthesis into pinned host
memory (a pool of distinct requests, cycled). A request is timed from its
copy to the card until its flow, warped image and warped labels are in
host memory; the window ends on time.

Once the window has closed and the program's state is freed, the
reference registers a sample of the served requests, drawn from the seed,
and their last outputs are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, corpus, system
from ..reference import ops as ref_ops
from ..reference import steps as ref_steps
from . import (Run, free, make_weights, peak, precisions, reference_predictor,
               reset_peak, settle, substreams, sync, trace_tail)


def _pinned(shape, dev):
    return torch.empty(shape, pin_memory=dev.type == "cuda")


def request_pool(run: Run, seed: int):
    """[(images, labels)] channels-last in host memory, made on the device by
    the reference's synthesis."""
    t, dev = run.cell.traffic, run.device
    s_corpus, s_pool = substreams(seed, 2)
    images, labels = corpus.make_corpus(s_corpus, t["volumes"], dev, with_labels=True)
    per_volume = images.shape[0] // t["volumes"]
    rng = np.random.default_rng(s_pool)
    b, pool = t["batch"], []
    for _ in range(t["pool"]):
        v = int(rng.integers(t["volumes"]))
        z = int(rng.integers(per_volume - b + 1))
        idx = torch.arange(v * per_volume + z, v * per_volume + z + b, device=dev)
        imgs, segs = ref_steps.synthesize(int(rng.integers(2**62)), images, idx,
                                          t["image_size"], tuple(t["magnitude"]),
                                          labels)
        pool.append((_pinned(imgs.shape, dev).copy_(imgs),
                     _pinned(segs.shape, dev).copy_(segs)))
    del images, labels
    return pool


def run(run: Run):
    cell, t, dev = run.cell, run.cell.traffic, run.device
    s_weights, s_pool, s_check = substreams(run.seed, 3)
    pool = request_pool(run, s_pool)
    run.log(f"corpus and a pool of {len(pool)} requests made")
    head = system.build_head(cell.config, make_weights(run, s_weights))
    step = system.eval_step(cell.config, head)
    run.log("weights made, head and eval step built")
    b, size = t["batch"], t["image_size"]
    outs = [{"flow": _pinned((b, size, size, 2), dev),
             "image": _pinned((b, size, size, 1), dev),
             "seg": _pinned((b, size, size, 1), dev)} for _ in pool]
    for o in outs:
        for v in o.values():
            v.zero_()
    served = set()

    def serve(i, timed):
        j = i % len(pool)
        t_req = time.perf_counter()
        with run.spans("h2d"):
            imgs = pool[j][0].to(dev, non_blocking=True)
            segs = pool[j][1].to(dev, non_blocking=True)
        with run.spans("dispatch"):
            outputs, _ = step(imgs, segs)
        with run.spans("d2h"):
            outs[j]["flow"].copy_(outputs[0][0], non_blocking=True)
            outs[j]["image"].copy_(outputs[1][0], non_blocking=True)
            outs[j]["seg"].copy_(outputs[2], non_blocking=True)
        with run.spans("sync"):
            sync(dev)
        served.add(j)
        if timed:
            run.latencies_s.append(time.perf_counter() - t_req)

    i = 0
    for _ in range(t["warmup_requests"]):
        serve(i, False)
        i += 1
        run.log(f"warm-up request {i} served")
    settle(dev)
    run.setup_s = time.perf_counter() - run.t0
    run.log("set-up done")
    run.peak_bytes = peak(dev)
    reset_peak(dev)
    run.spans.times.clear()

    start = i
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < run.seconds:
        serve(i, True)
        i += 1
    run.window_s = time.perf_counter() - t_start
    run.attempted = i - start
    run.pairs = len(run.latencies_s) * b
    run.failed = run.attempted - len(run.latencies_s)
    run.window_peak_bytes = peak(dev)
    run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)
    if run.trace:
        base = i
        trace_tail(run, t["trace_requests"], lambda k: serve(base + k, False))

    del step, head
    free(dev)
    rng = np.random.default_rng(s_check)
    chosen = sorted(int(j) for j in rng.choice(sorted(served),
                                                min(t["checked_requests"], len(served)),
                                                replace=False))
    prog = [{k: v.to(dev) for k, v in outs[j].items()} for j in chosen]
    ref = reference(run, [pool[j] for j in chosen], s_weights)
    run.gaps = checks.reg_gaps(prog, ref)


def reference(run: Run, requests, weights_seed, precision=None):
    """The reference's outputs of each request, in ``precision`` (the
    configuration's by default)."""
    pred = reference_predictor(run, weights_seed)
    out = []
    with ref_ops.precision(precision or precisions(run.cell.config)[0]):
        for imgs, segs in requests:
            out.append(ref_steps.register_requests(pred, imgs.to(run.device),
                                                   segs.to(run.device),
                                                   run.cell.config["labels"]))
    del pred
    return out


def control(run: Run, precision=None):
    """The gaps of the reference in ``precision`` (by default the control's:
    one below the configuration's) against the reference on the first
    ``checked_requests`` requests of the run's pool."""
    t = run.cell.traffic
    s_weights, s_pool, _ = substreams(run.seed, 3)
    pool = request_pool(run, s_pool)[:t["checked_requests"]]
    base = reference(run, pool, s_weights)
    other = reference(run, pool, s_weights, precision or precisions(run.cell.config)[1])
    return checks.reg_gaps(other, base)
