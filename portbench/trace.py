"""What a ``torch.profiler`` trace of the traced window says: device busy
time, idle gaps named by the benchmark's host spans, and device time by
kind of kernel.

A device operation (kernel, copy or fill) is tied to the host call that
launched it by the trace's correlation ids, and belongs to a layer when
that call lies inside one of the layer's host operations on the same
thread: the program's ``tpureg::*`` ops (the hand-written kernels, with the
fills and casts their wrappers launch) or the convolutions and matrix
products (cuDNN and cuBLAS).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "pb.window"
SPANS = ("dispatch", "h2d", "d2h", "sync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PRODUCT_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
               "aten::convolution_backward", "aten::mm", "aten::addmm",
               "aten::bmm", "aten::matmul", "aten::linear")


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    program_ops_s: float = 0.0          # device time under tpureg::* ops
    products_s: float = 0.0             # device time under convolutions and products
    unattributed: int = 0               # device ops with no launch found
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Intervals:
    """Merged intervals of one thread, searchable by point."""

    def __init__(self, intervals):
        self.iv = _merge(intervals)
        self.starts = [a for a, _ in self.iv]

    def label(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def summarize(path: str, top: int = 10) -> Summary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    program, products = defaultdict(list), defaultdict(list)
    spans: Dict[str, list] = defaultdict(list)
    launches = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if name == WINDOW:
                window = (ts, ts + dur)
            elif name in SPANS:
                spans[name].append((ts, ts + dur))
        elif cat == "cpu_op":
            if name.startswith("tpureg::"):
                program[e["tid"]].append((ts, ts + dur))
            elif name in PRODUCT_OPS:
                products[e["tid"]].append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], ts)
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, e.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError(f"the trace has no '{WINDOW}' range")
    w0, w1 = window
    program = {t: _Intervals(v) for t, v in program.items()}
    products = {t: _Intervals(v) for t, v in products.items()}
    out = Summary(window_s=(w1 - w0) * 1e-6)
    by_name = defaultdict(float)
    busy = []
    for a, b, name, corr in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dur = (b - a) * 1e-6
        busy.append((a, b))
        by_name[name] += dur
        launch = launches.get(corr)
        if launch is None:
            out.unattributed += 1
            continue
        tid, ts = launch
        if tid in program and program[tid].label(ts):
            out.program_ops_s += dur
        elif tid in products and products[tid].label(ts):
            out.products_s += dur
    merged = _merge(busy)
    out.busy_s = sum(b - a for a, b in merged) * 1e-6
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    span_iv = {n: _Intervals(v) for n, v in spans.items()}
    gaps = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = next((n for n in SPANS if n in span_iv and span_iv[n].label(mid)),
                    "other")
        gaps[name] += (b - a) * 1e-6
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return out
