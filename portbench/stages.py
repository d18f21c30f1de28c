"""Device time and idle time of a traced tail by the program's own spans
(``tpureg.*``, ``tpureg_torch/utils/profiling.py``): for each span name its
forward, backward and idle seconds, each the span's own time (what its
child spans hold left out).

- A device operation (kernel, copy or fill) is tied by its correlation id
  to its launch. A launch inside an ``autograd::engine::evaluate_function``
  node, on whatever thread, is backward work of the innermost span open
  around the node's forward op: the op that carries the node's
  ``Sequence number``, the latest such op before the node. Any other launch
  is forward work of the innermost span open on its thread at the launch.
- An idle gap of the window (as ``trace.summarize`` finds them) goes by its
  midpoint: when the spans' thread is inside ``tpureg.backward``, to the
  stage of the ``evaluate_function`` node open at that moment on another
  thread; otherwise to the innermost span open there.
- Device time and idle time that no program span holds keep the
  benchmark's own names (``dispatch``, ``h2d``, ``d2h``, ``sync``,
  ``other``), as ``trace.summarize`` names its gaps.

The trace is read as ``trace.summarize`` reads it; nothing of
``summarize``'s own fields is computed here.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .trace import DEVICE_CATS, LAUNCH_CATS, SPANS, WINDOW, _Intervals, _merge

PREFIX = "tpureg."
BACKWARD = "tpureg.backward"
NODE = "autograd::engine::evaluate_function: "


class _Nest:
    """Ranges of one thread that nest (``record_function`` ranges, autograd
    nodes), each with a payload; ``at(t)`` is the payload of the innermost
    range open at ``t``, or None."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent, stack = [], []
        for i, (a, b, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self.parent[i]
        return None if i < 0 else self.ranges[i][2]


@dataclass
class Stages:
    """``rows``: ``[name, forward_s, backward_s, idle_s]`` of each program
    span and, for what no span holds, each benchmark span, largest first;
    ``busy_s``: the device operations' seconds in the window (summed, not
    merged); ``idle_s``: the window's gaps; ``dispatch_idle_s`` and
    ``dispatch_idle_spanned_s``: the gaps the benchmark files under
    ``dispatch``, and the part of them a program span holds."""

    rows: List[List] = field(default_factory=list)
    busy_s: float = 0.0
    idle_s: float = 0.0
    dispatch_idle_s: float = 0.0
    dispatch_idle_spanned_s: float = 0.0

    def unspanned_device_share(self, also=()) -> float:
        """Share of the device seconds that no program span (nor a
        benchmark span in ``also``) holds."""
        held = sum(f + b for n, f, b, _ in self.rows if n.startswith(PREFIX) or n in also)
        return 1.0 - held / self.busy_s if self.busy_s else 0.0

    def unspanned_dispatch_idle_share(self) -> float:
        """Share of the idle seconds under ``dispatch`` that no program span
        holds."""
        if not self.dispatch_idle_s:
            return 0.0
        return 1.0 - self.dispatch_idle_spanned_s / self.dispatch_idle_s


def _bench_name(spans: Dict[str, _Intervals], t) -> str:
    return next((n for n in SPANS if n in spans and spans[n].label(t)), "other")


def summarize(path: str) -> Stages:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    program, nodes = defaultdict(list), defaultdict(list)
    bench = defaultdict(list)
    seq_ops = []                    # (tid, ts, sequence number) of cpu ops
    launches, device = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args", {})
        if cat == "user_annotation":
            if name == WINDOW:
                window = (ts, ts + dur)
            elif name in SPANS:
                bench[name].append((ts, ts + dur))
            elif name.startswith(PREFIX):
                program[e["tid"]].append((ts, ts + dur, name))
        elif cat == "cpu_op":
            seq = args.get("Sequence number")
            if name.startswith(NODE):
                nodes[e["tid"]].append((ts, ts + dur, (ts, seq)))
            elif seq is not None:
                seq_ops.append((e["tid"], ts, seq))
        elif cat in LAUNCH_CATS:
            corr = args.get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], ts)
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, args.get("correlation")))
    if window is None:
        raise RuntimeError(f"the trace has no '{WINDOW}' range")
    w0, w1 = window
    program = {t: _Nest(v) for t, v in program.items()}
    nodes = {t: _Nest(v) for t, v in nodes.items()}
    bench = {n: _Intervals(v) for n, v in bench.items()}
    # forward ops by sequence number: those outside every autograd node
    forward = defaultdict(list)
    for tid, ts, seq in sorted(seq_ops, key=lambda o: o[1]):
        if tid not in nodes or nodes[tid].at(ts) is None:
            forward[seq].append((ts, tid))

    def span_at(tid, ts) -> Optional[str]:
        return program[tid].at(ts) if tid in program else None

    def any_span_at(ts) -> Optional[str]:
        return next((s for s in (n.at(ts) for n in program.values()) if s), None)

    def stage_of(node) -> Optional[str]:
        """The innermost span around the forward op of autograd ``node``."""
        start, seq = node
        ops = forward.get(seq, ())
        i = bisect.bisect_left(ops, (start,)) - 1
        return span_at(ops[i][1], ops[i][0]) if i >= 0 else None

    fwd, bwd, idle = defaultdict(float), defaultdict(float), defaultdict(float)
    out = Stages()
    busy = []
    for a, b, corr in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dur = (b - a) * 1e-6
        busy.append((a, b))
        out.busy_s += dur
        if corr not in launches:
            fwd["other"] += dur
            continue
        tid, ts = launches[corr]
        node = nodes[tid].at(ts) if tid in nodes else None
        stage = (node and stage_of(node)) or span_at(tid, ts) or any_span_at(ts)
        if stage is None:
            fwd[_bench_name(bench, ts)] += dur
        else:
            (fwd if node is None else bwd)[stage] += dur
    merged = _merge(busy)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, dur = 0.5 * (a + b), (b - a) * 1e-6
        stage = any_span_at(mid)
        if stage == BACKWARD:
            open_nodes = (n.at(mid) for n in nodes.values())
            stage = next((s for s in map(stage_of, filter(None, open_nodes)) if s),
                         stage)
        name = _bench_name(bench, mid)
        out.idle_s += dur
        idle[stage or name] += dur
        if name == "dispatch":
            out.dispatch_idle_s += dur
            out.dispatch_idle_spanned_s += dur if stage else 0.0
    names = set(fwd) | set(bwd) | set(idle)
    out.rows = sorted(([n, fwd[n], bwd[n], idle[n]] for n in names),
                      key=lambda r: -(r[1] + r[2] + r[3]))
    return out
