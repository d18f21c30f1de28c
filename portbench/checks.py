"""The numbers that decide ``correct``: the program's results against the
frozen reference's on the same inputs.

Training (the first steps of the cell's own train step, from the same
weights, on the same specs):

- ``loss<k>_gap``: |loss − reference loss| / |reference loss| of the k-th
  checked step (the first is the forward alone; a random initialisation
  amplifies any rounding step by step, so each step has its own limit);
- ``photo1_gap``, ``corr1_gap``, ``smooth1_gap``: the same of the first
  step's photometric, correlation and smoothness terms;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step / (1 − b1)), by the worst leaf: |‖g‖ − ‖g_ref‖| over the larger
  of ‖g_ref‖ and the median leaf's;
- ``change_gap``: the parameters' change over the checked steps, by the
  worst leaf in the same way, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (the others move under Adam
  by round-off alone);
- ``grad_gap_median``, ``change_gap_median``: the same over the median
  leaf instead of the worst (compared where a cell's limits name them);
- ``grad_dir_gap``, ``grad_dir_gap_median``, ``grad_dir_gap_p90``: the
  first gradient's direction, 1 − the cosine between the program's and the
  reference's gradient of a leaf, by the worst, the median and the 90th
  percentile of the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf the program leaves at zero reads
  1); ``grad_dir_gap_all``, the same of those leaves taken as one vector. Over Adam's first steps the
  update is close to lr · sign(g) per element, so the change alone hardly
  sees the gradient's values; this sees the backward.

Registration (a sample of the requests served in the window, drawn from
the seed): ``flow_gap``, the largest |flow − reference flow| over the
larger of the reference flow's largest magnitude and 1 px; ``image_gap``,
the largest |warped − reference warped| (images in [0, 1]); ``seg_gap``,
the largest share of warped-label pixels that differ.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch

GRAD_FLOOR = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], n: int = 5):
    """The ``n`` leaves with the largest gap of norms: (name, program's
    norm, reference's norm), largest first, and the median leaf's norm."""
    med = statistics.median(ref.values())
    keys = sorted(ref, key=lambda k: -abs(prog[k] - ref[k]) / max(ref[k], med))
    return [(k, prog[k], ref[k]) for k in keys[:n]], med


def _rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r)


def direction_parts(prog: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """{leaf: (p · r, p · p, r · r)} of the program's and the reference's
    gradients, on the reference's device, read back in one transfer."""
    names = list(ref)
    parts = []
    for n in names:
        r = ref[n].float().flatten()
        p = prog[n].to(r.device, torch.float32).flatten()
        parts.append(torch.stack([torch.dot(p, r), torch.dot(p, p), torch.dot(r, r)]))
    return dict(zip(names, map(tuple, torch.stack(parts).double().tolist())))


def one_minus_cos(dot: float, pp: float, rr: float) -> float:
    den = math.sqrt(pp * rr)
    return 1.0 - dot / den if den > 0 else 1.0


def train_gaps(prog_losses: Sequence[Dict[str, float]],
               ref_losses: Sequence[Dict[str, float]],
               prog_grads: Dict[str, float], ref_grads: Dict[str, float],
               prog_change: Dict[str, float], ref_change: Dict[str, float],
               dir_parts: Dict[str, tuple]):
    gaps = {f"loss{k}_gap": _rel(p["loss"], r["loss"])
            for k, (p, r) in enumerate(zip(prog_losses, ref_losses), start=1)}
    for term in ("photo", "corr", "smooth"):
        gaps[f"{term}1_gap"] = _rel(prog_losses[0][f"{term}_loss"],
                                    ref_losses[0][f"{term}_loss"])
    keys = sorted(ref_grads)
    grad = _leaf_gaps(prog_grads, ref_grads, keys)
    med = statistics.median(ref_grads[k] for k in keys)
    moved = [k for k in keys if ref_grads[k] >= GRAD_FLOOR * med]
    change = _leaf_gaps(prog_change, ref_change, moved)
    direction = [one_minus_cos(*dir_parts[k]) for k in moved]
    whole = [sum(dir_parts[k][i] for k in moved) for i in range(3)]
    return {**gaps, "grad_gap": max(grad), "change_gap": max(change),
            "grad_gap_median": statistics.median(grad),
            "change_gap_median": statistics.median(change),
            "grad_dir_gap": max(direction),
            "grad_dir_gap_median": statistics.median(direction),
            "grad_dir_gap_p90": statistics.quantiles(direction, n=10)[8],
            "grad_dir_gap_all": one_minus_cos(*whole)}


def reg_gaps(prog: Sequence[Dict[str, torch.Tensor]],
             ref: Sequence[Dict[str, torch.Tensor]]):
    flow = image = seg = 0.0
    for p, r in zip(prog, ref):
        rf = r["flow"].float()
        scale = max(float(rf.abs().max()), 1.0)
        flow = max(flow, float((p["flow"].float() - rf).abs().max()) / scale)
        image = max(image, float((p["image"].float() - r["image"].float()).abs().max()))
        seg = max(seg, float((p["seg"] != r["seg"]).float().mean()))
    return {"flow_gap": flow, "image_gap": image, "seg_gap": seg}


def judge(gaps: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): each gap that has a limit at
    most its limit; every limit needs its gap."""
    out = {k: {"value": gaps[k], "limit": v} for k, v in limits.items()}
    ok = bool(out) and all(v["value"] <= v["limit"] for v in out.values())
    return ok, out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: L2 norm} read back in one transfer."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].detach().float())
                         for n in names]).tolist()
    return dict(zip(names, norms))
