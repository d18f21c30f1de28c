"""Seeded weights made on the device, in the dtype they are served in.

The state dict follows the reference predictor's keys (the program's
predictor has the same): one uniform and one normal draw from a
``torch.Generator`` on the device for all the leaves together, each leaf a
slice of them scaled as the configuration's reference says
(``init_rule``). The same seed gives the same weights, so the program and
the reference each get their own copy without sharing a tensor.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn


def make_state_dict(predictor: nn.Module, init_rule: Callable, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """{key: tensor on ``device``} for every parameter and buffer of
    ``predictor`` (built on any device; only its shapes are read)."""
    leaves = []
    for prefix, module in predictor.named_modules():
        own = list(module.named_parameters(recurse=False)) + \
            list(module.named_buffers(recurse=False))
        for name, t in own:
            key = f"{prefix}.{name}" if prefix else name
            leaves.append((key, tuple(t.shape), t.dtype,
                           init_rule(module, name, key)))
    counts = {"uniform": 0, "normal": 0}
    for _, shape, _, rule in leaves:
        if rule[0] in counts:
            counts[rule[0]] += int(torch.Size(shape).numel())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pools = {"uniform": torch.rand(counts["uniform"], generator=gen, device=device),
             "normal": torch.randn(counts["normal"], generator=gen, device=device)}
    offsets = {"uniform": 0, "normal": 0}
    out = {}
    for key, shape, dtype, rule in leaves:
        kind = rule[0]
        if kind in pools:
            n = int(torch.Size(shape).numel())
            chunk = pools[kind][offsets[kind]:offsets[kind] + n].view(shape)
            offsets[kind] += n
            if kind == "uniform":
                lo, hi = rule[1], rule[2]
                out[key] = chunk.mul(hi - lo).add_(lo)
            else:
                out[key] = chunk.mul(rule[1])
        elif kind == "const":
            out[key] = torch.full(shape, rule[1], dtype=dtype, device=device)
        elif kind == "tensor":
            out[key] = rule[1](shape).to(device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown initialiser {rule!r} for {key}")
    return out
