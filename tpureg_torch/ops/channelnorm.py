"""Per-pixel channel L2 norm, the counterpart of ``tpureg/ops/channelnorm.py``.

``channelnorm(x)[b, 0, y, x] = sqrt(Σ_c x[b, c, y, x]² + eps)``: the
brightness-error and flow-magnitude feature of the FlowNet2 cascade. The eps
inside the sqrt keeps the backward finite where the input is exactly zero
(an out-of-image warp tap meeting a zero background pixel); it moves the
forward by at most 1e-6. NCHW in, [B, 1, H, W] out, summed in fp32.
"""

from __future__ import annotations

import torch

__all__ = ["channelnorm"]


def channelnorm(x, keepdim: bool = True, eps: float = 1e-12):
    acc = torch.sum(torch.square(x.float()), dim=1, keepdim=keepdim)
    return torch.sqrt(acc + eps).to(x.dtype)
