"""Self-supervised registration loss, the 2-D part of ``tpureg/losses/ofe.py``
(reference loss.py, constants kept):

- ``charbonnier(x) = (x² + ε²)^α`` with α = 0.25, ε = 1e-9;
- per-scale weights ``0.05 · (1..n)``, ascending, so the coarsest flow of a
  finest-first list carries the largest weight;
- λ = 0.5 (smoothness), γ = 100 (photometric), ζ = 100 (correlation), each
  scaled by 1/n;
- the fixed image is resized down to each flow's scale (bilinear,
  align_corners=False);
- smoothness uses forward differences with zero padding at the far edge;
- the correlation term is a global Pearson over the batch tensor with a 1/B
  factor, and corr = 1 when either side is constant.

NCHW: images [B, 1, H, W], flows [B, 2, h, w].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.resize import resize2d

__all__ = ["charbonnier", "photometric_loss", "smoothness_loss",
           "correlation_loss", "OFEloss"]


def charbonnier(x, alpha: float = 0.25, epsilon: float = 1.0e-9):
    return torch.pow(torch.square(x) + epsilon**2, alpha)


def photometric_loss(fixed, warped):
    """Charbonnier photometric difference, summed, per batch element; the
    fixed image is resized to the warped image's scale."""
    h, w = warped.shape[2], warped.shape[3]
    fixed = resize2d(fixed, (h, w), "bilinear", align_corners=False)
    return torch.sum(charbonnier(fixed - warped)) / fixed.shape[0]


def smoothness_loss(flow):
    """TV-style smoothness with zero-padded forward differences; the far row
    and column penalise the raw flow, as in the reference."""
    b = flow.shape[0]
    v_tr = torch.cat([flow[:, :, 1:], torch.zeros_like(flow[:, :, :1])], dim=2)
    h_tr = torch.cat([flow[:, :, :, 1:], torch.zeros_like(flow[:, :, :, :1])],
                     dim=3)
    s = charbonnier(flow - v_tr) + charbonnier(flow - h_tr)
    s = torch.sum(s, dim=1) / 2.0
    return torch.sum(s) / b


def _pearson_one_minus(fixed, warped, batch):
    """1 - global Pearson with the reference's 1/B factor and zero guard."""
    vx = warped - torch.mean(warped)
    vy = fixed - torch.mean(fixed)
    sx = torch.sum(torch.square(vx))
    sy = torch.sum(torch.square(vy))
    degenerate = (sx == 0.0) | (sy == 0.0)
    one = torch.ones_like(sx)
    denom = torch.where(degenerate, one, torch.sqrt(sx) * torch.sqrt(sy))
    corr = torch.where(degenerate, one, torch.sum(vx * vy) / denom / batch)
    return 1.0 - corr


def correlation_loss(fixed, warped):
    """[B,1,H,W] fixed vs [B,1,h,w] warped (reference loss.py:52-64)."""
    h, w = warped.shape[2], warped.shape[3]
    fixed = resize2d(fixed, (h, w), "bilinear", align_corners=False)
    return _pearson_one_minus(fixed, warped, warped.shape[0])


def OFEloss(
    flows: Sequence[torch.Tensor],
    warpeds: Sequence[torch.Tensor],
    fixed: torch.Tensor,
    lamb_da: float = 0.5,
    gamma: float = 100.0,
    zeta: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-scale OFE loss → (photo, corr, smooth, total).

    ``flows[i]``: [B, 2, h_i, w_i] finest first; ``warpeds[i]``: the moving
    image warped at that scale; ``fixed``: [B, 1, H, W]. (tpureg's
    ``weight_order="descending"`` serves RAFT and comes with it.)
    """
    n = len(flows)
    weights = 0.05 * torch.arange(1, n + 1, dtype=torch.float32,
                                  device=fixed.device)
    p_loss = 0.0
    c_loss = 0.0
    s_loss = 0.0
    for i in range(n):
        p_loss = p_loss + weights[i] * photometric_loss(fixed, warpeds[i])
        c_loss = c_loss + weights[i] * correlation_loss(fixed, warpeds[i])
        s_loss = s_loss + weights[i] * smoothness_loss(flows[i])
    p_loss = gamma / n * p_loss
    c_loss = zeta / n * c_loss
    s_loss = lamb_da / n * s_loss
    return p_loss, c_loss, s_loss, p_loss + s_loss + c_loss
