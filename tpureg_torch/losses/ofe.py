"""Self-supervised registration loss, the 2-D part of ``tpureg/losses/ofe.py``
(reference loss.py, constants kept):

- ``charbonnier(x) = (x² + ε²)^α`` with α = 0.25, ε = 1e-9;
- per-scale weights ``0.05 · (1..n)``, ascending by default, so the
  coarsest flow of a finest-first list carries the largest weight
  (``weight_order="descending"`` reverses them);
- λ = 0.5 (smoothness), γ = 100 (photometric), ζ = 100 (correlation), each
  scaled by 1/n;
- the fixed image is resized down to each flow's scale (bilinear,
  align_corners=False);
- smoothness uses forward differences with zero padding at the far edge;
- the correlation term is a global Pearson over the batch tensor with a 1/B
  factor, and corr = 1 when either side is constant.

NCHW: images [B, 1, H, W], flows [B, 2, h, w].

The volumetric losses (ofe.py:61-63, :103-105, :156-207 there) take NCDHW
volumes [B, 1, D, H, W] and flows [B, 3, D, H, W] at one scale, with no
resize: ``DEFloss3D`` for the deformable model, ``Affloss`` for the affine
stage.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.resize import resize2d

__all__ = ["charbonnier", "photometric_loss", "photometric_loss_3d",
           "smoothness_loss", "smoothness_loss_3d", "correlation_loss",
           "correlation_loss_3d", "OFEloss", "DEFloss3D", "Affloss"]


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
    weight_order: str = "ascending",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-scale OFE loss → (photo, corr, smooth, total).

    ``flows[i]``: [B, 2, h_i, w_i] finest first; ``warpeds[i]``: the moving
    image warped at that scale; ``fixed``: [B, 1, H, W]. ``weight_order``:
    "ascending" (the reference's) or "descending", which gives the first
    (finest, or RAFT's most refined) entry the largest weight; the default
    loss of every model, RAFT's included, is ascending.
    """
    if weight_order not in ("ascending", "descending"):
        raise ValueError(f"weight_order must be 'ascending'|'descending', "
                         f"got {weight_order!r}")
    n = len(flows)
    weights = 0.05 * torch.arange(1, n + 1, dtype=torch.float32,
                                  device=fixed.device)
    if weight_order == "descending":
        weights = weights.flip(0)
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


def photometric_loss_3d(fixed, warped):
    """Charbonnier photometric difference of two volumes, summed, per batch
    element; no resize (reference loss.py:16-18)."""
    return torch.sum(charbonnier(fixed - warped)) / fixed.shape[0]


def correlation_loss_3d(fixed, warped):
    """1 - global Pearson of two volumes, no resize (reference loss.py:38-50)."""
    return _pearson_one_minus(fixed, warped, warped.shape[0])


def smoothness_loss_3d(flow):
    """Charbonnier of zero-padded forward differences of ``flow``
    [B, 3, D, H, W] along each spatial axis, summed over the three
    components / 3, per batch element: the 2-D construction, far faces
    penalising the raw flow."""
    s = 0.0
    for axis in (2, 3, 4):
        n = flow.shape[axis]
        shifted = torch.cat([flow.narrow(axis, 1, n - 1),
                             torch.zeros_like(flow.narrow(axis, 0, 1))], dim=axis)
        s = s + charbonnier(flow - shifted)
    s = torch.sum(s, dim=1) / 3.0
    return torch.sum(s) / flow.shape[0]


def DEFloss3D(
    flow: torch.Tensor,
    warped: torch.Tensor,
    fixed: torch.Tensor,
    lamb_da: float = 0.5,
    gamma: float = 100.0,
    zeta: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deformable 3-D loss → (photo, corr, smooth, total): γ·photometric +
    ζ·correlation + λ·smoothness, at one scale."""
    p_loss = gamma * photometric_loss_3d(fixed, warped)
    c_loss = zeta * correlation_loss_3d(fixed, warped)
    s_loss = lamb_da * smoothness_loss_3d(flow)
    return p_loss, c_loss, s_loss, p_loss + c_loss + s_loss


def Affloss(warped, fixed, lamb_da: float = 1.0, gamma: float = 1.0):
    """Affine-stage loss → (photo, corr, total); λ multiplies the correlation
    term, as in the reference (loss.py:87-94)."""
    p_loss = gamma * photometric_loss_3d(fixed, warped)
    c_loss = lamb_da * correlation_loss_3d(fixed, warped)
    return p_loss, c_loss, p_loss + c_loss
