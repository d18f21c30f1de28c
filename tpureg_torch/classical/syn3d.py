"""Diffeomorphic 3-D displacements from stationary velocity fields, the part
of ``tpureg/classical/syn3d.py`` (:40-76) that the learned deformable model
uses: scaling-and-squaring exponentiation and the backward warp of a volume
by a displacement. ``register_syn3d``, ``local_ncc3d`` and
``gaussian_blur3d`` come with the classical comparator (ROADMAP.md).

NCDHW; displacements are [B, 3, D, H, W] in voxels, channels (u_x, u_y, u_z).
On the card every composition runs the trilinear warp kernels (K6b forward,
K6c for the warped field's cotangent).
"""

from __future__ import annotations

import torch

from ..ops.warp import voxel_grid, warp3d

__all__ = ["apply_flow3d", "exp_velocity3d"]


def apply_flow3d(vol, flow, mode: str = "bilinear"):
    """Backward-warp ``vol`` [B,C,D,H,W] by ``flow`` [B,3,D,H,W] (voxels):
    trilinear, or ``"nearest"`` for label volumes, where each position
    rounds half to even (``torch.round`` as ``jnp.rint``) and an
    out-of-volume position gives zero."""
    if mode != "nearest":
        return warp3d(vol, flow)
    b, c, d, h, w = vol.shape
    zz, yy, xx = voxel_grid(d, h, w, flow.device)
    xi = torch.round(xx + flow[:, 0].float()).long().reshape(b, -1)
    yi = torch.round(yy + flow[:, 1].float()).long().reshape(b, -1)
    zi = torch.round(zz + flow[:, 2].float()).long().reshape(b, -1)
    inb = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & (zi >= 0) & (zi < d))
    idx = (zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
    vals = torch.gather(vol.reshape(b, c, -1), 2, idx[:, None, :].expand(b, c, -1))
    return (vals * inb[:, None, :].to(vol.dtype)).reshape(vol.shape)


def _compose3d(flow_a, flow_b):
    """Displacement of a∘b: b(x) + a(x + b(x))."""
    return flow_b + warp3d(flow_a, flow_b)


def exp_velocity3d(v, steps: int = 6):
    """exp(v) by scaling and squaring: v / 2^steps composed with itself
    ``steps`` times."""
    flow = v / (2.0**steps)
    for _ in range(steps):
        flow = _compose3d(flow, flow)
    return flow
