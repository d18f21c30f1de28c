"""3-D volumetric diffeomorphic registration, the counterpart of
``tpureg/classical/syn3d.py``: the 2-D SVF registration of ``syn.py``
extended to whole volumes (stationary velocity field, scaling-and-squaring
exponentiation, masked local NCC, a Gaussian blur of the velocity after
every Adam update, coarse to fine). The learned deformable model uses
``exp_velocity3d`` and ``apply_flow3d`` too.

NCDHW; displacements are [B, 3, D, H, W] in voxels, channels (u_x, u_y, u_z).
On the card every composition runs the trilinear warp kernels (K6a forward;
K6b and K6c for the positions' and the warped field's cotangents). The
blurs are three fp32 matrix products (no TF32).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..ops.resize import resize_nd
from ..ops.warp import voxel_grid, warp3d
from ..train.steps import set_fp32_numerics
from .syn import adam_descent, blur_matrix, windowed_ncc

__all__ = ["register_syn3d", "apply_flow3d", "exp_velocity3d", "local_ncc3d",
           "gaussian_blur3d"]


def gaussian_blur3d(vol, sigma: float):
    """Separable Gaussian blur of [B, C, D, H, W] as three matrix products,
    along D, then H, then W, in ``vol``'s dtype."""
    if sigma <= 0:
        return vol
    b, c, d, h, w = vol.shape
    kd, kh, kw = (blur_matrix(n, float(sigma), vol.device).to(vol.dtype)
                  for n in (d, h, w))
    y = (kd @ vol.reshape(b * c, d, h * w)).reshape(vol.shape)
    return kh @ y @ kw.T


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


def _compose3d(flow_a, flow_b, split=None):
    """Displacement of a∘b: b(x) + a(x + b(x)). Under ``split`` (an
    ``HSplit``) both are this rank's slabs: ``a`` is gathered whole and
    sampled at the slab's global positions."""
    if split is None:
        return flow_b + warp3d(flow_a, flow_b)
    return flow_b + warp3d(split.gather(flow_a), flow_b,
                           h_offset=split.start(flow_b.shape[3]))


def exp_velocity3d(v, steps: int = 6, split=None):
    """exp(v) by scaling and squaring: v / 2^steps composed with itself
    ``steps`` times. ``split``: ``v`` is this rank's slab of a field whose
    H is split over the ranks of an ``HSplit``; the result is the slab of
    the unsharded exponential."""
    flow = v / (2.0**steps)
    for _ in range(steps):
        flow = _compose3d(flow, flow, split)
    return flow


def local_ncc3d(a, b, mask=None, sigma: float = 4.0, eps: float = 1e-5):
    """Masked local normalised cross-correlation of volumes (mean over
    voxels)."""
    return windowed_ncc(a, b, mask,
                        functools.partial(gaussian_blur3d, sigma=sigma), eps)


def _optimize_level3d(fixed, moving, mask, v0, iterations: int,
                      sigma_flow: float, sigma_metric: float, lr: float,
                      exp_steps: int):
    """One level: Adam on v against −local NCC of the warped moving volume,
    v blurred by ``sigma_flow`` after every update. Returns (v, losses)."""

    def loss_fn(v):
        warped = warp3d(moving, exp_velocity3d(v, exp_steps))
        return -local_ncc3d(fixed, warped, mask, sigma_metric)

    return adam_descent(v0, loss_fn,
                        functools.partial(gaussian_blur3d, sigma=sigma_flow),
                        iterations, lr)


def register_syn3d(
    fixed,
    moving,
    mask=None,
    reg_iterations: Sequence[int] = (30, 20, 10),
    sigma_flow: float = 1.5,
    sigma_metric: float = 4.0,
    lr: float = 2.0,
    exp_steps: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-resolution 3-D diffeomorphic registration of [B,1,D,H,W] pairs.

    Returns (flow [B, 3, D, H, W], warped) at full resolution, fp32, without
    autograd history. Apply to label volumes with ``apply_flow3d(...,
    'nearest')``; check regularity with ``metrics.neg_jacobian_fraction``.
    """
    set_fp32_numerics()
    b, _, d, h, w = fixed.shape
    fixed = fixed.float()
    moving = moving.float()
    mask = None if mask is None else mask.float()

    n_levels = len(reg_iterations)
    v = None
    for i, iters in enumerate(reg_iterations):
        scale = 2 ** (n_levels - 1 - i)
        ds, hs, ws = d // scale, h // scale, w // scale
        f = resize_nd(fixed, (ds, hs, ws))
        m = resize_nd(moving, (ds, hs, ws))
        msk = None if mask is None else resize_nd(mask, (ds, hs, ws))
        if v is None:
            v = torch.zeros((b, 3, ds, hs, ws), dtype=torch.float32,
                            device=fixed.device)
        elif v.shape[2] != ds:
            v = resize_nd(v, (ds, hs, ws)) * (ds / v.shape[2])
        if iters > 0:
            v, _ = _optimize_level3d(f, m, msk, v, int(iters), sigma_flow,
                                     sigma_metric, lr, exp_steps)
    with torch.no_grad():
        if v.shape[2] != d:
            v = resize_nd(v, (d, h, w)) * (d / v.shape[2])
        flow = exp_velocity3d(v, exp_steps)
        warped = warp3d(moving, flow)
    return flow, warped
