"""Deformation-regularity metrics: Jacobian determinant statistics.

The north-star eval for the volumetric path is "Dice/Jacobian eval vs ANTs"
(BASELINE.json config 5). For a displacement field u, the transform is
φ(x) = x + u(x); J = det(I + ∇u). Standard registration regularity numbers:

- ``neg_jacobian_fraction``: fraction of pixels/voxels with J ≤ 0
  (folding — a diffeomorphism has none)
- ``log_jacobian_std``: std of log|J| over the domain (smoothness)

Forward differences with edge clamping; works for [H, W, 2] flows and
[D, H, W, 3] flows (last axis (u_x, u_y[, u_z]) over (W, H[, D]) as
everywhere in this framework).
"""

from __future__ import annotations

import numpy as np

__all__ = ["jacobian_determinant", "neg_jacobian_fraction", "log_jacobian_std"]


def _grad(u, axis):
    g = np.diff(u, axis=axis)
    pad = [(0, 0)] * u.ndim
    pad[axis] = (0, 1)
    return np.pad(g, pad, mode="edge")


def jacobian_determinant(flow: np.ndarray) -> np.ndarray:
    """J(x) = det(I + ∇u) for [H, W, 2] or [D, H, W, 3] displacement."""
    flow = np.asarray(flow, np.float64)
    if flow.shape[-1] == 2:
        u, v = flow[..., 0], flow[..., 1]
        ux, uy = _grad(u, 1), _grad(u, 0)   # d/dx is along W (axis 1)
        vx, vy = _grad(v, 1), _grad(v, 0)
        return (1 + ux) * (1 + vy) - uy * vx
    if flow.shape[-1] == 3:
        # axes: (D, H, W); u_x varies along W(2), u_y along H(1), u_z along D(0)
        du = [flow[..., i] for i in range(3)]  # (u_x, u_y, u_z)
        d = np.empty((3, 3) + flow.shape[:-1])
        for i, comp in enumerate(du):
            d[i, 0] = _grad(comp, 2)  # ∂/∂x
            d[i, 1] = _grad(comp, 1)  # ∂/∂y
            d[i, 2] = _grad(comp, 0)  # ∂/∂z
        j = np.eye(3).reshape(3, 3, *([1] * (flow.ndim - 1))) + d
        return (
            j[0, 0] * (j[1, 1] * j[2, 2] - j[1, 2] * j[2, 1])
            - j[0, 1] * (j[1, 0] * j[2, 2] - j[1, 2] * j[2, 0])
            + j[0, 2] * (j[1, 0] * j[2, 1] - j[1, 1] * j[2, 0])
        )
    raise ValueError(f"flow last dim must be 2 or 3, got {flow.shape[-1]}")


def neg_jacobian_fraction(flow: np.ndarray) -> float:
    j = jacobian_determinant(flow)
    return float((j <= 0).mean())


def log_jacobian_std(flow: np.ndarray, eps: float = 1e-9) -> float:
    j = jacobian_determinant(flow)
    return float(np.log(np.clip(np.abs(j), eps, None)).std())
