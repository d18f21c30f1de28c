"""Classical (non-learned) diffeomorphic registration, the counterpart of
``tpureg/classical/syn.py``: the comparator the reference scores its deep
models against (ANTs ``SyNOnly`` with masks and ``reg_iterations=(10,0,0)``
there), rebuilt as a stationary-velocity-field registration optimised by
Adam:

- transform: displacement = exp(v) by scaling and squaring;
- similarity: masked local normalised cross-correlation over a Gaussian
  window;
- regularisation: a Gaussian blur of the velocity after every update;
- coarse to fine, one entry of ``reg_iterations`` a level.

NCHW; displacements are [B, 2, H, W] in pixels, channels (x, y). On the
card every composition and warp runs the hand-written bilinear kernels:
K3 samples, and in the backward K4 takes the positions' cotangent and K5
the sampled field's; the final exponential and warp, which need none, run
K3 alone.
The blurs are two fp32 matrix products (no TF32).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize2d
from ..ops.warp import base_grid, sample2d, sample2d_nearest
from ..train.steps import set_fp32_numerics

__all__ = ["register_syn", "apply_flow", "local_ncc", "gaussian_blur",
           "exp_velocity"]


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) row-normalised Gaussian smoothing matrix (truncated ±3σ).

    Row normalisation is equivalent to renormalising the kernel at the
    borders (scipy 'reflect'-family edge behaviour up to truncation).
    """
    x = np.arange(n, dtype=np.float64)
    d = x[None, :] - x[:, None]
    k = np.exp(-0.5 * (d / sigma) ** 2)
    k[np.abs(d) > 3.0 * sigma + 0.5] = 0.0
    k /= k.sum(axis=1, keepdims=True)
    return k.astype(np.float32)


@functools.lru_cache(maxsize=None)
def blur_matrix(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``_blur_matrix(n, sigma)`` on ``device``, copied there once."""
    return torch.from_numpy(_blur_matrix(n, sigma)).to(device)


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur of [B, C, H, W] as two matrix products, in
    ``img``'s dtype (fp32 matrices, raised for an fp64 input as tpureg's
    promotion does)."""
    if sigma <= 0:
        return img
    h, w = img.shape[2:]
    kh = blur_matrix(h, float(sigma), img.device).to(img.dtype)
    kw = blur_matrix(w, float(sigma), img.device).to(img.dtype)
    return kh @ img @ kw.T


def _positions(flow):
    """The pixel grid plus ``flow`` [B, 2, H, W]: (px, py), each [B, H, W]."""
    grid = base_grid(*flow.shape[2:], flow.device)
    return grid[..., 0] + flow[:, 0], grid[..., 1] + flow[:, 1]


def _compose(flow_a, flow_b):
    """flow of (a ∘ b): x ↦ b(x) + a(x + b(x)) in displacement form."""
    return flow_b + sample2d(flow_a, *_positions(flow_b))


def exp_velocity(v, steps: int = 6):
    """Scaling and squaring: displacement field of exp(v)."""
    flow = v / (2.0**steps)
    for _ in range(steps):
        flow = _compose(flow, flow)
    return flow


def apply_flow(img, flow, mode: str = "bilinear"):
    """Backward-warp [B, C, H, W] by a displacement field (pixel units);
    ``"nearest"`` for label maps."""
    px, py = _positions(flow)
    if mode == "nearest":
        return sample2d_nearest(img, px, py)
    return sample2d(img, px, py)


def local_ncc(a, b, mask=None, sigma: float = 4.0, eps: float = 1e-5):
    """Masked local normalised cross-correlation (mean over pixels)."""
    return windowed_ncc(a, b, mask, functools.partial(gaussian_blur, sigma=sigma),
                        eps)


def windowed_ncc(a, b, mask, blur, eps: float):
    """Masked local NCC with the window ``blur`` (2-D or 3-D): the mean over
    the mask of cov² / (var_a · var_b + eps), the moments weighted by the
    blurred mask."""
    if mask is None:
        mask = torch.ones_like(a)
    w = blur(mask) + eps
    ma = blur(a * mask) / w
    mb = blur(b * mask) / w
    va = blur(a * a * mask) / w - ma**2
    vb = blur(b * b * mask) / w - mb**2
    cab = blur(a * b * mask) / w - ma * mb
    cc = (cab * cab) / (va * vb + eps)
    return torch.sum(cc * mask) / torch.sum(mask)


def adam_descent(v, loss_fn, smooth, iterations: int, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
    """``iterations`` steps of Adam on the one tensor ``v``, with ``smooth``
    applied to ``v`` after every update, as tpureg's ``lax.scan`` of
    ``optax.adam(lr)`` steps does (the moments are left as Adam made them).
    Returns (v, losses [iterations ≥ 1]); reads nothing back to the host."""
    v = v.detach()
    mu = torch.zeros_like(v)
    nu = torch.zeros_like(v)
    losses = []
    for count in range(1, iterations + 1):
        with torch.enable_grad():
            x = v.requires_grad_()
            loss = loss_fn(x)
            (g,) = torch.autograd.grad(loss, x)
        v = v.detach()
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        # optax's bias corrections, 1 - decay**count, in fp32
        mu_hat = mu / float(np.float32(1) - np.float32(b1) ** count)
        nu_hat = nu / float(np.float32(1) - np.float32(b2) ** count)
        v = smooth(v + (-lr) * (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)))
        losses.append(loss.detach())
    return v, torch.stack(losses)


def _optimize_level(fixed, moving, mask, v0, iterations: int,
                    sigma_flow: float, sigma_metric: float, lr: float,
                    exp_steps: int):
    """One level: Adam on v against −local NCC of the warped moving image,
    v blurred by ``sigma_flow`` after every update. Returns (v, losses)."""

    def loss_fn(v):
        warped = apply_flow(moving, exp_velocity(v, exp_steps))
        return -local_ncc(fixed, warped, mask, sigma_metric)

    return adam_descent(v0, loss_fn,
                        functools.partial(gaussian_blur, sigma=sigma_flow),
                        iterations, lr)


def register_syn(
    fixed,
    moving,
    mask=None,
    reg_iterations: Sequence[int] = (10, 0, 0),
    sigma_flow: float = 1.5,
    sigma_metric: float = 4.0,
    lr: float = 2.0,
    exp_steps: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-resolution diffeomorphic registration of [B, 1, H, W] pairs.

    ``reg_iterations`` follows ANTs' coarse-to-fine convention: entry i runs
    at 1/2^(n-1-i) resolution ((10, 0, 0): 10 iterations at quarter
    resolution only). Returns (flow [B, 2, H, W], warped) at full
    resolution, fp32, without autograd history; apply to label maps with
    ``apply_flow(..., 'nearest')``.
    """
    set_fp32_numerics()
    b, _, h, w = fixed.shape
    fixed = fixed.float()
    moving = moving.float()
    mask = None if mask is None else mask.float()

    n_levels = len(reg_iterations)
    v = None
    for i, iters in enumerate(reg_iterations):
        scale = 2 ** (n_levels - 1 - i)
        hs, ws = h // scale, w // scale
        f = resize2d(fixed, (hs, ws))
        m = resize2d(moving, (hs, ws))
        msk = None if mask is None else resize2d(mask, (hs, ws))
        if v is None:
            v = torch.zeros((b, 2, hs, ws), dtype=torch.float32,
                            device=fixed.device)
        elif v.shape[2] != hs:
            # displacements scale with resolution
            v = resize2d(v, (hs, ws)) * (hs / v.shape[2])
        if iters > 0:
            v, _ = _optimize_level(f, m, msk, v, int(iters), sigma_flow,
                                   sigma_metric, lr, exp_steps)
    with torch.no_grad():
        if v.shape[2] != h:
            v = resize2d(v, (h, w)) * (h / v.shape[2])
        flow = exp_velocity(v, exp_steps)
        warped = apply_flow(moving, flow)
    return flow, warped
