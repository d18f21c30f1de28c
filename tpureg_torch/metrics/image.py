"""Intensity-image metrics: MSE / PSNR / MI / Pearson / SSIM.

Host-side numpy implementations matching the reference's eval suite
(inference.py:67-75):

- ``MSE``/``PSNR``: utils.py:41-49 (PSNR capped at 100 for ~zero MSE)
- ``MI``: utils.py:52-55 — intensities quantized by round(x*1500) then the
  discrete mutual information over the label pair histogram (torchmetrics
  ``mutual_info_score`` semantics: natural log, joint-count formulation)
- ``CORR``: utils.py:58-59 — Pearson correlation of the flattened images
- ``ssim``: skimage ``structural_similarity`` semantics (inference.py:71-72):
  7×7 uniform windows, K1=0.01/K2=0.03, sample-covariance normalization,
  border crop of win_size//2 before averaging. (skimage is not available in
  this environment, so the formula is reimplemented 1:1; see
  tests/test_metrics.py for the invariance checks.)

These run on host CPU over per-sample 2-D arrays — they are outside the jit
path by design, like the reference (SURVEY.md §7 "Hausdorff/MI metrics are
inherently host/dynamic-shape").
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

__all__ = ["MSE", "PSNR", "MI", "CORR", "ssim"]


def _np(x):
    return np.asarray(x, dtype=np.float64)


def MSE(fixed, warped) -> float:
    fixed, warped = _np(fixed), _np(warped)
    return float(np.mean((warped - fixed) ** 2))


def PSNR(fixed, warped) -> float:
    mse = MSE(fixed, warped)
    if mse < 1.0e-10:
        return 100.0
    return float(10.0 * np.log10(1.0 / mse))


def MI(fixed, warped, scale: int = 1500) -> float:
    """Discrete mutual information over round(x*scale) labels (natural log)."""
    a = np.rint(_np(fixed) * scale).astype(np.int64).ravel()
    b = np.rint(_np(warped) * scale).astype(np.int64).ravel()
    # contingency table over observed labels only (sparse-friendly)
    a_vals, a_idx = np.unique(a, return_inverse=True)
    b_vals, b_idx = np.unique(b, return_inverse=True)
    joint = np.zeros((a_vals.size, b_vals.size), np.float64)
    np.add.at(joint, (a_idx, b_idx), 1.0)
    n = joint.sum()
    pij = joint / n
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    return float(np.sum(pij[nz] * (np.log(pij[nz]) - np.log((pi @ pj)[nz]))))


def CORR(fixed, warped) -> float:
    a, b = _np(fixed).ravel(), _np(warped).ravel()
    va, vb = a - a.mean(), b - b.mean()
    denom = np.sqrt((va**2).sum()) * np.sqrt((vb**2).sum())
    if denom == 0:
        return 0.0
    return float((va * vb).sum() / denom)


def ssim(im1, im2, data_range: float = 1.0, win_size: int = 7) -> float:
    """Mean structural similarity, skimage-default semantics (see module doc)."""
    im1, im2 = _np(im1), _np(im2)
    if im1.shape != im2.shape:
        raise ValueError("ssim: shape mismatch")
    k1, k2 = 0.01, 0.03
    np_win = win_size**2
    cov_norm = np_win / (np_win - 1)  # sample covariance

    def f(x):
        return uniform_filter(x, size=win_size)

    ux, uy = f(im1), f(im2)
    uxx, uyy, uxy = f(im1 * im1), f(im2 * im2), f(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())
