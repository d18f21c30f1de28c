"""Segmentation metrics: Dice and modified Hausdorff over FSL FAST labels.

Reference semantics (utils.py:72-91, 155-211):

- labels {1, 2, 3} = CSF / GM / WM from FSL FAST segmentations; each metric
  is computed per label on the binarized mask and averaged over the three
- Dice: 2|A∩B| / (|A|+|B|) (utils.py:72-76); note no empty-mask guard — an
  empty pair yields nan, as in the reference
- modified Hausdorff (Dubuisson-Jain 1994): max of the two mean directed
  boundary-point distances (utils.py:187-198)
- boundary points: the reference extracts skimage ``find_contours`` points
  cast to int (utils.py:155-170); ``metrics/contours.py`` reimplements the
  marching-squares algorithm (including the closed-contour duplicate
  endpoint that enters the reference's means), so Hausdorff numbers are
  reference-comparable. ``boundary_points`` (4-neighbor pixels) remains as
  the cheaper geometric variant used by older callers/tests.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist

from .contours import extract_boundary_points, find_contours

__all__ = ["dice_coefficient", "seg_trans", "dice_average", "dist_hausdorff",
           "boundary_points", "modified_hausdorff", "extract_boundary_points",
           "find_contours"]


def seg_trans(seg, target: int):
    """Binarize ``seg`` to {0,1} keeping only ``target`` (utils.py:79-84)."""
    seg = np.asarray(seg)
    return (seg == target).astype(np.float64)


def dice_coefficient(y_true, y_pred) -> float:
    a = np.asarray(y_true, np.float64).ravel()
    b = np.asarray(y_pred, np.float64).ravel()
    inter = float((a * b).sum())
    return 2.0 * inter / (a.sum() + b.sum())


def dice_average(y_true, y_pred, labels=(1, 2, 3)) -> float:
    return float(
        np.mean([dice_coefficient(seg_trans(y_true, i), seg_trans(y_pred, i))
                 for i in labels])
    )


def boundary_points(mask) -> np.ndarray:
    """(N, 2) integer (row, col) boundary pixels of a binary mask."""
    m = np.asarray(mask) > 0.5
    if not m.any():
        return np.empty((0, 2), dtype=np.int64)
    interior = np.zeros_like(m)
    interior[1:-1, 1:-1] = (
        m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:]
    )
    edge = m & ~interior
    return np.argwhere(edge)


def modified_hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    """Dubuisson-Jain modified Hausdorff distance between point sets."""
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    d = cdist(a, b)
    fhd = float(np.mean(np.min(d, axis=0)))
    rhd = float(np.mean(np.min(d, axis=1)))
    return max(fhd, rhd)


def dist_hausdorff(seg1, seg2, labels=(1, 2, 3)) -> float:
    """Mean per-label modified Hausdorff over marching-squares boundary
    points cast to int — the reference's exact recipe (utils.py:199-211)."""
    dists = []
    for i in labels:
        p1 = extract_boundary_points(seg_trans(seg1, i))
        p2 = extract_boundary_points(seg_trans(seg2, i))
        dists.append(modified_hausdorff(p1, p2))
    return float(np.mean(dists))
