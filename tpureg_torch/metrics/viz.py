"""Visualization helpers: flow magnitude heatmap + alignment grid image.

Reference: utils.py:26-38 (JET colormap of the inverted normalized flow
magnitude, plus the summed magnitude scalar) and utils.py:15-23 (the 16-px
grid pattern warped for deformation visualization).
"""

from __future__ import annotations

import numpy as np

__all__ = ["flow_mag", "flow_mag_sum", "grid_generator"]


def flow_mag_sum(flow):
    """The summed magnitude of flow [1, H, W, 2]: ``flow_mag``'s scalar,
    without the JET panel and so without OpenCV."""
    flow = np.asarray(flow)
    ux, uy = flow[0, ..., 0], flow[0, ..., 1]
    return float(np.sqrt(ux**2 + uy**2).sum())


def flow_mag(flow):
    """(sum_magnitude, [1, 3, H, W] JET uint8 image) for flow [1, H, W, 2].

    Matches reference utils.py:26-38: magnitude min-max normalized to 255,
    inverted, JET colormapped (cv2), CHW-ordered for TensorBoard.
    """
    import cv2

    flow = np.asarray(flow)
    ux, uy = flow[0, ..., 0], flow[0, ..., 1]
    mag = np.sqrt(ux**2 + uy**2)
    lo, hi = mag.min(), mag.max()
    denom = (hi - lo) if hi > lo else 1.0
    norm = (mag - lo) / denom * 255.0
    norm = (255.0 - norm).astype(np.uint8)
    colored = cv2.applyColorMap(norm, cv2.COLORMAP_JET)  # HWC BGR uint8
    chw = np.transpose(colored, (2, 0, 1))[None]
    return float(mag.sum()), chw


def grid_generator(size: int = 256, spacing: int = 16, offset: int = 7):
    """[size, size] float grid-line image (reference utils.py:15-23)."""
    img = np.zeros((size, size), np.float32)
    idx = np.arange(offset, size - 1, spacing)
    img[idx, :] = 1.0
    img[:, idx] = 1.0
    return img
