"""Optical-flow file I/O and color-wheel visualization, a numpy copy of
``tpureg/utils/flow_io.py``.

Capability parity with the reference's flow utilities
(flownet2/utils/flow_utils.py:7-204 and frame_utils.py:6-18):

- Middlebury ``.flo`` read/write (magic 202021.25, little-endian W,H then
  interleaved (u, v) float32)
- flow → RGB visualization via the standard Middlebury color wheel
  (Baker et al.): hue encodes direction, saturation encodes magnitude,
  unknown/invalid flow (>1e7) rendered black
- ``read_gen``: extension-dispatched generic reader for images and .flo

Flows here are [H, W, 2] numpy arrays, (u_x, u_y) last.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_flo", "write_flo", "flow_to_image", "make_color_wheel",
           "read_gen"]

_TAG_FLOAT = 202021.25
_UNKNOWN_THRESH = 1e7


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file → [H, W, 2] float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_TAG_FLOAT):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    if data.size != 2 * w * h:
        raise ValueError(f"{path}: truncated .flo payload")
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write [H, W, 2] float32 flow as Middlebury .flo."""
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    assert c == 2, "flow must be [H, W, 2]"
    with open(path, "wb") as f:
        np.array([_TAG_FLOAT], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


def make_color_wheel() -> np.ndarray:
    """(55, 3) Middlebury color wheel (RY/YG/GC/CB/BM/MR segments)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    segments = [
        (ry, [0, 1], 255, True),   # R→Y: G ramps up
        (yg, [1, 0], 255, False),  # Y→G: R ramps down
        (gc, [1, 2], 255, True),   # G→C: B ramps up
        (cb, [2, 1], 255, False),  # C→B: G ramps down
        (bm, [2, 0], 255, True),   # B→M: R ramps up
        (mr, [0, 2], 255, False),  # M→R: B ramps down
    ]
    for n, (hold, ramp), level, up in segments:
        wheel[col : col + n, hold] = level
        vals = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, ramp] = vals if up else 255 - vals
        col += n
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow → [H, W, 3] uint8 color-wheel visualization."""
    flow = np.asarray(flow, np.float64)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    invalid = (np.abs(u) > _UNKNOWN_THRESH) | (np.abs(v) > _UNKNOWN_THRESH) \
        | np.isnan(u) | np.isnan(v)
    u[invalid] = 0.0
    v[invalid] = 0.0

    rad = np.sqrt(u**2 + v**2)
    maxrad = max(rad.max(), 1e-9)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u**2 + v**2)

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for ch in range(3):
        col0 = wheel[k0, ch] / 255.0
        col1 = wheel[k1, ch] / 255.0
        col = (1 - f) * col0 + f * col1
        # saturate toward white at low magnitude
        small = rad <= 1
        col[small] = 1 - rad[small] * (1 - col[small])
        col[~small] = col[~small] * 0.75
        img[..., ch] = np.where(invalid, 0, np.floor(255 * col)).astype(np.uint8)
    return img


def read_gen(path: str):
    """Extension-dispatched reader: images (.png/.jpg/...) or .flo."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path)
    if ext in (".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".tif", ".tiff"):
        from PIL import Image

        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            img = img[..., None]
        return img
    raise ValueError(f"read_gen: unsupported extension {ext}")
