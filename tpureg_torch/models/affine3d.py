"""3-D affine pre-registration, the counterpart of
``tpureg/models/affine3d.py:30-112`` (reference ``affmodel``,
models.py:156-191).

``AffineNet3D``: six strided 3-D convolutions with ReLU, flattened
channels-last (as flax's ``reshape(b, -1)`` flattens NDHWC) into a dense
layer that predicts a 3×4 affine matrix, initialised at the identity (zero
kernel, identity bias); the moving volume is warped by it. The dense
layer's input width depends on the volume size, which the constructor
takes.

``affine_warp3d`` applies ``theta`` with ``affine_grid(align_corners=False)``
semantics: normalised voxel centres in [-1, 1] mapped through ``theta`` and
sampled trilinearly with zero padding through ``sample3d``, so that on the
card the sample runs kernel K6a, and K6b in the backward to ``theta``.

NCDHW: input [B, 2, D, H, W] (fixed, moving); ``forward`` returns
``(theta [B, 3, 4], warped [B, 1, D, H, W])``.

``split``: None, or for the duration of a spatially sharded step an
``HSplit`` (``parallel/spatial.py``): the input is then this rank's slab of
the volume's H. The convolutions run on their slabs as far as the rows
split (every layer at 176 x 256 x 256 over 2 or 4 ranks; at H = 64 over 2
ranks conv6, whose input has 2 rows in all, runs whole on the gathered
conv5 output). The flatten puts H inside D, so a slab's features meet a
strided subset of the Dense layer's columns: θ is the ``all_sum`` over the
spatial ranks of the slab's features times those columns of ``fc.weight``
(viewed as [12, D', H', W', C]), plus ``fc.bias`` once, after the sum.
Every rank then holds the whole θ, and its warp samples the gathered
moving volume at its slab's output positions; ``warped`` is the slab of the
unsharded warp.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import conv3d
from ..ops.warp import sample3d
from ..parallel.mesh import all_sum

__all__ = ["AffineNet3D", "affine_warp3d"]

# (features, kernel, (sD, sH, sW)) of conv1..conv6 (affine3d.py:87-94)
SPECS = ((16, 7, (1, 2, 2)), (32, 5, (1, 2, 2)), (64, 3, (2, 2, 2)),
         (128, 3, (2, 2, 2)), (256, 3, (2, 2, 2)), (512, 3, (2, 2, 2)))
IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _norm_coords(n: int, device):
    """align_corners=False normalised voxel centres (-1 + 1/n .. 1 - 1/n)."""
    return (2.0 * torch.arange(n, dtype=torch.float32, device=device) + 1.0) / n - 1.0


def affine_warp3d(vol, theta, rows: Optional[Tuple[int, int]] = None):
    """Warp ``vol`` [B, C, D, H, W] by ``theta`` [B, 3, 4] (torch
    ``affine_grid`` + ``grid_sample(align_corners=False)``, zero padding).

    The normalised target of each voxel is ``theta @ (x, y, z, 1)``, summed
    in that order; the voxel position is ``((g + 1)·n − 1) / 2``.
    ``rows`` = (first, count): only those output rows of H, at their global
    normalised coordinates (a slab of the unsharded warp)."""
    _, _, d, h, w = vol.shape
    ys = _norm_coords(h, vol.device)
    if rows is not None:
        ys = ys.narrow(0, *rows)
    zz, yy, xx = torch.meshgrid(_norm_coords(d, vol.device), ys,
                                _norm_coords(w, vol.device), indexing="ij")
    t = theta.float()[:, :, :, None, None, None]  # [B, 3, 4, 1, 1, 1]
    pos = [xx * t[:, j, 0] + yy * t[:, j, 1] + zz * t[:, j, 2] + t[:, j, 3]
           for j in range(3)]
    px = ((pos[0] + 1.0) * w - 1.0) / 2.0
    py = ((pos[1] + 1.0) * h - 1.0) / 2.0
    pz = ((pos[2] + 1.0) * d - 1.0) / 2.0
    return sample3d(vol, px, py, pz)


def _out_size(n: int, kernel: int, stride: int) -> int:
    return (n + 2 * ((kernel - 1) // 2) - kernel) // stride + 1


class AffineNet3D(nn.Module):
    def __init__(self, volume_size: Sequence[int] = (176, 256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin, size = 2, tuple(volume_size)
        for i, (f, k, s) in enumerate(SPECS, start=1):
            self.add_module(f"conv{i}", conv3d(cin, f, k, s, generator=generator))
            size = tuple(_out_size(n, k, st) for n, st in zip(size, s))
            cin = f
        self.fc = nn.Linear(cin * size[0] * size[1] * size[2], 12)
        with torch.no_grad():
            self.fc.weight.zero_()
            self.fc.bias.copy_(torch.tensor(IDENTITY))
        self.split = None

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.split is not None:
            return self._forward_split(x, self.split)
        b = x.shape[0]
        moving = x[:, 1:2]
        y = x
        for i in range(1, len(SPECS) + 1):
            y = F.relu(getattr(self, f"conv{i}")(y))
        y = y.permute(0, 2, 3, 4, 1).reshape(b, -1)  # flax's NDHWC flatten
        theta = self.fc(y).reshape(b, 3, 4)
        return theta, affine_warp3d(moving, theta)

    def _forward_split(self, x, sp) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` on this rank's slab ``x`` of the volume's H (the module
        docstring)."""
        b, h = x.shape[0], x.shape[3] * sp.shards
        moving = x[:, 1:2]
        y, split = x, True
        for i in range(1, len(SPECS) + 1):
            y, split = sp.conv3d(getattr(self, f"conv{i}"), y, split)
            y = F.relu(y)
        y = y.permute(0, 2, 3, 4, 1)  # NDHWC, flax's flatten order
        if split:
            d_, h_, w_, c_ = y.shape[1:]
            weight = self.fc.weight.view(12, d_, h_ * sp.shards, w_, c_)
            weight = weight.narrow(2, sp.start(h_), h_)
            theta = all_sum(torch.einsum("bdhwc,jdhwc->bj", y, weight), sp.group)
            theta = theta + self.fc.bias
        else:
            theta = self.fc(y.reshape(b, -1))
        theta = theta.reshape(b, 3, 4)
        n = x.shape[3]
        return theta, affine_warp3d(sp.gather(moving), theta, (sp.start(n), n))
