"""Learned 3-D deformable registration, a VoxelMorph-style UNet that predicts
a stationary velocity field. Counterpart of
``tpureg/models/voxelmorph3d.py:68-141`` (probabilistic VoxelMorph,
Balakrishnan et al. 2019 / Dalca et al. 2018).

A stride-2 encoder of 3³ conv blocks (LeakyReLU 0.2, flax's), a decoder of
conv, nearest ×2 upsample and skip concatenation down to 1/``int_downsize``
resolution, refinement blocks, and an fp32 3³ velocity head initialised at
N(0, 1e-5) so that the initial map is close to the identity. The velocity is
exponentiated by ``int_steps`` scaling-and-squaring compositions at its own
resolution, upsampled (trilinear, align_corners=True, ×2 in magnitude) and
used to warp the moving volume. On the card each composition and the final
warp run the trilinear warp kernels (K6a forward, K6b backward to the
positions, K6c backward to the compositions' warped fields).

NCDHW: the input is [B, 2, D, H, W] (fixed, moving); ``forward`` returns
``(flow [B, 3, D, H, W] in voxels (u_x, u_y, u_z), warped [B, 1, D, H, W],
velocity [B, 3, D/s, H/s, W/s])``. D, H and W must be divisible by
2^len(enc_features). Module names follow the flax tree (``enc0.conv``,
``dec2.conv``, ``extra1.conv``, ``flow_head``).

``split``: None, or for the duration of a spatially sharded step an
``HSplit`` (``parallel/spatial.py``): the input is then this rank's slab of
the volume's H, and the model runs slab convolutions (halos from the
neighbouring ranks), the local nearest ×2 and concatenation, the velocity
head on the slab, the exponential's compositions on gathered fields at the
slab's global positions, the final resize from the gathered field and the
warp of the gathered moving volume; ``forward`` returns this rank's slabs
of ``flow``, ``warped`` and ``velocity``, the slabs of the unsharded
results. A layer whose rows stop splitting evenly runs whole on every rank
from there on (``HSplit.conv3d``); S·2^len(enc_features) dividing H keeps
every layer on its slab.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..classical.syn3d import exp_velocity3d
from ..nn.layers import conv3d, init_normal, leaky_relu
from ..ops.resize import resize_nd
from ..ops.warp import warp3d

__all__ = ["VoxelMorph3D"]


class _Conv3DBlock(nn.Module):
    """3³ conv (optional stride) + flax's LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = conv3d(cin, cout, 3, stride, generator=generator)

    def forward(self, x):
        return leaky_relu(self.conv(x), 0.2)


def _up2(x):
    """Nearest ×2 upsample of NCDHW ``x``."""
    d, h, w = x.shape[2:]
    return resize_nd(x, (2 * d, 2 * h, 2 * w), "nearest")


class VoxelMorph3D(nn.Module):
    def __init__(self, enc_features: Sequence[int] = (16, 32, 32, 32),
                 dec_features: Sequence[int] = (32, 32, 32),
                 extra_features: Sequence[int] = (32, 16, 16),
                 int_steps: int = 7, int_downsize: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if int_downsize not in (1, 2):
            raise ValueError(f"int_downsize must be 1 or 2, got {int_downsize}")
        self.n_enc = len(enc_features)
        self.n_dec = len(dec_features)
        self.n_up = max(self.n_dec, self.n_enc - (1 if int_downsize == 2 else 0))
        self.n_extra = len(extra_features)
        self.int_steps = int_steps
        self.int_downsize = int_downsize
        cin = 2
        for i, f in enumerate(enc_features):
            self.add_module(f"enc{i}", _Conv3DBlock(cin, f, 2, generator))
            cin = f
        skip_ch = list(enc_features)
        for i, f in enumerate(dec_features):
            self.add_module(f"dec{i}", _Conv3DBlock(cin, f, 1, generator))
            cin = f + skip_ch[-(i + 2)]
        # remaining upsamples (int_downsize=1): the last reaches the input
        # resolution, where there is no skip to concatenate
        for i in range(self.n_dec, self.n_up):
            self.add_module(f"dec{i}", _Conv3DBlock(cin, dec_features[-1], 1,
                                                     generator))
            cin = dec_features[-1] + (skip_ch[-(i + 2)] if i + 2 <= self.n_enc else 0)
        for i, f in enumerate(extra_features):
            self.add_module(f"extra{i}", _Conv3DBlock(cin, f, 1, generator))
            cin = f
        self.flow_head = conv3d(cin, 3, 3, kernel_init=init_normal(1e-5),
                                generator=generator)
        self.split = None

    def forward(self, x):
        if self.split is not None:
            return self._forward_split(x, self.split)
        d, h, w = x.shape[2:]
        moving = x[:, 1:2]
        skips = []
        y = x
        for i in range(self.n_enc):
            y = getattr(self, f"enc{i}")(y)
            skips.append(y)
        for i in range(self.n_up):
            y = _up2(getattr(self, f"dec{i}")(y))
            if i + 2 <= self.n_enc:
                y = torch.cat([y, skips[-(i + 2)]], dim=1)
        for i in range(self.n_extra):
            y = getattr(self, f"extra{i}")(y)
        # the velocity head in its weights' dtype: fp32 (fp64 for an fp64
        # model), whatever the trunk ran in
        velocity = self.flow_head(y.to(self.flow_head.weight.dtype))
        flow = exp_velocity3d(velocity, self.int_steps)
        if self.int_downsize == 2:
            flow = resize_nd(flow, (d, h, w), "linear", align_corners=True) * 2.0
        warped = warp3d(moving, flow)
        return flow, warped, velocity

    def _forward_split(self, x, sp):
        """``forward`` on this rank's slab ``x`` of the volume's H (the module
        docstring); each activation is carried with whether it is a slab."""
        d, h, w = x.shape[2], x.shape[3] * sp.shards, x.shape[4]
        moving = x[:, 1:2]

        def block(name, y, split):
            y, split = sp.conv3d(getattr(self, name).conv, y, split)
            return leaky_relu(y, 0.2), split

        skips = []
        y, split = x, True
        for i in range(self.n_enc):
            y, split = block(f"enc{i}", y, split)
            skips.append((y, split))
        for i in range(self.n_up):
            y, split = block(f"dec{i}", y, split)
            y = _up2(y)
            if i + 2 <= self.n_enc:
                skip, skip_split = skips[-(i + 2)]
                if skip_split and not split:
                    skip = sp.gather(skip)
                y = torch.cat([y, skip], dim=1)
        for i in range(self.n_extra):
            y, split = block(f"extra{i}", y, split)
        velocity, split = sp.conv3d(self.flow_head,
                                    y.to(self.flow_head.weight.dtype), split)
        if split:
            flow = exp_velocity3d(velocity, self.int_steps, sp)
        else:
            flow = sp.slab(exp_velocity3d(velocity, self.int_steps))
            velocity = sp.slab(velocity)
        if self.int_downsize == 2:
            flow = resize_nd(flow, (d, h, w), "linear", align_corners=True,
                             split=sp) * 2.0
        warped = warp3d(sp.gather(moving), flow, h_offset=sp.start(flow.shape[3]))
        return flow, warped, velocity
