"""RAFT: recurrent all-pairs field transforms, the counterpart of
``tpureg/models/raft.py`` (the compact, "small"-class RAFT that tpureg
registers as "raft", and its registration variant "raft-reg").

A residual encoder (GroupNorm) gives features of both frames at 1/8 (or,
for ``downsample=4``, 1/4) resolution and a context encoder the GRU's
initial hidden state and its input. The all-pairs correlation of the two
feature maps, a cuBLAS product scaled by 1/√C, is average-pooled into a
4-level pyramid of [B·H·W, 1, h_l, w_l] maps, one per source pixel. Each of
the ``iters`` iterations looks the pyramid up around ``coords0 + flow``,
(2r+1)² = 81 positions a level at 1/2^l of the centre, with the bilinear
sample ``ops.warp.sample2d`` (kernel K3 on the card, K4 and K5 in the
backward), feeds [lookup, flow] (and for ``feed_warped`` the moving
features warped by the flow, "pixel" convention, and the fixed features)
to a motion encoder, updates the ConvGRU and adds the flow head's output to
the flow. Every iteration's flow is upsampled to the input's size
(bilinear, align_corners=False) and scaled by ``downsample``; the tuple is
returned finest (most refined) first. Nothing is detached: from the second
iteration on the lookups and the feature warp take a positions' gradient.

tpureg's gather-free ``_lookup_windows`` exists only to keep the TPU off
gathers and is not ported: the lookup here is its 4-tap gather form
(``use_windows=False``), which computes the same function.

Modules carry flax's names (``fnet.res1a.norm1``, ``menc1``, ``gru.convz``,
``fh2``, ...) and flax's default initialisation, lecun-normal kernels, zero
biases, GroupNorm scale 1 and bias 0, drawn from the module's generator.
As flax's ``Conv`` does, each convolution promotes its input and weights to
their common dtype, so in a bf16 step everything after the fp32
correlation runs in fp32 with bf16-rounded weights, as in tpureg. NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.layers import bias_zeros, init_lecun_normal, init_module_
from ..ops.resize import resize2d
from ..ops.warp import _compute_dtype, base_grid, sample2d, warp2d

__all__ = ["RAFT", "GroupNorm", "corr_pyramid", "lookup"]


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm``: statistics over each group's channels and
    pixels in fp32 (fp64 for an fp64 input), the variance as E[x²] − E[x]²
    clipped at 0, eps 1e-6, then ``(x − mean) · (rsqrt(var + eps) · scale)
    + bias`` in that precision, returned in the input's dtype. The scale is
    ``weight``."""

    def __init__(self, channels: int, num_groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c, h, w = x.shape
        compute = _compute_dtype(x)
        xf = x.to(compute)
        grouped = xf.reshape(b, self.num_groups, -1)
        mean = grouped.mean(2)
        var = torch.clamp((grouped * grouped).mean(2) - mean * mean, min=0.0)
        size = c // self.num_groups
        mean = mean.repeat_interleave(size, 1)[:, :, None, None]
        mul = torch.rsqrt(var + self.eps).repeat_interleave(size, 1)
        mul = (mul * self.weight.to(compute))[:, :, None, None]
        y = (xf - mean) * mul + self.bias.to(compute)[:, None, None]
        return y.to(x.dtype)


class _Conv(nn.Conv2d):
    """flax's ``nn.Conv`` with symmetric padding (k − 1) / 2, lecun-normal
    kernel and zero bias; input and parameters are promoted to their common
    dtype before the product, as flax promotes them."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, k, stride, (k - 1) // 2)
        init_module_(self, init_lecun_normal(), bias_zeros, generator)

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype),
                                  self.bias.to(dtype))


class _ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _Conv(cin, features, 3, stride, generator)
        self.norm1 = GroupNorm(features)
        self.conv2 = _Conv(features, features, 3, 1, generator)
        self.norm2 = GroupNorm(features)
        self.proj = (_Conv(cin, features, 1, stride, generator)
                     if stride != 1 or cin != features else None)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.proj is not None:
            x = self.proj(x)
        return torch.relu(x + y)


class _Encoder(nn.Module):
    """The residual encoder at 1/8 resolution, or 1/4 with
    ``final_stride=1`` (raft-reg)."""

    def __init__(self, out_features: int, final_stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stem = _Conv(1, 32, 7, 2, g)
        self.stem_norm = GroupNorm(32)
        self.res1a = _ResBlock(32, 32, 1, g)
        self.res2a = _ResBlock(32, 64, 2, g)
        self.res2b = _ResBlock(64, 64, 1, g)
        self.res3a = _ResBlock(64, 96, final_stride, g)
        self.res3b = _ResBlock(96, 96, 1, g)
        self.head = _Conv(96, out_features, 1, 1, g)

    def forward(self, x):
        y = torch.relu(self.stem_norm(self.stem(x)))
        for block in (self.res1a, self.res2a, self.res2b, self.res3a, self.res3b):
            y = block(y)
        return self.head(y)


def corr_pyramid(f1, f2, levels: int = 4):
    """All-pairs correlation of ``f1``, ``f2`` [B, C, H, W] scaled by 1/√C,
    as [B·H·W, 1, H, W] maps (one a source pixel of ``f1``, over the pixels
    of ``f2``), and ``levels − 1`` 2 x 2 average pools of it. tpureg divides
    by √C rounded to fp32 and promotes a bf16 product to fp32 on the way,
    so the pyramid is fp32 (fp64 for fp64 features)."""
    b, c, h, w = f1.shape
    corr = torch.bmm(f1.reshape(b, c, h * w).transpose(1, 2), f2.reshape(b, c, h * w))
    scale = float(torch.tensor(float(c), dtype=torch.float32).sqrt())
    # out of place: ``remat="dots"`` keeps the product for the backward
    corr = corr.to(torch.promote_types(corr.dtype, torch.float32)) / scale
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = nn.functional.avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def lookup(pyramid, coords, radius: int = 4):
    """Sample every level of ``pyramid`` around ``coords`` [B, 2, H, W]
    (absolute (x, y) positions at the pyramid's level-0 resolution): level l
    at ``coords / 2^l + (dx, dy)`` for dx, dy in −r..r, dy-major. Returns
    [B, levels·(2r+1)², H, W]; tpureg's ``_lookup`` in its gather form, one
    ``sample2d`` (K3 on the card) a level over B·H·W one-channel maps."""
    b, _, h, w = coords.shape
    n = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    cx = coords[:, 0].reshape(b * h * w, 1)
    cy = coords[:, 1].reshape(b * h * w, 1)
    outs = []
    for lvl, corr in enumerate(pyramid):
        scale = 2.0**lvl
        vals = sample2d(corr, cx / scale + dx.reshape(1, n * n),
                        cy / scale + dy.reshape(1, n * n))
        outs.append(vals.reshape(b, h, w, n * n).permute(0, 3, 1, 2))
    return torch.cat(outs, 1)


class _GRU(nn.Module):
    def __init__(self, hidden: int, cin: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convz = _Conv(hidden + cin, hidden, 3, 1, generator)
        self.convr = _Conv(hidden + cin, hidden, 3, 1, generator)
        self.convq = _Conv(hidden + cin, hidden, 3, 1, generator)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class RAFT(nn.Module):
    """tpureg's ``RAFT``: ``iters`` iterations, ``corr_levels`` pyramid
    levels of radius ``corr_radius``, a GRU of ``hidden`` channels, working
    at 1/``downsample`` of the input (8, or 4 for raft-reg); ``feed_warped``
    (raft-reg) also gives the motion encoder the moving features warped by
    the current flow and the fixed features. Returns the ``iters`` flows
    [B, 2, H, W] in pixels of the input, finest (last iteration) first, in
    train and eval mode."""

    def __init__(self, iters: int = 5, corr_levels: int = 4, corr_radius: int = 4,
                 hidden: int = 96, feed_warped: bool = False, downsample: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if downsample not in (4, 8):
            raise ValueError(f"downsample must be 4 or 8, got {downsample}")
        self.iters, self.corr_levels, self.corr_radius = iters, corr_levels, corr_radius
        self.hidden, self.feed_warped, self.downsample = hidden, feed_warped, downsample
        g = generator
        fs = 2 if downsample == 8 else 1
        self.fnet = _Encoder(128, fs, g)
        self.cnet = _Encoder(hidden + 64, fs, g)
        motion_in = corr_levels * (2 * corr_radius + 1) ** 2 + 2
        if feed_warped:
            motion_in += 2 * 128
        self.menc1 = _Conv(motion_in, 96, 1, 1, g)
        self.menc2 = _Conv(96, 64, 3, 1, g)
        self.gru = _GRU(hidden, 64 + 64, g)
        self.fh1 = _Conv(hidden, 128, 3, 1, g)
        self.fh2 = _Conv(128, 2, 3, 1, g)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        b, _, h, w = x.shape
        x1, x2 = x[:, 0:1], x[:, 1:2]
        f1, f2 = self.fnet(x1), self.fnet(x2)
        ctx = self.cnet(x1)
        hidden = torch.tanh(ctx[:, :self.hidden])
        inp = torch.relu(ctx[:, self.hidden:])

        pyramid = corr_pyramid(f1, f2, self.corr_levels)
        h8, w8 = f1.shape[2], f1.shape[3]
        compute = _compute_dtype(pyramid[0])
        coords0 = base_grid(h8, w8, x.device, compute).permute(2, 0, 1)[None]
        flow = torch.zeros((b, 2, h8, w8), dtype=compute, device=x.device)

        flows_up = []
        for _ in range(self.iters):
            m_in = [lookup(pyramid, coords0 + flow, self.corr_radius), flow]
            if self.feed_warped:
                m_in += [warp2d(f2, flow, convention="pixel"), f1]
            m = torch.relu(self.menc2(torch.relu(self.menc1(torch.cat(m_in, 1)))))
            hidden = self.gru(hidden, torch.cat([m, inp], 1))
            flow = flow + self.fh2(torch.relu(self.fh1(hidden)))
            flows_up.append(resize2d(flow, (h, w), "bilinear", align_corners=False)
                            * float(self.downsample))
        return tuple(reversed(flows_up))
