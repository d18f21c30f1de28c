"""PWC-Net (PWC-DC) in plain PyTorch, grayscale-adapted, with the torch key
names of NVlabs' PWC-Net (PyTorch/models/PWCNet.py, PWCDCNet), as the
registration variant "pwc-reg" runs it:

a six-level feature pyramid (16 ... 196 channels, three 3×3 convolutions a
level, the first of stride 2; level 6 names its stride-2 convolution
``conv6aa``); from level 6 to 2 the moving feature is warped by the
upsampled flow times the level's scale (0.625, 1.25, 2.5, 5.0) with the
"pwc" convention and its validity mask, correlated with the fixed feature
(max displacement 4, 81 channels, leaky ReLU with slope 1 at 0) and decoded
by a densely connected block (128, 128, 96, 64, 32) that also sees the
fixed and the warped moving feature, the upsampled flow and features; a
dilated context network refines flow2, and two transposed convolutions
give flow1 and flow0. No BatchNorm. Returns the seven flows, finest first,
in both modes; ``deconv0`` is built and never called.

Initialisation (``init_rule``): kaiming-normal weights over the fan-in
(gain √2), zero biases, and the flow upsamplers ``deconv6`` ... ``deconv1``
exact 2× bilinear upsampling (the tent [1, 3, 3, 1]/4 per axis, gain 2,
identity over the channels).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import ops
from .blocks import conv_block, predict_flow, up_flow

_FEATS = (16, 32, 64, 96, 128, 196)
_DENSE = (128, 128, 96, 64, 32)
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_FLOW_UPSAMPLERS = tuple(f"deconv{i}" for i in range(1, 7))


def _names(lvl):
    return ("aa", "a", "b") if lvl == 6 else ("a", "aa", "b")


class PWCDCNet(nn.Module):
    def __init__(self, md=4, feed_warped=True):
        super().__init__()
        self.md, self.feed_warped = md, feed_warped
        block = lambda a, b, s=1, d=1: conv_block(a, b, 3, s, d, use_bn=False)
        cin = 1
        for lvl, f in enumerate(_FEATS, start=1):
            first, second, third = _names(lvl)
            setattr(self, f"conv{lvl}{first}", block(cin, f, 2))
            setattr(self, f"conv{lvl}{second}", block(f, f))
            setattr(self, f"conv{lvl}{third}", block(f, f))
            cin = f
        corr = ops.displacements(md) ** 2
        for lvl in (6, 5, 4, 3, 2):
            feat = _FEATS[lvl - 1]
            if lvl == 6:
                c = corr + (2 * feat if feed_warped else 0)
            else:
                c = corr + feat + 4 + (feat if feed_warped else 0)
            for i, f in enumerate(_DENSE):
                setattr(self, f"conv{lvl}_{i}", block(c, f))
                c += f
            setattr(self, f"predict_flow{lvl}", predict_flow(c, True))
            if lvl > 2:
                setattr(self, f"deconv{lvl}", up_flow(True))
                setattr(self, f"upfeat{lvl}", up_flow(True, c, 2))
        for i, (f, d) in enumerate(_CONTEXT, start=1):
            setattr(self, f"dc_conv{i}", block(c, f, 1, d))
            c = f
        self.dc_conv7 = predict_flow(c, True)
        self.deconv2 = up_flow(True)
        self.deconv1 = up_flow(True)
        self.deconv0 = up_flow(True, k=4, stride=4, padding=0)

    def _pyramid(self, im):
        out = []
        for lvl in range(1, 7):
            for name in _names(lvl):
                im = getattr(self, f"conv{lvl}{name}")(im)
            out.append(im)
        return out

    def _corr(self, a, b):
        return ops.leaky_relu_at_zero_one(ops.correlation(a, b, self.md, 1))

    def _decode(self, y, lvl):
        for i in range(len(_DENSE)):
            y = torch.cat([getattr(self, f"conv{lvl}_{i}")(y), y], 1)
        return y, getattr(self, f"predict_flow{lvl}")(y)

    def forward(self, x):
        p1 = self._pyramid(x[:, 0:1])
        p2 = self._pyramid(x[:, 1:2])
        parts = [self._corr(p1[5], p2[5])]
        if self.feed_warped:
            parts += [p1[5], p2[5]]
        y, flow = self._decode(torch.cat(parts, 1), 6)
        flows = {6: flow}
        up_fl, up_ft = self.deconv6(flow), self.upfeat6(y)
        for lvl in (5, 4, 3, 2):
            c1, c2 = p1[lvl - 1], p2[lvl - 1]
            warped = ops.warp(c2, up_fl * _SCALES[lvl], "pwc")
            parts = [self._corr(c1, warped), c1, up_fl, up_ft]
            if self.feed_warped:
                parts.insert(2, warped)
            y, flows[lvl] = self._decode(torch.cat(parts, 1), lvl)
            if lvl > 2:
                up_fl = getattr(self, f"deconv{lvl}")(flows[lvl])
                up_ft = getattr(self, f"upfeat{lvl}")(y)
        for i in range(1, 7):
            y = getattr(self, f"dc_conv{i}")(y)
        flow2 = flows[2] + self.dc_conv7(y)
        flow1 = self.deconv2(flow2)
        flow0 = self.deconv1(flow1)
        return (flow0, flow1, flow2, flows[3], flows[4], flows[5], flows[6])


def build(config):
    return PWCDCNet(config["correlation"]["max_displacement"], config["feed_warped"])


def _bilinear_tent(shape):
    cin, cout, kh, kw = shape
    f = torch.tensor([0.25, 0.75, 0.75, 0.25])
    return torch.eye(cin, cout)[:, :, None, None] * (f[:, None] * f[None, :] * 2.0)


def init_rule(module: nn.Module, name: str, key: str = ""):
    """How a leaf is drawn: ("normal", std), ("const", value) or ("tensor",
    fn(shape))."""
    if not ops.is_conv(module):
        raise ValueError(f"no initialiser for {type(module).__name__}.{name}")
    if name == "bias":
        return ("const", 0.0)
    if key.split(".")[0] in _FLOW_UPSAMPLERS:
        return ("tensor", _bilinear_tent)
    fan_in, _ = ops.init_fans(module)
    return ("normal", math.sqrt(2.0 / fan_in))
