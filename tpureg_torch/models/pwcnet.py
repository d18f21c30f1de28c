"""PWC-Net (PWC-DC): a feature pyramid, warping and a cost volume with dense
decoders. Counterpart of ``tpureg/models/pwcnet.py`` (reference
PWC/models/PWCNet.py:38-496, grayscale-adapted).

Per level 6 → 2 the moving pyramid's feature is warped by the upsampled flow
(times the level's scale 0.625, 1.25, 2.5, 5.0) with the "pwc" convention and
its validity mask, correlated with the fixed feature (md 4, 81 channels,
kernel K1 on the card) and decoded by a densely connected block into a flow
and upsampled features. A dilated context network refines flow2; two
stride-2 transposed convolutions give flow1 and flow0. No BatchNorm;
kaiming fan-in normal weights and zero biases. NCHW, with the reference's
torch key names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import (
    ConvBlock,
    TorchConvTranspose,
    WeightInit,
    init_kaiming_leaky,
    leaky_relu,
    predict_flow,
)
from ..ops.correlation import correlation, displacement_count
from ..ops.warp import warp2d
from ..utils.profiling import span

__all__ = ["PWCDCNet", "PWCDCNetOld"]

# flax's variance_scaling(2.0, "fan_in", "normal"): std sqrt(2 / fan_in)
_kaiming = init_kaiming_leaky(0.0)
_FEATS = (16, 32, 64, 96, 128, 196)
_DENSE = (128, 128, 96, 64, 32)
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_LEVEL_SPANS = {lvl: f"tpureg.model.level{lvl}" for lvl in _SCALES}


def _bilinear_up_init(gain: float = 2.0) -> WeightInit:
    """A k=4 s=2 transposed convolution that is 2× bilinear upsampling times
    ``gain``, identity over channels: the tent [1/4, 3/4, 3/4, 1/4] per axis
    in torch's (in, out, kh, kw) layout. The tent is flip-symmetric, so it is
    tpureg's kernel in either layout. Gain 2: a flow doubles in pixels as its
    resolution doubles."""

    def init(weight, fan_in, fan_out, generator):
        cin, cout, kh, kw = weight.shape
        if (kh, kw) != (4, 4):
            raise ValueError("the bilinear init is defined for k=4 s=2")
        f = torch.tensor([0.25, 0.75, 0.75, 0.25], dtype=weight.dtype)
        tent = f[:, None] * f[None, :] * gain
        eye = torch.eye(cin, cout, dtype=weight.dtype)
        weight.copy_(eye[:, :, None, None] * tent)

    return init


def _dense_decoder(net, lvl, cin, generator):
    """Register ``conv{lvl}_0..4`` and ``predict_flow{lvl}`` on ``net``;
    returns the decoder's output channels."""
    for i, f in enumerate(_DENSE):
        setattr(net, f"conv{lvl}_{i}", net._conv(cin, f, generator=generator))
        cin += f
    setattr(net, f"predict_flow{lvl}", predict_flow(
        cin, use_bias=True, kernel_init=_kaiming, generator=generator))
    return cin


def _context(net, cin, generator):
    """Register ``dc_conv1..7``, the dilated context network."""
    for i, (f, d) in enumerate(_CONTEXT, start=1):
        setattr(net, f"dc_conv{i}", net._conv(cin, f, dilation=d,
                                              generator=generator))
        cin = f
    net.dc_conv7 = predict_flow(cin, use_bias=True, kernel_init=_kaiming,
                                generator=generator)


class _PWCBase(nn.Module):
    """What both nets share: their convolution block, the cost volume and
    the context network's refinement of flow2."""

    @staticmethod
    def _conv(cin, cout, stride=1, dilation=1, generator=None):
        return ConvBlock(cin, cout, 3, stride, dilation=dilation, use_bn=False,
                         kernel_init=_kaiming, generator=generator)

    def _corr(self, a, b):
        # flax's leaky ReLU (slope 1 at 0): K1 writes exact zeros for taps
        # outside the image
        return leaky_relu(correlation(a, b, self.md, 1), 0.1)

    def _context_flow(self, y, flow2):
        for i in range(1, 7):
            y = getattr(self, f"dc_conv{i}")(y)
        return flow2 + self.dc_conv7(y)


class PWCDCNet(_PWCBase):
    """``flow_up_init``: "kaiming" (the reference's) or "bilinear", which
    starts the 2-channel flow upsamplers (``deconv6..1``) as exact 2×
    bilinear upsampling. ``feed_warped`` ("pwc-reg"): each level's decoder
    also sees the warped moving features, inserted after the fixed ones.

    Returns the 7 flows finest first, (flow0, ..., flow6), in train and eval
    mode. ``deconv0`` is built, as the reference builds it, so that the state
    dict has its keys, and never called."""

    def __init__(self, md: int = 4, flow_up_init: str = "kaiming",
                 feed_warped: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if flow_up_init not in ("kaiming", "bilinear"):
            raise ValueError(f"unknown flow_up_init {flow_up_init!r}")
        self.md = md
        self.feed_warped = feed_warped
        g = generator
        cin = 1
        for lvl, f in enumerate(_FEATS, start=1):
            # level 6 keeps the reference's naming quirk: conv6aa is the
            # stride-2 convolution and runs first
            first, second = ("a", "aa") if lvl < 6 else ("aa", "a")
            setattr(self, f"conv{lvl}{first}", self._conv(cin, f, 2, generator=g))
            setattr(self, f"conv{lvl}{second}", self._conv(f, f, generator=g))
            setattr(self, f"conv{lvl}b", self._conv(f, f, generator=g))
            cin = f
        flow_up = _bilinear_up_init() if flow_up_init == "bilinear" else _kaiming

        def up(name, cin, cout, init=_kaiming, **geometry):
            setattr(self, name, TorchConvTranspose(
                cin, cout, use_bias=True, kernel_init=init, generator=g,
                **geometry))

        corr_ch = displacement_count(md) ** 2
        for lvl in (6, 5, 4, 3, 2):
            feat = _FEATS[lvl - 1]
            if lvl == 6:
                cin = corr_ch + (2 * feat if feed_warped else 0)
            else:
                cin = corr_ch + feat + 4 + (feat if feed_warped else 0)
            cout = _dense_decoder(self, lvl, cin, g)
            if lvl > 2:
                up(f"deconv{lvl}", 2, 2, flow_up)
                up(f"upfeat{lvl}", cout, 2)
        _context(self, cout, g)
        up("deconv2", 2, 2, flow_up)
        up("deconv1", 2, 2, flow_up)
        up("deconv0", 2, 2, kernel_size=4, stride=4, padding=0)

    def _decode(self, y, lvl):
        for i in range(len(_DENSE)):
            y = torch.cat([getattr(self, f"conv{lvl}_{i}")(y), y], dim=1)
        return y, getattr(self, f"predict_flow{lvl}")(y)

    def _pyramid(self, im):
        outs = []
        for lvl in range(1, 7):
            first, second = ("a", "aa") if lvl < 6 else ("aa", "a")
            for name in (first, second, "b"):
                im = getattr(self, f"conv{lvl}{name}")(im)
            outs.append(im)
        return outs

    def forward(self, x):
        with span("tpureg.model.pyramid"):
            p1 = self._pyramid(x[:, 0:1])
            p2 = self._pyramid(x[:, 1:2])
        with span("tpureg.model.level6"):
            parts = [self._corr(p1[5], p2[5])]
            if self.feed_warped:
                parts += [p1[5], p2[5]]
            y, flow = self._decode(torch.cat(parts, dim=1), 6)
            flows = {6: flow}
            up_flow, up_feat = self.deconv6(flow), self.upfeat6(y)
        for lvl in (5, 4, 3, 2):
            with span(_LEVEL_SPANS[lvl]):
                c1, c2 = p1[lvl - 1], p2[lvl - 1]
                warped = warp2d(c2, up_flow * _SCALES[lvl], convention="pwc")
                parts = [self._corr(c1, warped), c1, up_flow, up_feat]
                if self.feed_warped:
                    parts.insert(2, warped)
                y, flows[lvl] = self._decode(torch.cat(parts, dim=1), lvl)
                if lvl > 2:
                    up_flow = getattr(self, f"deconv{lvl}")(flows[lvl])
                    up_feat = getattr(self, f"upfeat{lvl}")(y)
        with span("tpureg.model.context"):
            flow2 = self._context_flow(y, flows[2])
            flow1 = self.deconv2(flow2)
            flow0 = self.deconv1(flow1)
        return (flow0, flow1, flow2, flows[3], flows[4], flows[5], flows[6])


class PWCDCNetOld(_PWCBase):
    """The legacy RGB PWC-DC net (reference PWCNet.py:282-496): a 6-channel
    pair (``x[:, :3]`` fixed, ``x[:, 3:]`` moving), two convolutions a
    pyramid level, the dense decoder's concatenations ordered [y, c] except
    at step 1, [c, y], and the "pwc" warp's mask threshold 0.999. Train mode
    returns (flow2, ..., flow6), eval mode the bare flow2. ``deconv2`` is
    built, as the reference builds it, and never called."""

    def __init__(self, md: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.md = md
        g = generator
        cin = 3
        for lvl, f in enumerate(_FEATS, start=1):
            setattr(self, f"conv{lvl}a", self._conv(cin, f, 2, generator=g))
            setattr(self, f"conv{lvl}b", self._conv(f, f, generator=g))
            cin = f

        def up(name, cin):
            setattr(self, name, TorchConvTranspose(
                cin, 2, use_bias=True, kernel_init=_kaiming, generator=g))

        corr_ch = displacement_count(md) ** 2
        for lvl in (6, 5, 4, 3, 2):
            cin = corr_ch if lvl == 6 else corr_ch + _FEATS[lvl - 1] + 4
            cout = _dense_decoder(self, lvl, cin, g)
            if lvl > 2:
                up(f"deconv{lvl}", 2)
                up(f"upfeat{lvl}", cout)
        up("deconv2", 2)
        _context(self, cout, g)

    def _decode(self, y, lvl):
        for i in range(len(_DENSE)):
            c = getattr(self, f"conv{lvl}_{i}")(y)
            y = torch.cat([c, y] if i == 1 else [y, c], dim=1)
        return y, getattr(self, f"predict_flow{lvl}")(y)

    def _pyramid(self, im):
        outs = []
        for lvl in range(1, 7):
            im = getattr(self, f"conv{lvl}b")(getattr(self, f"conv{lvl}a")(im))
            outs.append(im)
        return outs

    def forward(self, x):
        p1 = self._pyramid(x[:, 0:3])
        p2 = self._pyramid(x[:, 3:6])
        y, flow = self._decode(self._corr(p1[5], p2[5]), 6)
        flows = {6: flow}
        up_flow, up_feat = self.deconv6(flow), self.upfeat6(y)
        for lvl in (5, 4, 3, 2):
            c1, c2 = p1[lvl - 1], p2[lvl - 1]
            warped = warp2d(c2, up_flow * _SCALES[lvl], convention="pwc",
                            mask_threshold=0.999)
            y, flows[lvl] = self._decode(
                torch.cat([self._corr(c1, warped), c1, up_flow, up_feat], dim=1),
                lvl)
            if lvl > 2:
                up_flow = getattr(self, f"deconv{lvl}")(flows[lvl])
                up_feat = getattr(self, f"upfeat{lvl}")(y)
        flow2 = self._context_flow(y, flows[2])
        if self.training:
            return (flow2, flows[3], flows[4], flows[5], flows[6])
        return flow2
