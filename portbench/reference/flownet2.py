"""FlowNet 2.0 in plain PyTorch, grayscale-adapted (a [B, 2, H, W] fixed /
moving pair), with the torch key names of NVIDIA's flownet2-pytorch
(networks/FlowNetC.py, FlowNetS.py, FlowNetSD.py, FlowNetFusion.py and
models.py FlowNet2):

C → S1 → S2 ∥ SD → Fusion. FlowNetC correlates the stride-8 features at
max displacement 20, stride 2 (441 channels). Each S block sees the pair,
the moving image warped by the previous flow (Resample2d: the "pixel"
warp), the flow / 20 and the brightness error's channel norm. S2's and SD's
flows are upsampled by nearest ×4, SD's divided by 20. The fused flow is
returned twice, so the loss sees two identical scales. Training mode
returns the subnets' five flows, evaluation mode their finest; the cascade
returns (fused, fused) in both.

Initialisation (``init_rule``): xavier-uniform weights and U(0, 1) biases
(flownet2-pytorch's convention), BatchNorm scale 1 and shift 0, running
mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import ops
from .blocks import conv_block, deconv, iconv_block, predict_flow, up_flow

# level: (concat width, deconv input width, deconv width)
_LEVELS = ((5, 1026, 1024, 512), (4, 770, 1026, 256), (3, 386, 770, 128),
           (2, 194, 386, 64))


def _decoder(net, upflow_bias):
    net.predict_flow6 = predict_flow(1024, True)
    for lvl, cat, din, dout in _LEVELS:
        setattr(net, f"upsampled_flow{lvl + 1}_to_{lvl}", up_flow(upflow_bias))
        setattr(net, f"deconv{lvl}", deconv(din, dout, True))
        setattr(net, f"predict_flow{lvl}", predict_flow(cat, True))


def _refine(net, lvl, concat, skip, flow):
    up = getattr(net, f"upsampled_flow{lvl + 1}_to_{lvl}")(flow)
    feat = getattr(net, f"deconv{lvl}")(concat)
    h, w = skip.shape[2:]
    cat = torch.cat([skip, feat[:, :, :h, :w], up[:, :, :h, :w]], 1)
    return cat, getattr(net, f"predict_flow{lvl}")(cat)


def _decode(net, c6, skips):
    """predict_flow6 and levels 5..2 → (flow2, flow3, flow4, flow5, flow6)."""
    flows = [net.predict_flow6(c6)]
    cat = c6
    for lvl, skip in zip((5, 4, 3, 2), skips):
        cat, f = _refine(net, lvl, cat, skip, flows[-1])
        flows.append(f)
    return tuple(reversed(flows))


class FlowNetC(nn.Module):
    def __init__(self, use_bn=True, md=20, s2=2):
        super().__init__()
        self.md, self.s2 = md, s2
        k = ops.displacements(md, s2)
        self.conv1 = conv_block(1, 64, 7, 2, use_bn=use_bn)
        self.conv2 = conv_block(64, 128, 5, 2, use_bn=use_bn)
        self.conv3 = conv_block(128, 256, 5, 2, use_bn=use_bn)
        self.conv_redir = conv_block(256, 32, 1, 1, use_bn=use_bn)
        self.conv3_1 = conv_block(32 + k * k, 256, use_bn=use_bn)
        self.conv4 = conv_block(256, 512, 3, 2, use_bn=use_bn)
        self.conv4_1 = conv_block(512, 512, use_bn=use_bn)
        self.conv5 = conv_block(512, 512, 3, 2, use_bn=use_bn)
        self.conv5_1 = conv_block(512, 512, use_bn=use_bn)
        self.conv6 = conv_block(512, 1024, 3, 2, use_bn=use_bn)
        self.conv6_1 = conv_block(1024, 1024, use_bn=use_bn)
        _decoder(self, upflow_bias=True)

    def forward(self, x):
        c2a = self.conv2(self.conv1(x[:, 0:1]))
        c3a = self.conv3(c2a)
        c3b = self.conv3(self.conv2(self.conv1(x[:, 1:2])))
        corr = ops.leaky_relu_at_zero_one(ops.correlation(c3a, c3b, self.md, self.s2))
        c3 = self.conv3_1(torch.cat([self.conv_redir(c3a), corr], 1))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        flows = _decode(self, c6, (c5, c4, c3, c2a))
        return flows if self.training else flows[:1]


class FlowNetS(nn.Module):
    """NVIDIA's FlowNetS block on a 6-channel stack."""

    def __init__(self, cin=6, use_bn=True):
        super().__init__()
        for name, a, b, k, s in (("conv1", cin, 64, 7, 2), ("conv2", 64, 128, 5, 2),
                                 ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1),
                                 ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
                                 ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
                                 ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1)):
            setattr(self, name, conv_block(a, b, k, s, use_bn=use_bn))
        _decoder(self, upflow_bias=False)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        flows = _decode(self, c6, (c5, c4, c3, c2))
        return flows if self.training else flows[:1]


class FlowNetSD(nn.Module):
    def __init__(self, use_bn=True):
        super().__init__()
        for name, a, b, s in (("conv0", 2, 64, 1), ("conv1", 64, 64, 2),
                              ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
                              ("conv2_1", 128, 128, 1), ("conv3", 128, 256, 2),
                              ("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2),
                              ("conv4_1", 512, 512, 1), ("conv5", 512, 512, 2),
                              ("conv5_1", 512, 512, 1), ("conv6", 512, 1024, 2),
                              ("conv6_1", 1024, 1024, 1)):
            setattr(self, name, conv_block(a, b, 3, s, use_bn=use_bn))
        self.predict_flow6 = predict_flow(1024, True)
        for lvl, cat, din, dout in _LEVELS:
            setattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}", up_flow(True))
            setattr(self, f"deconv{lvl}", deconv(din, dout, True))
            setattr(self, f"inter_conv{lvl}", iconv_block(cat, dout, use_bn))
            setattr(self, f"predict_flow{lvl}", predict_flow(dout, True))

    def forward(self, x):
        c1 = self.conv1_1(self.conv1(self.conv0(x)))
        c2 = self.conv2_1(self.conv2(c1))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        flows = [self.predict_flow6(c6)]
        cat = c6
        for (lvl, *_), skip in zip(_LEVELS, (c5, c4, c3, c2)):
            up = getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(flows[-1])
            feat = getattr(self, f"deconv{lvl}")(cat)
            h, w = skip.shape[2:]
            cat = torch.cat([skip, feat[:, :, :h, :w], up[:, :, :h, :w]], 1)
            flows.append(getattr(self, f"predict_flow{lvl}")(
                getattr(self, f"inter_conv{lvl}")(cat)))
        flows = tuple(reversed(flows))
        return flows if self.training else flows[:1]


class FlowNetFusion(nn.Module):
    def __init__(self, use_bn=True):
        super().__init__()
        self.conv0 = conv_block(9, 64, use_bn=use_bn)
        self.conv1 = conv_block(64, 64, 3, 2, use_bn=use_bn)
        self.conv1_1 = conv_block(64, 128, use_bn=use_bn)
        self.conv2 = conv_block(128, 128, 3, 2, use_bn=use_bn)
        self.conv2_1 = conv_block(128, 128, use_bn=use_bn)
        self.predict_flow2 = predict_flow(128, True)
        self.upsampled_flow2_to_1 = up_flow(True)
        self.deconv1 = deconv(128, 32, True)
        self.inter_conv1 = iconv_block(162, 32, use_bn)
        self.predict_flow1 = predict_flow(32, True)
        self.upsampled_flow1_to_0 = up_flow(True)
        self.deconv0 = deconv(162, 16, True)
        self.inter_conv0 = iconv_block(82, 16, use_bn)
        self.predict_flow0 = predict_flow(16, True)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        h, w = c1.shape[2:]
        cat1 = torch.cat([c1, self.deconv1(c2)[:, :, :h, :w],
                          self.upsampled_flow2_to_1(flow2)[:, :, :h, :w]], 1)
        flow1 = self.predict_flow1(self.inter_conv1(cat1))
        h, w = c0.shape[2:]
        cat0 = torch.cat([c0, self.deconv0(cat1)[:, :, :h, :w],
                          self.upsampled_flow1_to_0(flow1)[:, :, :h, :w]], 1)
        return self.predict_flow0(self.inter_conv0(cat0))


def _refine_input(x, flow, div_flow):
    warped = ops.warp(x[:, 1:2], flow, "pixel")
    err = ops.channelnorm(x[:, 0:1] - warped)
    return torch.cat([x, warped, flow / div_flow, err], 1)


class FlowNet2(nn.Module):
    def __init__(self, use_bn=True, div_flow=20.0, md=20, s2=2):
        super().__init__()
        self.div_flow = div_flow
        self.flownetc = FlowNetC(use_bn, md, s2)
        self.flownets_1 = FlowNetS(6, use_bn)
        self.flownets_2 = FlowNetS(6, use_bn)
        self.flownets_d = FlowNetSD(use_bn)
        self.flownetfusion = FlowNetFusion(use_bn)

    def forward(self, x):
        x1, x2 = x[:, 0:1], x[:, 1:2]
        flow_c = ops.up4(self.flownetc(x)[0] * self.div_flow)
        flow_s1 = ops.up4(self.flownets_1(_refine_input(x, flow_c, self.div_flow))[0]
                          * self.div_flow)
        flow_s2 = ops.up4(self.flownets_2(_refine_input(x, flow_s1, self.div_flow))[0]
                          * self.div_flow, "nearest")
        err_s2 = ops.channelnorm(x1 - ops.warp(x2, flow_s2, "pixel"))
        flow_sd = ops.up4(self.flownets_d(x)[0] / self.div_flow, "nearest")
        err_sd = ops.channelnorm(x1 - ops.warp(x2, flow_sd, "pixel"))
        fused = self.flownetfusion(torch.cat(
            [x1, flow_sd, flow_s2, ops.channelnorm(flow_sd), ops.channelnorm(flow_s2),
             err_sd, err_s2], 1))
        return (fused, fused)


def build(config):
    """The cascade of ``config`` (its ``use_bn``, ``div_flow`` and
    ``correlation``)."""
    corr = config["correlation"]
    return FlowNet2(config["use_bn"], config["div_flow"], corr["max_displacement"],
                    corr["stride2"])


def init_rule(module: nn.Module, name: str, key: str = ""):
    """How a leaf of ``module`` is drawn: ("uniform", lo, hi) or
    ("const", value)."""
    if isinstance(module, nn.BatchNorm2d):
        return ("const", {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
                          "running_var": 1.0, "num_batches_tracked": 0}[name])
    if ops.is_conv(module):
        if name == "bias":
            return ("uniform", 0.0, 1.0)
        fan_in, fan_out = ops.init_fans(module)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return ("uniform", -limit, limit)
    raise ValueError(f"no initialiser for {type(module).__name__}.{name}")
