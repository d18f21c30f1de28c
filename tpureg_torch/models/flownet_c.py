"""FlowNetC, the siamese encoder with a correlation cost volume. Counterpart
of ``tpureg/models/flownet_c.py``, in two lineages:

- ``FlowNetC``, the flownet2 flavour (reference
  flownet2/networks/FlowNetC.py:13-130, grayscale-adapted): 1-channel stems
  on the fixed and moving channels, xavier_uniform weights and U(0, 1)
  biases, biased heads and upsample-flow deconvs;
- ``FlowNetCPinard`` (reference FlowNetS/FlowNetC.py:9-107, "flownetc-pinard"):
  3-channel stems on a 6-channel RGB pair, kaiming_normal(a=0.1) weights and
  zero biases, the encoder's convs biased only without BatchNorm, unbiased
  heads, deconvs and upsample-flow deconvs. Its eval mode returns the bare
  flow2 in the reference; here a 1-tuple, as tpureg's. The registration head
  feeds 2 channels, so it runs as a module only, as in tpureg.

Both correlate at max displacement 20 and stride 2 (441 channels) through
kernel K1 on the card, apply flax's LeakyReLU(0.1) to the cost volume, add a
1×1 ``conv_redir`` (256→32), then conv3_1 on the 473-channel concat and the
FlowNetS decoder. Training mode returns (flow2..flow6), eval mode (flow2,).
NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import (
    ConvBlock,
    bias_uniform01,
    bias_zeros,
    init_kaiming_leaky,
    init_xavier_uniform,
    leaky_relu,
    predict_flow,
)
from ..ops.correlation import correlation, displacement_count
from .flownet_s import _LEVELS, add_decoder_level, refine_level

__all__ = ["FlowNetC", "FlowNetCPinard"]


class _CorrelationNet(nn.Module):
    """The FlowNetC graph on ``stem_channels``-channel images: the image
    pair is the input's first and second ``stem_channels`` channels."""

    def __init__(self, stem_channels: int, k_init, b_init, biased: bool,
                 use_bn: bool, max_displacement: int, corr_stride: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.stem_channels = stem_channels
        self.max_displacement = max_displacement
        self.corr_stride = corr_stride

        def block(cin, cout, k, s):
            return ConvBlock(cin, cout, k, s, use_bn=use_bn, kernel_init=k_init,
                             bias_init=b_init, generator=generator)

        corr_ch = displacement_count(max_displacement, corr_stride) ** 2
        self.conv1 = block(stem_channels, 64, 7, 2)
        self.conv2 = block(64, 128, 5, 2)
        self.conv3 = block(128, 256, 5, 2)
        self.conv_redir = block(256, 32, 1, 1)
        self.conv3_1 = block(32 + corr_ch, 256, 3, 1)
        self.conv4 = block(256, 512, 3, 2)
        self.conv4_1 = block(512, 512, 3, 1)
        self.conv5 = block(512, 512, 3, 2)
        self.conv5_1 = block(512, 512, 3, 1)
        self.conv6 = block(512, 1024, 3, 2)
        self.conv6_1 = block(1024, 1024, 3, 1)
        self.predict_flow6 = predict_flow(1024, use_bias=biased,
                                          kernel_init=k_init, bias_init=b_init,
                                          generator=generator)
        for level, cat_ch, dec_in, dec_out in _LEVELS:
            add_decoder_level(self, level, cat_ch, dec_in, dec_out, k_init,
                              b_init, biased, biased, generator)

    def forward(self, x):
        s = self.stem_channels
        x1 = x[:, 0:s]
        x2 = x[:, s:2 * s]
        c2a = self.conv2(self.conv1(x1))
        c3a = self.conv3(c2a)
        c3b = self.conv3(self.conv2(self.conv1(x2)))

        corr = correlation(c3a, c3b, self.max_displacement, self.corr_stride)
        # flax's slope 1 at exactly 0, where every displacement tap of a
        # pixel falls outside the image
        corr = leaky_relu(corr, 0.1)
        merged = torch.cat([self.conv_redir(c3a), corr], dim=1)

        c3 = self.conv3_1(merged)
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))

        flow6 = self.predict_flow6(c6)
        cat5, flow5 = refine_level(self, 5, c6, c5, flow6)
        cat4, flow4 = refine_level(self, 4, cat5, c4, flow5)
        cat3, flow3 = refine_level(self, 3, cat4, c3, flow4)
        _, flow2 = refine_level(self, 2, cat3, c2a, flow3)
        if self.training:
            return (flow2, flow3, flow4, flow5, flow6)
        return (flow2,)


class FlowNetC(_CorrelationNet):
    """flownet2 flavour; its upsample-flow deconvs are biased
    (flownet2/networks/FlowNetC.py:53-56), unlike the FlowNetS blocks."""

    def __init__(self, use_bn: bool = True, max_displacement: int = 20,
                 corr_stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(1, init_xavier_uniform(), bias_uniform01, True, use_bn,
                         max_displacement, corr_stride, generator)


class FlowNetCPinard(_CorrelationNet):
    """Pinard lineage, on a 6-channel RGB pair (FlowNetS/FlowNetC.py:55-56)."""

    def __init__(self, use_bn: bool = True, max_displacement: int = 20,
                 corr_stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(3, init_kaiming_leaky(0.1), bias_zeros, False, use_bn,
                         max_displacement, corr_stride, generator)
