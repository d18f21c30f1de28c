"""FlowNetSD, the small-displacement branch of the FlowNet2 cascade.
Counterpart of ``tpureg/models/flownet_sd.py`` (reference
flownet2/networks/FlowNetSD.py:11-106).

A stride-1 conv0 stem, doubled conv1/conv2 stages, and an ``inter_conv``
(conv + BN, no activation) before each flow prediction, so the predict convs
see 512/256/128/64 channels. Upsample-flow deconvs are biased. NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import (
    ConvBlock,
    Deconv,
    IConvBlock,
    TorchConvTranspose,
    bias_uniform01,
    init_xavier_uniform,
    predict_flow,
)

__all__ = ["FlowNetSD"]

# level: (concat width, deconv input width, deconv width, inter_conv width)
_LEVELS = ((5, 1026, 1024, 512, 512), (4, 770, 1026, 256, 256),
           (3, 386, 770, 128, 128), (2, 194, 386, 64, 64))


class FlowNetSD(nn.Module):
    def __init__(self, use_bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k_init, b_init = init_xavier_uniform(), bias_uniform01
        kw = dict(kernel_init=k_init, bias_init=b_init, generator=generator)

        for name, cin, cout, s in (
                ("conv0", 2, 64, 1), ("conv1", 64, 64, 2),
                ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
                ("conv2_1", 128, 128, 1), ("conv3", 128, 256, 2),
                ("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2),
                ("conv4_1", 512, 512, 1), ("conv5", 512, 512, 2),
                ("conv5_1", 512, 512, 1), ("conv6", 512, 1024, 2),
                ("conv6_1", 1024, 1024, 1)):
            self.add_module(name, ConvBlock(cin, cout, 3, s, use_bn=use_bn, **kw))
        self.predict_flow6 = predict_flow(1024, use_bias=True, **kw)
        for level, cat_ch, dec_in, dec_out, inter in _LEVELS:
            # torch's default bias=True here (FlowNetSD.py:46-49)
            self.add_module(f"upsampled_flow{level + 1}_to_{level}",
                            TorchConvTranspose(2, 2, use_bias=True, **kw))
            self.add_module(f"deconv{level}",
                            Deconv(dec_in, dec_out, use_bias=True, **kw))
            self.add_module(f"inter_conv{level}",
                            IConvBlock(cat_ch, inter, use_bn=use_bn, **kw))
            self.add_module(f"predict_flow{level}",
                            predict_flow(inter, use_bias=True, **kw))

    def forward(self, x):
        c1 = self.conv1_1(self.conv1(self.conv0(x)))
        c2 = self.conv2_1(self.conv2(c1))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))

        flows = [self.predict_flow6(c6)]
        concat, skips = c6, {5: c5, 4: c4, 3: c3, 2: c2}
        for level, *_ in _LEVELS:
            skip = skips[level]
            sh, sw = skip.shape[2], skip.shape[3]
            up = getattr(self, f"upsampled_flow{level + 1}_to_{level}")(flows[-1])
            feat = getattr(self, f"deconv{level}")(concat)
            concat = torch.cat([skip, feat[:, :, :sh, :sw], up[:, :, :sh, :sw]],
                               dim=1)
            inter = getattr(self, f"inter_conv{level}")(concat)
            flows.append(getattr(self, f"predict_flow{level}")(inter))
        flow6, flow5, flow4, flow3, flow2 = flows
        if self.training:
            return (flow2, flow3, flow4, flow5, flow6)
        return (flow2,)
