"""FlowNetFusion, the shallow net that fuses the cascade into the final
full-resolution flow. Counterpart of ``tpureg/models/flownet_fusion.py``
(reference flownet2/networks/FlowNetFusion.py:11-66).

Input: the 9-channel stack [img0, sd_flow(2), s2_flow(2), sd_norm, s2_norm,
sd_err, s2_err]. A three-level encoder and two inter_conv-compressed decoder
steps give one flow at the input resolution. The TPU path's space-to-depth
packed layout is lane-padding work and is not ported. NCHW.
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

__all__ = ["FlowNetFusion"]


class FlowNetFusion(nn.Module):
    def __init__(self, use_bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(kernel_init=init_xavier_uniform(), bias_init=bias_uniform01,
                  generator=generator)
        self.conv0 = ConvBlock(9, 64, 3, 1, use_bn=use_bn, **kw)
        self.conv1 = ConvBlock(64, 64, 3, 2, use_bn=use_bn, **kw)
        self.conv1_1 = ConvBlock(64, 128, 3, 1, use_bn=use_bn, **kw)
        self.conv2 = ConvBlock(128, 128, 3, 2, use_bn=use_bn, **kw)
        self.conv2_1 = ConvBlock(128, 128, 3, 1, use_bn=use_bn, **kw)
        self.predict_flow2 = predict_flow(128, use_bias=True, **kw)
        self.upsampled_flow2_to_1 = TorchConvTranspose(2, 2, use_bias=True, **kw)
        self.deconv1 = Deconv(128, 32, use_bias=True, **kw)
        self.inter_conv1 = IConvBlock(162, 32, use_bn=use_bn, **kw)
        self.predict_flow1 = predict_flow(32, use_bias=True, **kw)
        self.upsampled_flow1_to_0 = TorchConvTranspose(2, 2, use_bias=True, **kw)
        self.deconv0 = Deconv(162, 16, use_bias=True, **kw)
        self.inter_conv0 = IConvBlock(82, 16, use_bn=use_bn, **kw)
        self.predict_flow0 = predict_flow(16, use_bias=True, **kw)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))

        flow2 = self.predict_flow2(c2)
        flow2_up = self.upsampled_flow2_to_1(flow2)
        d1 = self.deconv1(c2)
        sh, sw = c1.shape[2], c1.shape[3]
        cat1 = torch.cat([c1, d1[:, :, :sh, :sw], flow2_up[:, :, :sh, :sw]],
                         dim=1)  # 162 ch
        flow1 = self.predict_flow1(self.inter_conv1(cat1))

        flow1_up = self.upsampled_flow1_to_0(flow1)
        d0 = self.deconv0(cat1)
        sh, sw = c0.shape[2], c0.shape[3]
        cat0 = torch.cat([c0, d0[:, :, :sh, :sw], flow1_up[:, :, :sh, :sw]],
                         dim=1)  # 82 ch
        return self.predict_flow0(self.inter_conv0(cat0))
