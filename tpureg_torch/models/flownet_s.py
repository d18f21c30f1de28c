"""FlowNetS, the encoder/decoder flow estimator, NVIDIA style: the S1/S2
blocks of the FlowNet2 cascade. Counterpart of ``tpureg/models/flownet_s.py``
(reference flownet2/networks/FlowNetS.py:15-94).

6-channel input, biased convs and heads with xavier_uniform / U(0, 1) init,
unbiased upsample-flow deconvs. NCHW in; flows are [B, 2, h, w],
finest first: (flow2..flow6) in training mode, (flow2,) in eval mode.
The Pinard style (the registry's default FlowNetS) comes with the rest of
the 2-D zoo.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import (
    ConvBlock,
    Deconv,
    TorchConvTranspose,
    bias_uniform01,
    init_xavier_uniform,
    predict_flow,
)

__all__ = ["FlowNetS", "flownet_s_encoder", "refine_level"]


def _style_inits(style: str):
    """(kernel_init, bias_init, biased_heads) per package convention."""
    if style == "nvidia":
        return init_xavier_uniform(), bias_uniform01, True
    if style == "pinard":
        raise NotImplementedError(
            "FlowNetS style 'pinard' is not yet ported (the rest of the 2-D zoo)")
    raise ValueError(f"unknown FlowNetS style: {style}")


def flownet_s_encoder(module: nn.Module, in_ch: int, use_bn: bool, k_init,
                      b_init, generator) -> None:
    """Add the conv1..conv6_1 pyramid shared by FlowNetS variants to ``module``."""
    widths = [("conv1", in_ch, 64, 7, 2), ("conv2", 64, 128, 5, 2),
              ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1),
              ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
              ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
              ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1)]
    for name, cin, cout, k, s in widths:
        module.add_module(name, ConvBlock(cin, cout, k, s, use_bn=use_bn,
                                          kernel_init=k_init, bias_init=b_init,
                                          generator=generator))


def add_decoder_level(module: nn.Module, level: int, cat_ch: int,
                      deconv_in: int, deconv_feat: int, k_init, b_init,
                      biased: bool, upflow_bias: bool, generator) -> None:
    """Add one decoder level's modules, under the reference's names:
    ``upsampled_flow{l+1}_to_{l}``, ``deconv{l}`` and ``predict_flow{l}``."""
    module.add_module(f"upsampled_flow{level + 1}_to_{level}", TorchConvTranspose(
        2, 2, use_bias=upflow_bias, kernel_init=k_init, bias_init=b_init,
        generator=generator))
    module.add_module(f"deconv{level}", Deconv(
        deconv_in, deconv_feat, use_bias=biased, kernel_init=k_init,
        bias_init=b_init, generator=generator))
    module.add_module(f"predict_flow{level}", predict_flow(
        cat_ch, use_bias=biased, kernel_init=k_init, bias_init=b_init,
        generator=generator))


def refine_level(module: nn.Module, level: int, concat_prev, skip, flow_prev):
    """One decoder step: upsample flow and deconv features, concatenate with
    the skip, predict. Returns (concat, flow). Upsampled tensors are cropped
    to the skip's size for inputs that are not a power of two."""
    flow_up = getattr(module, f"upsampled_flow{level + 1}_to_{level}")(flow_prev)
    feat_up = getattr(module, f"deconv{level}")(concat_prev)
    sh, sw = skip.shape[2], skip.shape[3]
    concat = torch.cat([skip, feat_up[:, :, :sh, :sw], flow_up[:, :, :sh, :sw]],
                       dim=1)
    return concat, getattr(module, f"predict_flow{level}")(concat)


class FlowNetS(nn.Module):
    def __init__(self, input_channels: int = 6, use_bn: bool = True,
                 style: str = "nvidia",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k_init, b_init, biased = _style_inits(style)
        flownet_s_encoder(self, input_channels, use_bn, k_init, b_init,
                          generator)
        self.predict_flow6 = predict_flow(1024, use_bias=biased,
                                          kernel_init=k_init, bias_init=b_init,
                                          generator=generator)
        # level: (concat width, deconv input width, deconv width)
        for level, cat_ch, dec_in, dec_out in ((5, 1026, 1024, 512),
                                               (4, 770, 1026, 256),
                                               (3, 386, 770, 128),
                                               (2, 194, 386, 64)):
            # unbiased upsample-flow deconvs (flownet2/networks/FlowNetS.py:42-45)
            add_decoder_level(self, level, cat_ch, dec_in, dec_out, k_init,
                              b_init, biased, False, generator)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        flow6 = self.predict_flow6(c6)
        cat5, flow5 = refine_level(self, 5, c6, c5, flow6)
        cat4, flow4 = refine_level(self, 4, cat5, c4, flow5)
        cat3, flow3 = refine_level(self, 3, cat4, c3, flow4)
        _, flow2 = refine_level(self, 2, cat3, c2, flow3)
        if self.training:
            return (flow2, flow3, flow4, flow5, flow6)
        return (flow2,)
