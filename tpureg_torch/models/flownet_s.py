"""FlowNetS, the encoder/decoder flow estimator. Counterpart of
``tpureg/models/flownet_s.py``, in its three variants:

- ``style="pinard"`` (the default, and the registry's model for any name it
  does not know; reference FlowNetS/FlowNetS.py:10-93): 2-channel input,
  kaiming_normal(a=0.1) weights and zero biases, the encoder's convs biased
  only without BatchNorm, unbiased ``predict_flow*``, ``deconv*`` and
  ``upsampled_flow*``, and a ``flow0`` that is ``flow2`` resized bilinearly
  to the input's size, its values not rescaled (FlowNetS.py:82, a quirk kept
  from the reference). Training mode returns (flow0, flow2..flow6), eval
  mode (flow0, flow2);
- ``style="nvidia"`` (the S1/S2 blocks of the FlowNet2 cascade;
  flownet2/networks/FlowNetS.py:15-94): biased convs and heads with
  xavier_uniform / U(0, 1) init, unbiased upsample-flow deconvs, no flow0;
  training mode returns (flow2..flow6), eval mode (flow2,);
- ``FlowNetSFull`` ("flownets-full", the reference's models.py:58-153): the
  Pinard conventions with two more decoder levels, to full resolution; it
  returns (flow0..flow6) in both modes.

NCHW in; flows are [B, 2, h, w], finest first. tpureg's ``packed_input``
(a TPU layout) is not ported.
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
    bias_zeros,
    init_kaiming_leaky,
    init_xavier_uniform,
    predict_flow,
)
from ..ops.resize import resize2d

__all__ = ["FlowNetS", "FlowNetSFull", "flownet_s_encoder", "refine_level"]

# level: (concat width, deconv input width, deconv width) of the decoder
# levels 5..2 that every FlowNetS variant has
_LEVELS = ((5, 1026, 1024, 512), (4, 770, 1026, 256), (3, 386, 770, 128),
           (2, 194, 386, 64))


def _style_inits(style: str):
    """(kernel_init, bias_init, biased_heads) per package convention."""
    if style == "pinard":
        return init_kaiming_leaky(0.1), bias_zeros, False
    if style == "nvidia":
        return init_xavier_uniform(), bias_uniform01, True
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


def _add_decoder(module: nn.Module, levels, k_init, b_init, biased: bool,
                 generator) -> None:
    """``predict_flow6`` and the decoder ``levels``; the upsample-flow
    deconvs are unbiased in both styles (FlowNetS/FlowNetS.py:39-42,
    flownet2/networks/FlowNetS.py:42-45)."""
    module.predict_flow6 = predict_flow(1024, use_bias=biased,
                                        kernel_init=k_init, bias_init=b_init,
                                        generator=generator)
    for level, cat_ch, dec_in, dec_out in levels:
        add_decoder_level(module, level, cat_ch, dec_in, dec_out, k_init,
                          b_init, biased, False, generator)


def _encode_decode(module: nn.Module, x):
    """The encoder and decoder levels 6..2: (c1, (cat2, flow2), (flow3..flow6))."""
    c1 = module.conv1(x)
    c2 = module.conv2(c1)
    c3 = module.conv3_1(module.conv3(c2))
    c4 = module.conv4_1(module.conv4(c3))
    c5 = module.conv5_1(module.conv5(c4))
    c6 = module.conv6_1(module.conv6(c5))
    flow6 = module.predict_flow6(c6)
    cat5, flow5 = refine_level(module, 5, c6, c5, flow6)
    cat4, flow4 = refine_level(module, 4, cat5, c4, flow5)
    cat3, flow3 = refine_level(module, 3, cat4, c3, flow4)
    cat2, flow2 = refine_level(module, 2, cat3, c2, flow3)
    return c1, (cat2, flow2), (flow3, flow4, flow5, flow6)


class FlowNetS(nn.Module):
    def __init__(self, input_channels: int = 2, use_bn: bool = True,
                 style: str = "pinard",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k_init, b_init, biased = _style_inits(style)
        self.style = style
        flownet_s_encoder(self, input_channels, use_bn, k_init, b_init,
                          generator)
        _add_decoder(self, _LEVELS, k_init, b_init, biased, generator)

    def forward(self, x):
        _, (_, flow2), coarse = _encode_decode(self, x)
        if self.style == "pinard":
            flow0 = resize2d(flow2, x.shape[2:], "bilinear", align_corners=False)
            if self.training:
                return (flow0, flow2, *coarse)
            return (flow0, flow2)
        if self.training:
            return (flow2, *coarse)
        return (flow2,)


class FlowNetSFull(nn.Module):
    """FlowNetS decoding to full resolution (tpureg's
    ``flownet_s.py:175-210``): Pinard conventions, and two more levels,
    ``deconv1`` (194 → 32) with ``predict_flow1`` on 98 channels, and
    ``deconv0`` (98 → 16), whose skip is the raw input, with
    ``predict_flow0`` on 20. Returns (flow0..flow6) in both modes."""

    def __init__(self, input_channels: int = 2, use_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k_init, b_init, biased = _style_inits("pinard")
        flownet_s_encoder(self, input_channels, use_bn, k_init, b_init,
                          generator)
        _add_decoder(self, _LEVELS + ((1, 98, 194, 32),
                                      (0, input_channels + 18, 98, 16)),
                     k_init, b_init, biased, generator)

    def forward(self, x):
        c1, (cat2, flow2), coarse = _encode_decode(self, x)
        cat1, flow1 = refine_level(self, 1, cat2, c1, flow2)
        _, flow0 = refine_level(self, 0, cat1, x, flow1)
        return (flow0, flow1, flow2, *coarse)
