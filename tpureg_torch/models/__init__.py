"""Flow-estimator models and the name registry (counterpart of
``tpureg/models/__init__.py``).

The registry is tpureg's: explicit names first, then substring matching
("flownet2" → the cascade, then "raft" → RAFT, then "pwc" → PWC-DC Net), and
any other name builds FlowNetS in the Pinard style, the registration head's
default ("flownets"). "flownet2-nhwc" names the cascade's plain path in
tpureg, which is the only path here. "pwc-old" and "flownetc-pinard" take a
6-channel RGB pair, so they run as modules only, as in tpureg. The 3-D models
(``VoxelMorph3D``, ``AffineNet3D``) are built directly, as tpureg's volumetric
CLI builds them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .affine3d import AffineNet3D, affine_warp3d
from .flownet2 import (
    FlowNet2,
    FlowNet2C,
    FlowNet2CS,
    FlowNet2CSS,
    FlowNet2S,
    FlowNet2SD,
)
from .flownet_c import FlowNetC, FlowNetCPinard
from .flownet_fusion import FlowNetFusion
from .flownet_s import FlowNetS, FlowNetSFull
from .flownet_sd import FlowNetSD
from .pwcnet import PWCDCNet, PWCDCNetOld
from .raft import RAFT
from .voxelmorph3d import VoxelMorph3D

__all__ = ["AffineNet3D", "FlowNet2", "FlowNet2C", "FlowNet2CS", "FlowNet2CSS",
           "FlowNet2S", "FlowNet2SD", "FlowNetC", "FlowNetCPinard",
           "FlowNetFusion", "FlowNetS", "FlowNetSFull", "FlowNetSD", "PWCDCNet",
           "PWCDCNetOld", "RAFT", "VoxelMorph3D", "affine_warp3d",
           "build_predictor"]

# tpureg's explicit names: fn(use_bn, generator)
_EXPLICIT = {
    "flownet2-c": lambda bn, g: FlowNet2C(use_bn=bn, generator=g),
    "flownet2-s": lambda bn, g: FlowNet2S(use_bn=bn, generator=g),
    "flownet2-sd": lambda bn, g: FlowNet2SD(use_bn=bn, generator=g),
    "flownet2-cs": lambda bn, g: FlowNet2CS(use_bn=bn, generator=g),
    "flownet2-css": lambda bn, g: FlowNet2CSS(use_bn=bn, generator=g),
    "flownetc": lambda bn, g: FlowNetC(use_bn=bn, generator=g),
    "flownet2-nhwc": lambda bn, g: FlowNet2(use_bn=bn, generator=g),
    "flownetc-pinard": lambda bn, g: FlowNetCPinard(use_bn=bn, generator=g),
    "flownetsd": lambda bn, g: FlowNetSD(use_bn=bn, generator=g),
    "flownets-full": lambda bn, g: FlowNetSFull(use_bn=bn, generator=g),
    # the legacy RGB net: a 6-channel pair, eval mode returns a bare flow
    "pwc-old": lambda bn, g: PWCDCNetOld(generator=g),
    "pwc-bilinear": lambda bn, g: PWCDCNet(flow_up_init="bilinear", generator=g),
    "pwc-reg": lambda bn, g: PWCDCNet(flow_up_init="bilinear", feed_warped=True,
                                      generator=g),
    # registration-tuned RAFT: the warped moving features beside the
    # lookup, at 1/4 resolution
    "raft-reg": lambda bn, g: RAFT(feed_warped=True, downsample=4, generator=g),
}


def build_predictor(name: str, use_bn: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Build a flow predictor from a registry name (tpureg's dispatch)."""
    key = name.lower()
    if key in _EXPLICIT:
        return _EXPLICIT[key](use_bn, generator)
    if "flownet2" in key:
        return FlowNet2(use_bn=use_bn, generator=generator)
    if "raft" in key:
        return RAFT(generator=generator)
    if "pwc" in key:
        return PWCDCNet(generator=generator)
    return FlowNetS(use_bn=use_bn, style="pinard", generator=generator)
