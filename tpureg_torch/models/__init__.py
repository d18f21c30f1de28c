"""Flow-estimator models and the name registry (counterpart of
``tpureg/models/__init__.py``).

The registry keeps tpureg's dispatch: explicit names first, then substring
matching ("flownet2" before "raft" before "pwc"). Of the 2-D flow
estimators the FlowNet2 cascade, the PWC-Net family and RAFT are ported;
every name that resolves to another model raises ``NotImplementedError``.
The 3-D models (``VoxelMorph3D``, ``AffineNet3D``) are built directly, as
tpureg's volumetric CLI builds them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .affine3d import AffineNet3D, affine_warp3d
from .flownet2 import FlowNet2
from .flownet_c import FlowNetC
from .flownet_fusion import FlowNetFusion
from .flownet_s import FlowNetS
from .flownet_sd import FlowNetSD
from .pwcnet import PWCDCNet, PWCDCNetOld
from .raft import RAFT
from .voxelmorph3d import VoxelMorph3D

__all__ = ["AffineNet3D", "FlowNet2", "FlowNetC", "FlowNetFusion", "FlowNetS",
           "FlowNetSD", "PWCDCNet", "PWCDCNetOld", "RAFT", "VoxelMorph3D",
           "affine_warp3d", "build_predictor"]

# tpureg's explicit registry names that the port has
_EXPLICIT = {
    # the legacy RGB net: a 6-channel pair, eval mode returns a bare flow,
    # so no head or CLI path of tpureg runs it
    "pwc-old": lambda g: PWCDCNetOld(generator=g),
    "pwc-bilinear": lambda g: PWCDCNet(flow_up_init="bilinear", generator=g),
    "pwc-reg": lambda g: PWCDCNet(flow_up_init="bilinear", feed_warped=True,
                                  generator=g),
    # registration-tuned RAFT: the warped moving features beside the
    # lookup, at 1/4 resolution
    "raft-reg": lambda g: RAFT(feed_warped=True, downsample=4, generator=g),
}
# the rest of them; "flownet2-nhwc" is the cascade itself here, since the
# port has only that path
_EXPLICIT_NOT_PORTED = ("flownet2-c", "flownet2-s", "flownet2-sd",
                        "flownet2-cs", "flownet2-css", "flownetc",
                        "flownetc-pinard", "flownetsd", "flownets-full")


def build_predictor(name: str, use_bn: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Build a flow predictor from a registry name (tpureg's dispatch)."""
    key = name.lower()
    if key in _EXPLICIT:
        return _EXPLICIT[key](generator)
    if key not in _EXPLICIT_NOT_PORTED:
        if "flownet2" in key:
            return FlowNet2(use_bn=use_bn, generator=generator)
        if "raft" in key:
            return RAFT(generator=generator)
        if "pwc" in key:
            return PWCDCNet(generator=generator)
    raise NotImplementedError(
        f"model {name!r} is not yet ported to tpureg_torch (only 'flownet2', "
        f"the 'pwc' names and the 'raft' names are)")
