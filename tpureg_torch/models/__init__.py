"""Flow-estimator models and the name registry (counterpart of
``tpureg/models/__init__.py``).

The registry keeps tpureg's dispatch: explicit names first, then substring
matching. Of the 2-D flow estimators only the FlowNet2 cascade is ported so
far; every name that resolves to another model raises
``NotImplementedError``. The 3-D models (``VoxelMorph3D``, ``AffineNet3D``)
are built directly, as tpureg's volumetric CLI builds them.
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
from .voxelmorph3d import VoxelMorph3D

__all__ = ["AffineNet3D", "FlowNet2", "FlowNetC", "FlowNetFusion", "FlowNetS",
           "FlowNetSD", "VoxelMorph3D", "affine_warp3d", "build_predictor"]

# tpureg's explicit registry names; "flownet2-nhwc" is the cascade itself
# here, since the port has only that path
_EXPLICIT_NOT_PORTED = ("flownet2-c", "flownet2-s", "flownet2-sd",
                        "flownet2-cs", "flownet2-css", "flownetc",
                        "flownetc-pinard", "flownetsd", "flownets-full",
                        "pwc-old", "pwc-bilinear", "pwc-reg", "raft-reg")


def build_predictor(name: str, use_bn: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Build a flow predictor from a registry name (tpureg's dispatch)."""
    key = name.lower()
    if key not in _EXPLICIT_NOT_PORTED and "flownet2" in key:
        return FlowNet2(use_bn=use_bn, generator=generator)
    raise NotImplementedError(
        f"model {name!r} is not yet ported to tpureg_torch (only 'flownet2' is)")
