"""FlowNet2, the C → S1 → S2 ∥ SD → Fusion cascade. Counterpart of the NHWC
path of ``tpureg/models/flownet2.py`` (reference flownet2/models.py:31-191,
grayscale-adapted: the input is [B, 2, H, W], fixed and moving channels).

1. FlowNetC on the pair → flow2 (¼ res) × div_flow (20), ×4 bilinear
2. warp the moving image by it (Resample2d: the "pixel" warp, kernel K3 on
   the card), brightness error by channelnorm; the 6-channel stack feeds S1
3. the same refinement again into S2, whose flow is upsampled **nearest**
4. FlowNetSD on the raw pair, its flow2 **divided** by div_flow, nearest ×4
5. the 9-channel fusion stack → FlowNetFusion → the final full-res flow
6. the fused flow is returned twice, so the multi-scale loss sees n = 2
   identical scales, as in the reference.

The TPU path's packed planes (``_call_packed``) are lane-padding work and
are not ported. NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.channelnorm import channelnorm
from ..ops.resize import resize2d
from ..ops.warp import warp2d
from .flownet_c import FlowNetC
from .flownet_fusion import FlowNetFusion
from .flownet_s import FlowNetS
from .flownet_sd import FlowNetSD

__all__ = ["FlowNet2"]


class FlowNet2(nn.Module):
    def __init__(self, use_bn: bool = True, div_flow: float = 20.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.div_flow = div_flow
        self.flownetc = FlowNetC(use_bn=use_bn, generator=generator)
        self.flownets_1 = FlowNetS(6, use_bn=use_bn, style="nvidia",
                                   generator=generator)
        self.flownets_2 = FlowNetS(6, use_bn=use_bn, style="nvidia",
                                   generator=generator)
        self.flownets_d = FlowNetSD(use_bn=use_bn, generator=generator)
        self.flownetfusion = FlowNetFusion(use_bn=use_bn, generator=generator)

    def forward(self, x):
        x1 = x[:, 0:1]
        x2 = x[:, 1:2]

        def up4(flow, method):
            return resize2d(flow, (flow.shape[2] * 4, flow.shape[3] * 4),
                            method, align_corners=False)

        # --- block 1: FlowNetC
        flow_c = up4(self.flownetc(x)[0] * self.div_flow, "bilinear")
        warped1 = warp2d(x2, flow_c, convention="pixel")
        err1 = channelnorm(x1 - warped1)
        concat1 = torch.cat([x, warped1, flow_c / self.div_flow, err1], dim=1)

        # --- block 2: FlowNetS1
        flow_s1 = up4(self.flownets_1(concat1)[0] * self.div_flow, "bilinear")
        warped2 = warp2d(x2, flow_s1, convention="pixel")
        err2 = channelnorm(x1 - warped2)
        concat2 = torch.cat([x, warped2, flow_s1 / self.div_flow, err2], dim=1)

        # --- block 3: FlowNetS2 (nearest ×4, reference quirk :160)
        flow_s2 = up4(self.flownets_2(concat2)[0] * self.div_flow, "nearest")
        norm_s2 = channelnorm(flow_s2)
        err_s2 = channelnorm(x1 - warp2d(x2, flow_s2, convention="pixel"))

        # --- block 4: FlowNetSD (flow divided, not multiplied — :173)
        flow_sd = up4(self.flownets_d(x)[0] / self.div_flow, "nearest")
        norm_sd = channelnorm(flow_sd)
        err_sd = channelnorm(x1 - warp2d(x2, flow_sd, convention="pixel"))

        # --- block 5: fusion (9-channel stack, :185)
        concat3 = torch.cat(
            [x1, flow_sd, flow_s2, norm_sd, norm_s2, err_sd, err_s2], dim=1)
        flow_fused = self.flownetfusion(concat3)
        return (flow_fused, flow_fused)
