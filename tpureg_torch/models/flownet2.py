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

The cascade's sub-variants (``tpureg/models/flownet2.py:184-287``):
``FlowNet2C``, ``FlowNet2S`` (an NVIDIA FlowNetS on the 2-channel pair) and
``FlowNet2SD`` return their subnet's raw five flows in training mode and, in
eval mode, flow2 × div_flow upsampled ×4 (bilinear, align_corners=False);
``FlowNet2CS`` and ``FlowNet2CSS`` run the C → S (→ S) prefix of the cascade
as a child named ``cascade``, so that tpureg's parameter paths
``cascade/flownetc/...`` map onto the keys ``cascade.flownetc....``; they
return the last S block's raw flows in training mode and its upsampled
flow in eval mode.

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
from ..utils.profiling import span
from .flownet_c import FlowNetC
from .flownet_fusion import FlowNetFusion
from .flownet_s import FlowNetS
from .flownet_sd import FlowNetSD

__all__ = ["FlowNet2", "FlowNet2C", "FlowNet2S", "FlowNet2SD", "FlowNet2CS",
           "FlowNet2CSS"]


def up4(flow, method: str = "bilinear"):
    """×4 resize of a [B, 2, h, w] flow (align_corners=False)."""
    return resize2d(flow, (flow.shape[2] * 4, flow.shape[3] * 4), method,
                    align_corners=False)


def refine_input(x, flow, div_flow: float):
    """The 6-channel input of an S block of the cascade: the pair, the
    moving image warped by ``flow`` (the "pixel" warp), the flow / div_flow
    and the brightness error's channel norm."""
    warped = warp2d(x[:, 1:2], flow, convention="pixel")
    err = channelnorm(x[:, 0:1] - warped)
    return torch.cat([x, warped, flow / div_flow, err], dim=1)


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

        # --- block 1: FlowNetC
        with span("tpureg.model.flownetc"):
            flow_c = up4(self.flownetc(x)[0] * self.div_flow)

        # --- block 2: FlowNetS1
        with span("tpureg.model.flownets_1"):
            concat1 = refine_input(x, flow_c, self.div_flow)
            flow_s1 = up4(self.flownets_1(concat1)[0] * self.div_flow)

        # --- block 3: FlowNetS2 (nearest ×4, reference quirk :160)
        with span("tpureg.model.flownets_2"):
            concat2 = refine_input(x, flow_s1, self.div_flow)
            flow_s2 = up4(self.flownets_2(concat2)[0] * self.div_flow, "nearest")
            norm_s2 = channelnorm(flow_s2)
            err_s2 = channelnorm(x1 - warp2d(x2, flow_s2, convention="pixel"))

        # --- block 4: FlowNetSD (flow divided, not multiplied — :173)
        with span("tpureg.model.flownets_d"):
            flow_sd = up4(self.flownets_d(x)[0] / self.div_flow, "nearest")
            norm_sd = channelnorm(flow_sd)
            err_sd = channelnorm(x1 - warp2d(x2, flow_sd, convention="pixel"))

        # --- block 5: fusion (9-channel stack, :185)
        with span("tpureg.model.fusion"):
            concat3 = torch.cat(
                [x1, flow_sd, flow_s2, norm_sd, norm_s2, err_sd, err_s2], dim=1)
            flow_fused = self.flownetfusion(concat3)
        return (flow_fused, flow_fused)


class _Upsampled(nn.Module):
    """One subnet of the cascade alone, under the child name ``name``
    (flownet2/models.py:193-357): its raw flows in training mode, flow2 ×
    div_flow upsampled ×4 in eval mode."""

    def __init__(self, name: str, net: nn.Module, div_flow: float):
        super().__init__()
        self.div_flow = div_flow
        self.net_name = name
        self.add_module(name, net)

    def forward(self, x):
        flows = getattr(self, self.net_name)(x)
        if self.training:
            return flows
        return (up4(flows[0] * self.div_flow),)


class FlowNet2C(_Upsampled):
    """FlowNetC alone (flownet2/models.py:193-259)."""

    def __init__(self, use_bn: bool = True, div_flow: float = 20.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__("flownetc", FlowNetC(use_bn=use_bn, generator=generator),
                         div_flow)


class FlowNet2S(_Upsampled):
    """An NVIDIA FlowNetS block alone, on the 2-channel pair
    (flownet2/models.py:261-305)."""

    def __init__(self, use_bn: bool = True, div_flow: float = 20.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__("flownets", FlowNetS(2, use_bn=use_bn, style="nvidia",
                                              generator=generator), div_flow)


class FlowNet2SD(_Upsampled):
    """FlowNetSD alone (flownet2/models.py:307-357)."""

    def __init__(self, use_bn: bool = True, div_flow: float = 20.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__("flownets_d", FlowNetSD(use_bn=use_bn, generator=generator),
                         div_flow)


class _CascadePrefix(nn.Module):
    """FlowNetC, then ``n_s_blocks`` NVIDIA FlowNetS blocks, each refining
    the previous flow (× div_flow, bilinear ×4) through ``refine_input``.
    Returns (the last flow upsampled, the last block's raw flows)."""

    def __init__(self, use_bn: bool, div_flow: float, n_s_blocks: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.div_flow = div_flow
        self.flownetc = FlowNetC(use_bn=use_bn, generator=generator)
        self.blocks = [f"flownets_{i + 1}" for i in range(n_s_blocks)]
        for name in self.blocks:
            self.add_module(name, FlowNetS(6, use_bn=use_bn, style="nvidia",
                                           generator=generator))

    def forward(self, x):
        flow = up4(self.flownetc(x)[0] * self.div_flow)
        flows = None
        for name in self.blocks:
            flows = getattr(self, name)(refine_input(x, flow, self.div_flow))
            flow = up4(flows[0] * self.div_flow)
        return flow, flows


class FlowNet2CS(nn.Module):
    """C → S (flownet2/models.py:359-422)."""

    n_s_blocks = 1

    def __init__(self, use_bn: bool = True, div_flow: float = 20.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cascade = _CascadePrefix(use_bn, div_flow, self.n_s_blocks,
                                      generator)

    def forward(self, x):
        flow, flows = self.cascade(x)
        return flows if self.training else (flow,)


class FlowNet2CSS(FlowNet2CS):
    """C → S → S (flownet2/models.py:424-511)."""

    n_s_blocks = 2
