"""Registration head: flow predictor + spatial-transformer warps.
Counterpart of ``tpureg/reg/head.py`` (reference models.py:208-289).

- the predictor comes from the model registry by name;
- ``stn_warp``: the moving frame is resized (bilinear, align_corners=True)
  to each flow's resolution, then warped with the "stn" convention;
- the moving image is warped at every distinct flow scale, the moving
  segmentation and a 16-px grid image at the finest one;
- warped segmentations are rounded (half to even, like ``jnp.rint``) and
  clipped to the label range [0, 3].

``forward`` keeps tpureg's layout at the boundary: ``imgs``/``segs`` are
[B, H, W, 2] (channel 0 fixed, 1 moving) and every output is channels-last
([B, h, w, 2] flows, [B, h, w, 1] images). ``register`` is the same
computation on NCHW tensors, the layout the models run in.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models import build_predictor
from ..ops.resize import resize2d
from ..ops.warp import warp2d
from ..utils.profiling import span

__all__ = ["OpticalFlowReg", "stn_warp", "grid_image", "outputs_to_nhwc"]


def stn_warp(flow, frame):
    """Warp ``frame`` [B, C, H, W] by ``flow`` [B, 2, h, w] at flow scale."""
    h, w = flow.shape[2], flow.shape[3]
    frame = resize2d(frame, (h, w), "bilinear", align_corners=True)
    return warp2d(frame, flow, convention="stn")


def grid_image(size: int = 256, spacing: int = 16, offset: int = 7,
               device=None):
    """[size, size] image with 1.0 grid lines (reference utils.py:15-23)."""
    img = torch.zeros((size, size), dtype=torch.float32, device=device)
    idx = torch.arange(offset, size - 1, spacing, device=device)
    img[idx, :] = 1.0
    img[:, idx] = 1.0
    return img


def _nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1)


def outputs_to_nhwc(outputs):
    """(flows, warped images, warped segs, warped grid) from NCHW to tpureg's
    channels-last layout (views, no copies)."""
    flows, warped, segs, grid = outputs
    views = {}  # one view per tensor: a flow returned twice stays one object

    def view(t):
        if id(t) not in views:
            views[id(t)] = _nhwc(t)
        return views[id(t)]

    return (tuple(view(f) for f in flows), tuple(view(w) for w in warped),
            _nhwc(segs), _nhwc(grid))


class OpticalFlowReg(nn.Module):
    """Registration head around a registry predictor (``models/__init__.py``;
    tpureg's default, ``"flownets"``, is FlowNetS in the Pinard style)."""

    def __init__(self, conv_predictor: str = "flownets", use_bn: bool = True,
                 num_seg_labels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_seg_labels = num_seg_labels
        self.predictor = build_predictor(conv_predictor, use_bn,
                                         generator=generator)

    def register(self, imgs, segs=None):
        """NCHW: imgs/segs [B, 2, H, W] → (flows, warped images, warped segs
        or None, warped grid), all NCHW."""
        with span("tpureg.model"):
            flows = self.predictor(imgs)
        with span("tpureg.warp"):
            moving = imgs[:, 1:2]

            # Warp each DISTINCT flow once: FlowNet2 returns the fusion flow
            # twice. Object identity only, so the math is unchanged.
            warp_cache = {}
            warped_images = []
            for f in flows:
                if id(f) not in warp_cache:
                    warp_cache[id(f)] = stn_warp(f, moving)
                warped_images.append(warp_cache[id(f)])

            warped_segs_int = None
            if segs is not None:
                warped_seg = stn_warp(flows[0], segs[:, 1:2])
                warped_segs_int = torch.clamp(torch.round(warped_seg), 0,
                                              self.num_seg_labels)

            b, _, h, w = imgs.shape
            grid = grid_image(h, device=imgs.device)[None, None].expand(b, 1, h, w)
            warped_grid = stn_warp(flows[0], grid)
        return tuple(flows), tuple(warped_images), warped_segs_int, warped_grid

    def forward(self, imgs, segs=None):
        """Channels-last in and out, as tpureg's ``OpticalFlowReg``."""
        nchw = lambda t: None if t is None else t.permute(0, 3, 1, 2)
        return outputs_to_nhwc(self.register(nchw(imgs), nchw(segs)))
