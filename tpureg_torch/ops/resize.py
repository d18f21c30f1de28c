"""Image resize with PyTorch's sampling conventions, the counterpart of
``tpureg/ops/resize.py::resize2d``.

The reference resizes with ``F.interpolate`` throughout: bilinear with
align_corners=True for the registration head's frame, bilinear with
align_corners=False for the loss's fixed image and FlowNet2's ×4 flow
upsampling, and the legacy ``"nearest"`` (``src = floor(i * in/out)``, not
``"nearest-exact"``) for FlowNet2's other ×4 upsampling and label maps.
The resize runs in fp32 and returns the input dtype. NCHW.
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["resize2d"]


def resize2d(x, size, method: str = "bilinear", align_corners: bool = False):
    """Resize NCHW ``x`` to ``size=(H_out, W_out)``; the input itself when
    the size is unchanged."""
    h_out, w_out = size
    if tuple(x.shape[-2:]) == (h_out, w_out):
        return x
    xf = x.float()
    if method in ("bilinear", "linear"):
        y = F.interpolate(xf, size=(h_out, w_out), mode="bilinear",
                          align_corners=align_corners)
    elif method == "nearest":
        y = F.interpolate(xf, size=(h_out, w_out), mode="nearest")
    else:
        raise ValueError(f"unknown resize method: {method}")
    return y.to(x.dtype)
