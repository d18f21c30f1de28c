"""Image resize with PyTorch's sampling conventions, the counterpart of
``tpureg/ops/resize.py::resize2d``.

The reference resizes with ``F.interpolate`` throughout: bilinear with
align_corners=True for the registration head's frame, bilinear with
align_corners=False for the loss's fixed image and FlowNet2's ×4 flow
upsampling, and the legacy ``"nearest"`` (``src = floor(i * in/out)``, not
``"nearest-exact"``) for FlowNet2's other ×4 upsampling and label maps.
The resize runs in fp32 and returns the input dtype. NCHW.

``resize_nd`` is the counterpart of ``tpureg/ops/resize.py::resize_nd``
(:102-128) for NCDHW volumes, with the same conventions, through
``F.interpolate`` ("trilinear" or "nearest").

``cubic_resize`` is the counterpart of ``jax.image.resize(method="cubic")``,
which the elastic synthesis uses to upsample its control grid
(``tpureg/ops/elastic.py:72``). It is not ``F.interpolate(mode="bicubic")``:
JAX uses Keys' cubic with a = −0.5 and renormalises each output's weights
over the inputs inside the image, where PyTorch uses a = −0.75 and clamps at
the edges (0.34 px apart on the elastic field at 19²→256², displacements of
scale 4.3 px).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize2d", "resize_nd", "cubic_resize"]


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


def resize_nd(x, size, method: str = "linear", align_corners: bool = False):
    """Resize NCDHW ``x`` to ``size=(D_out, H_out, W_out)`` in fp32 (fp64
    for an fp64 input), returning the input dtype: ``"linear"`` (trilinear,
    either align_corners) or the legacy ``"nearest"``; the input itself when
    the size is unchanged."""
    size = tuple(int(n) for n in size)
    if tuple(x.shape[2:]) == size:
        return x
    xf = x if x.dtype == torch.float64 else x.float()
    if method in ("linear", "trilinear"):
        y = F.interpolate(xf, size=size, mode="trilinear",
                          align_corners=align_corners)
    elif method == "nearest":
        y = F.interpolate(xf, size=size, mode="nearest")
    else:
        raise ValueError(f"unknown resize method: {method}")
    return y.to(x.dtype)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 at distances ``x`` >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, far, near))


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] interpolation matrix of ``jax.image.scale_and_translate``
    for an upsampling cubic resize: half-pixel centres, each row's weights
    over the in-image inputs renormalised to sum to 1."""
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    dist = (sample[:, None]
            - torch.arange(n_in, dtype=torch.float64, device=device)[None, :]).abs()
    w = _keys_cubic(dist)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return (w * inside[:, None]).float()


def cubic_resize(x, size):
    """Upsample NCHW ``x`` to ``size=(H_out, W_out)`` as
    ``jax.image.resize(..., method="cubic")`` does; two small weight
    matrices applied as products, in fp32, returning the input dtype."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2:]
    if h_out < h_in or w_out < w_in:
        raise ValueError(f"cubic_resize upsamples only, got {(h_in, w_in)} -> "
                         f"{(h_out, w_out)}")
    wh = _cubic_weights(h_in, h_out, x.device)
    ww = _cubic_weights(w_in, w_out, x.device)
    return (wh @ x.float() @ ww.T).to(x.dtype)
