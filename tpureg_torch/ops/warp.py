"""Bilinear backward warping, the 2-D part of ``tpureg/ops/warp.py``.

Two of the reference's grid conventions are on the FlowNet2 path:

- ``"stn"``: the registration head's spatial transformer, which samples at
  ``p = (flow + xy) * (size-1)/size`` with zero padding;
- ``"pixel"``: FlowNet2's Resample2d, which samples at ``p = xy + flow``.

The PWC convention, nearest sampling and the 3-D functions come with the
slices that use them. Images are NCHW; flows are ``[B, 2, h, w]`` with
channel 0 the x and channel 1 the y displacement.

``sample2d`` sends a CUDA image to kernel K3 (``csrc/warp2d.cu``) and a CPU
image to the plain ``sample2d_gather``; there is no other route.
"""

from __future__ import annotations

import torch

from .cuda_lib import DTYPE_CODES, check, load, stream_handle

__all__ = ["base_grid", "sample2d", "sample2d_gather", "sample2d_cuda",
           "warp2d"]


def base_grid(h: int, w: int, device=None, dtype=torch.float32):
    """(h, w, 2) grid of integer pixel coordinates, last axis (x, y)."""
    xs = torch.arange(w, dtype=dtype, device=device)
    ys = torch.arange(h, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def sample2d_gather(img, px, py):
    """Plain 4-tap gather: bilinear sample of ``img`` [B,C,H,W] at float
    pixel positions ``px``/``py`` [B, ...]; each tap outside the image
    contributes zero. Returns [B, C, ...] in ``img``'s dtype."""
    b, c, h, w = img.shape
    out_shape = (b, c, *px.shape[1:])
    compute = torch.float64 if img.dtype == torch.float64 else torch.float32
    px = px.reshape(b, -1).to(compute)
    py = py.reshape(b, -1).to(compute)

    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(b, c, h * w).to(compute)

    def tap(xi, yi, weight):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 2, idx[:, None, :].expand(b, c, -1))
        return vals * (weight * inb.to(compute))[:, None, :]

    out = (
        tap(x0i, y0i, (1 - fx) * (1 - fy))
        + tap(x0i + 1, y0i, fx * (1 - fy))
        + tap(x0i, y0i + 1, (1 - fx) * fy)
        + tap(x0i + 1, y0i + 1, fx * fy)
    )
    return out.reshape(out_shape).to(img.dtype)


def sample2d_cuda(img, px, py):
    """Launch K3: ``img`` [B,C,H,W] (fp32 or bf16) at ``px``/``py`` [B,P]
    (fp32), all contiguous on one card. Returns [B, C, P] fp32.

    ``sample2d_cuda.launches`` counts the launches.
    """
    if not (img.is_cuda and px.device == img.device and py.device == img.device):
        raise ValueError("sample2d_cuda takes image and positions on one CUDA device")
    if img.dtype not in DTYPE_CODES:
        raise TypeError(f"sample2d_cuda takes an fp32 or bf16 image, got {img.dtype}")
    if px.dtype != torch.float32 or py.dtype != torch.float32:
        raise TypeError("sample2d_cuda takes fp32 positions")
    if img.dim() != 4 or px.dim() != 2 or px.shape != py.shape \
            or px.shape[0] != img.shape[0]:
        raise ValueError(f"sample2d_cuda takes img [B,C,H,W] and positions "
                         f"[B,P], got {tuple(img.shape)}, {tuple(px.shape)}, "
                         f"{tuple(py.shape)}")
    if not (img.is_contiguous() and px.is_contiguous() and py.is_contiguous()):
        raise ValueError("sample2d_cuda takes contiguous tensors")
    b, c, h, w = img.shape
    p = px.shape[1]
    out = torch.empty((b, c, p), dtype=torch.float32, device=img.device)
    lib = load()
    with torch.cuda.device(img.device):
        code = lib.tpureg_warp2d_fwd(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            DTYPE_CODES[img.dtype], b, c, h, w, p, stream_handle(img))
    check(code, "warp kernel (K3)")
    sample2d_cuda.launches += 1
    return out


sample2d_cuda.launches = 0


class _Sample2dKernel(torch.autograd.Function):
    """K3 as an autograd node; its backward kernels (K4, K5) come with training."""

    @staticmethod
    def forward(ctx, img, px, py):
        return sample2d_cuda(img, px, py)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the CUDA warp is forward-only: its backward kernels (K4, K5) "
            "come with the training slice")


def sample2d(img, px, py):
    """Bilinear sample of NCHW ``img`` at float pixel positions (px, py).

    ``px``/``py`` are [B, H_out, W_out]; returns [B, C, H_out, W_out] in
    ``img``'s dtype, with each out-of-image tap contributing zero. Kernel K3
    on CUDA, the plain gather on CPU.
    """
    if img.is_cuda:
        b, c = img.shape[:2]
        out = _Sample2dKernel.apply(img.contiguous(),
                                    px.reshape(b, -1).float().contiguous(),
                                    py.reshape(b, -1).float().contiguous())
        return out.reshape(b, c, *px.shape[1:]).to(img.dtype)
    return sample2d_gather(img, px, py)


def warp2d(img, flow, convention: str = "stn"):
    """Backward-warp NCHW ``img`` by ``flow`` [B, 2, h, w] (x, y displacement)."""
    _, _, h, w = flow.shape
    grid = base_grid(h, w, flow.device)
    px = grid[..., 0] + flow[:, 0].float()
    py = grid[..., 1] + flow[:, 1].float()
    if convention == "stn":
        # grid*2/size - 1, then grid_sample(align_corners=True):
        # p_src = (flow + xy) * (size-1)/size
        px = px * ((w - 1) / w)
        py = py * ((h - 1) / h)
    elif convention == "pwc":
        raise NotImplementedError("the 'pwc' warp convention comes with the PWC slice")
    elif convention != "pixel":
        raise ValueError(f"unknown warp convention: {convention}")
    return sample2d(img, px, py)
