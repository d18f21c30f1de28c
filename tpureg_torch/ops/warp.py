"""Bilinear backward warping, the 2-D part of ``tpureg/ops/warp.py``.

Two of the reference's grid conventions are on the FlowNet2 path:

- ``"stn"``: the registration head's spatial transformer, which samples at
  ``p = (flow + xy) * (size-1)/size`` with zero padding;
- ``"pixel"``: FlowNet2's Resample2d, which samples at ``p = xy + flow``.

The PWC convention and the 3-D functions come with the slices that use
them. Images are NCHW; flows are ``[B, 2, h, w]`` with channel 0 the x and
channel 1 the y displacement.

``sample2d`` sends a CUDA image to the hand-written kernels and a CPU image
to the plain ``sample2d_gather`` and autograd; there is no other route. On
the card:

- K3 (``csrc/warp2d.cu``) samples when the positions need no gradient;
- K4 (``csrc/warp2d_grad.cu``) samples when they do, and returns beside the
  sample the bases ∂out/∂px and ∂out/∂py, so that the backward to the
  positions is ``Σ_c g · base`` (tpureg's ``warp_pallas.py:451-453``);
- K5 (same file) scatters the cotangent into the image when the image needs
  a gradient.

``sample2d_nearest`` (label maps) is a plain gather on both devices.
"""

from __future__ import annotations

import torch

from .cuda_lib import DTYPE_CODES, check, load, stream_handle

__all__ = ["base_grid", "sample2d", "sample2d_gather", "sample2d_cuda",
           "sample2d_taps_cuda", "sample2d_dimg_cuda", "sample2d_taps_reference",
           "sample2d_dimg_reference", "sample2d_nearest", "warp2d"]


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


def sample2d_taps_reference(img, px, py):
    """K4's plain version: the fp32 sample of ``img`` [B,C,H,W] at
    ``px``/``py`` [B,P] and its derivatives ∂out/∂px, ∂out/∂py [B,C,P], by
    autograd through ``sample2d_gather``, one channel at a time."""
    with torch.enable_grad():
        x = px.detach().requires_grad_()
        y = py.detach().requires_grad_()
        out = sample2d_gather(img.float(), x, y)
        bases = [torch.autograd.grad(out[:, c].sum(), (x, y), retain_graph=True)
                 for c in range(out.shape[1])]
    return (out.detach(), torch.stack([d[0] for d in bases], 1),
            torch.stack([d[1] for d in bases], 1))


def sample2d_dimg_reference(grad, px, py, image_shape, dtype=torch.float32):
    """K5's plain version: the image cotangent by autograd through
    ``sample2d_gather`` (linear in the image), in fp32, cast to ``dtype``."""
    with torch.enable_grad():
        img = torch.zeros(image_shape, dtype=torch.float32, device=grad.device,
                          requires_grad=True)
        out = sample2d_gather(img, px, py)
        (dimg,) = torch.autograd.grad(out, img, grad.reshape(out.shape).float())
    return dimg.to(dtype)


def _check_positions(name, img, px, py):
    if not (img.is_cuda and px.device == img.device and py.device == img.device):
        raise ValueError(f"{name} takes image and positions on one CUDA device")
    if px.dtype != torch.float32 or py.dtype != torch.float32:
        raise TypeError(f"{name} takes fp32 positions")
    if px.dim() != 2 or px.shape != py.shape or px.shape[0] != img.shape[0]:
        raise ValueError(f"{name} takes positions [B,P] for {img.shape[0]} "
                         f"images, got {tuple(px.shape)}, {tuple(py.shape)}")
    if not (img.is_contiguous() and px.is_contiguous() and py.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_image(name, img):
    if img.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes an fp32 or bf16 image, got {img.dtype}")
    if img.dim() != 4:
        raise ValueError(f"{name} takes img [B,C,H,W], got {tuple(img.shape)}")


def sample2d_cuda(img, px, py):
    """Launch K3: ``img`` [B,C,H,W] (fp32 or bf16) at ``px``/``py`` [B,P]
    (fp32), all contiguous on one card. Returns [B, C, P] fp32.

    ``sample2d_cuda.launches`` counts the launches.
    """
    _check_image("sample2d_cuda", img)
    _check_positions("sample2d_cuda", img, px, py)
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


def sample2d_taps_cuda(img, px, py):
    """Launch K4: K3's sample of ``img`` [B,C,H,W] at ``px``/``py`` [B,P],
    and beside it ∂out/∂px and ∂out/∂py. Returns three [B, C, P] fp32
    tensors; the sample equals K3's bit for bit.

    ``sample2d_taps_cuda.launches`` counts the launches.
    """
    _check_image("sample2d_taps_cuda", img)
    _check_positions("sample2d_taps_cuda", img, px, py)
    b, c, h, w = img.shape
    p = px.shape[1]
    out, dpx, dpy = torch.empty((3, b, c, p), dtype=torch.float32,
                                device=img.device).unbind(0)
    lib = load()
    with torch.cuda.device(img.device):
        code = lib.tpureg_warp2d_taps(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            dpx.data_ptr(), dpy.data_ptr(), DTYPE_CODES[img.dtype], b, c, h, w,
            p, stream_handle(img))
    check(code, "warp-with-taps kernel (K4)")
    sample2d_taps_cuda.launches += 1
    return out, dpx, dpy


sample2d_taps_cuda.launches = 0


def sample2d_dimg_cuda(grad, px, py, image_shape, dtype=torch.float32):
    """Launch K5: the cotangent of the image ``image_shape`` [B,C,H,W] from
    the sample's cotangent ``grad`` [B,C,P] (fp32) at ``px``/``py`` [B,P].
    Sums in fp32 with atomics (their order varies from run to run) and
    returns the image's ``dtype``.

    ``sample2d_dimg_cuda.launches`` counts the launches.
    """
    b, c, h, w = image_shape
    dimg = torch.zeros((b, c, h, w), dtype=torch.float32, device=grad.device)
    _check_positions("sample2d_dimg_cuda", dimg, px, py)
    if grad.dtype != torch.float32 or grad.shape != (b, c, px.shape[1]) \
            or not grad.is_contiguous() or grad.device != dimg.device:
        raise ValueError(f"sample2d_dimg_cuda takes a contiguous fp32 cotangent "
                         f"[B,C,P] = {(b, c, px.shape[1])} on the positions' "
                         f"card, got {grad.dtype} {tuple(grad.shape)}")
    lib = load()
    with torch.cuda.device(dimg.device):
        code = lib.tpureg_warp2d_dimg(
            px.data_ptr(), py.data_ptr(), grad.data_ptr(), dimg.data_ptr(),
            b, c, h, w, px.shape[1], stream_handle(dimg))
    check(code, "warp image-gradient kernel (K5)")
    sample2d_dimg_cuda.launches += 1
    return dimg.to(dtype)


sample2d_dimg_cuda.launches = 0


class _Sample2dKernel(torch.autograd.Function):
    """The card's bilinear sample as an autograd node: K3 when the positions
    need no gradient, else K4, whose bases the backward multiplies by the
    cotangent; K5 for the image's cotangent."""

    @staticmethod
    def forward(ctx, img, px, py):
        ctx.image = (tuple(img.shape), img.dtype)
        if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            ctx.save_for_backward(px, py, None, None)
            return sample2d_cuda(img, px, py)
        out, dpx, dpy = sample2d_taps_cuda(img, px, py)
        ctx.save_for_backward(px, py, dpx, dpy)
        return out

    @staticmethod
    def backward(ctx, grad):
        px, py, dpx_base, dpy_base = ctx.saved_tensors
        grad = grad.float().contiguous()
        dimg = dpx = dpy = None
        if ctx.needs_input_grad[0]:
            dimg = sample2d_dimg_cuda(grad, px, py, *ctx.image)
        if ctx.needs_input_grad[1]:
            dpx = (grad * dpx_base).sum(1)
        if ctx.needs_input_grad[2]:
            dpy = (grad * dpy_base).sum(1)
        return dimg, dpx, dpy


def sample2d(img, px, py):
    """Bilinear sample of NCHW ``img`` at float pixel positions (px, py).

    ``px``/``py`` are [B, H_out, W_out]; returns [B, C, H_out, W_out] in
    ``img``'s dtype, with each out-of-image tap contributing zero. Kernels
    K3, K4 and K5 on CUDA, the plain gather and autograd on CPU.
    """
    if img.is_cuda:
        b, c = img.shape[:2]
        out = _Sample2dKernel.apply(img.contiguous(),
                                    px.reshape(b, -1).float().contiguous(),
                                    py.reshape(b, -1).float().contiguous())
        return out.reshape(b, c, *px.shape[1:]).to(img.dtype)
    return sample2d_gather(img, px, py)


def sample2d_nearest(img, px, py):
    """Nearest-neighbour sample of NCHW ``img`` at float pixel positions
    (label maps), the counterpart of tpureg's ``sample2d_nearest``: the
    position rounds half to even (``torch.round`` as ``jnp.rint``), and an
    out-of-image position gives zero. ``px``/``py`` are [B, ...]; returns
    [B, C, ...] in ``img``'s dtype."""
    b, c, h, w = img.shape
    out_shape = (b, c, *px.shape[1:])
    xi = torch.round(px.reshape(b, -1)).long()
    yi = torch.round(py.reshape(b, -1)).long()
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    vals = torch.gather(img.reshape(b, c, h * w), 2,
                        idx[:, None, :].expand(b, c, -1))
    return (vals * inb[:, None, :].to(img.dtype)).reshape(out_shape)


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
