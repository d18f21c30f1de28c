"""Plain PyTorch operations of the frozen reference: products, the
correlation, bilinear sampling through ``grid_sample``, resizes and the
channel norm.

Nothing here imports the program. Two context-scoped switches change what
the operations do, for the benchmark's own purposes only:

- ``precision("tf32")`` rounds the operands of every convolution, transposed
  convolution and correlation to TF32 (a 10-bit mantissa, round to nearest,
  ties away, as the tensor cores' conversion does) before the product in
  fp32: the control, the reference one precision below the configuration's
  fp32 with TF32 off. The rounding is straight-through, so the backward's
  products see the rounded operands and an unrounded cotangent.
- ``recording()`` lists every correlation and sample call (shapes, and
  whether its operands need a gradient) and marks the calls whose output
  the backward reaches: the work that ``portbench/work`` bounds.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = contextvars.ContextVar("portbench_precision", default="fp32")
_RECORDER = contextvars.ContextVar("portbench_recorder", default=None)


@contextlib.contextmanager
def precision(name: str):
    """Compute the reference's products in ``name``: "fp32" or "tf32" (the
    operands rounded here); cuDNN's and cuBLAS's own TF32 is off either
    way, whatever the process had set."""
    if name not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    token = _PRECISION.set(name)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        _PRECISION.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to TF32's 10-bit mantissa, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def operand(x: torch.Tensor) -> torch.Tensor:
    """A product's operand in the current precision (straight-through)."""
    if _PRECISION.get() == "fp32" or x.device.type == "meta":
        return x
    return x + (round_tf32(x.detach()) - x).detach()


@dataclass
class Call:
    kind: str                 # "correlation" or "sample"
    shape: tuple              # operand [B, C, H, W]
    positions: int = 0        # sample: positions per image
    md: int = 0               # correlation: max displacement
    s2: int = 1               # correlation: stride of the displacements
    grad_in: bool = False     # correlation: operands need a gradient
    grad_img: bool = False    # sample: the image needs a gradient
    grad_pos: bool = False    # sample: the positions need a gradient
    reached: bool = False     # the backward reached the output


@dataclass
class Recorder:
    calls: List[Call] = field(default_factory=list)

    def add(self, call: Call, out: torch.Tensor) -> None:
        self.calls.append(call)
        if out.requires_grad:
            def mark(grad, call=call):
                call.reached = True
            out.register_hook(mark)


@contextlib.contextmanager
def recording():
    """Yield a ``Recorder`` of the correlation and sample calls made inside."""
    rec = Recorder()
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def _record(call: Call, out: torch.Tensor) -> None:
    rec = _RECORDER.get()
    if rec is not None:
        rec.add(call, out)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(operand(x), operand(self.weight), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(operand(x), operand(self.weight), self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """Training normalises by the batch's mean and biased variance; the
    running statistics, which the compared numbers never read, are left
    as they are. Evaluation normalises by the running statistics."""

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


def leaky_relu_at_zero_one(x, slope: float = 0.1):
    """``where(x >= 0, x, slope·x)``: slope 1 at exactly 0."""
    return torch.where(x >= 0, x, x * slope)


def displacements(md: int, s2: int = 1) -> int:
    return 2 * (md // s2) + 1


def correlation(f1, f2, md: int, s2: int = 1):
    """[B, K·K, H, W] cost volume: for each displacement (dy, dx) in
    {-md, -md+s2, ..., md}², row-major, the channel mean of f1 times f2
    shifted by it, zero outside the image."""
    b, c, h, w = f1.shape
    k = displacements(md, s2)
    a = operand(f1)
    padded = F.pad(operand(f2), (md, md, md, md))
    cols = [(a * padded[:, :, iy * s2:iy * s2 + h, ix * s2:ix * s2 + w]).sum(1)
            for iy in range(k) for ix in range(k)]
    out = torch.stack(cols, 1) / c
    _record(Call("correlation", tuple(f1.shape), md=md, s2=s2,
                 grad_in=f1.requires_grad or f2.requires_grad), out)
    return out


def sample(img, px, py):
    """Bilinear sample of ``img`` [B, C, H, W] at pixel positions ``px``,
    ``py`` [B, h, w]; a tap outside the image adds 0. Through
    ``grid_sample`` with ``align_corners=True``, where -1 and 1 are the
    centres of the first and last pixel."""
    b, c, h, w = img.shape
    gx = px * (2.0 / max(w - 1, 1)) - 1.0
    gy = py * (2.0 / max(h - 1, 1)) - 1.0
    out = F.grid_sample(img, torch.stack([gx, gy], dim=-1), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    _record(Call("sample", tuple(img.shape), positions=px[0].numel(),
                 grad_img=img.requires_grad,
                 grad_pos=px.requires_grad or py.requires_grad), out)
    return out


def sample_nearest(img, px, py):
    """Nearest sample of label maps at pixel positions (half to even); an
    out-of-image position gives 0."""
    b, c, h, w = img.shape
    xi = torch.round(px.reshape(b, -1)).long()
    yi = torch.round(py.reshape(b, -1)).long()
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    vals = torch.gather(img.reshape(b, c, h * w), 2, idx[:, None].expand(b, c, -1))
    return (vals * inside[:, None].to(img.dtype)).reshape(b, c, *px.shape[1:])


def pixel_grid(h: int, w: int, device, dtype=torch.float32):
    """(x [h, w], y [h, w]) integer pixel coordinates."""
    ys = torch.arange(h, device=device, dtype=dtype)
    xs = torch.arange(w, device=device, dtype=dtype)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx, yy


def warp(img, flow, convention: str, mask_threshold: float = 0.9999):
    """Backward warp of ``img`` [B, C, H, W] by ``flow`` [B, 2, h, w]:
    "stn" samples at (flow + xy)·(size-1)/size, "pixel" at xy + flow, "pwc"
    at (flow + xy)·size/(size-1) - 0.5 times a validity mask (a ones image
    sampled at the same positions, 0 below ``mask_threshold``)."""
    _, _, h, w = flow.shape
    xx, yy = pixel_grid(h, w, flow.device)
    px = xx + flow[:, 0]
    py = yy + flow[:, 1]
    if convention == "stn":
        return sample(img, px * ((w - 1) / w), py * ((h - 1) / h))
    if convention == "pixel":
        return sample(img, px, py)
    if convention == "pwc":
        px = px * (w / max(w - 1, 1)) - 0.5
        py = py * (h / max(h - 1, 1)) - 0.5
        ones = torch.ones_like(img[:, :1])
        valid = sample(ones, px.detach(), py.detach())
        mask = torch.where(valid < mask_threshold, 0.0, 1.0).to(img.dtype)
        return sample(img, px, py) * mask
    raise ValueError(f"unknown warp convention {convention!r}")


def resize(x, size, method: str = "bilinear", align_corners: bool = False):
    """``F.interpolate`` to ``size``; the input itself at its own size.
    "nearest" is the legacy floor(i·in/out) rule."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if method == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def channelnorm(x, eps: float = 1e-12):
    """sqrt(Σ_c x² + eps), [B, 1, H, W]."""
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


def up4(flow, method: str = "bilinear"):
    return resize(flow, (flow.shape[2] * 4, flow.shape[3] * 4), method)


def _keys_cubic(d):
    """Keys' cubic kernel, a = -0.5, at distances ``d`` >= 0."""
    near = ((1.5 * d - 2.5) * d) * d + 1.0
    far = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return torch.where(d >= 2.0, torch.zeros_like(d),
                       torch.where(d >= 1.0, far, near))


def cubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of an upsampling cubic resize with half-pixel
    centres, each row renormalised over the inputs inside the image (the
    rule of ``jax.image.resize(method="cubic")``), in fp64, returned fp32."""
    centre = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    d = (centre[:, None] - torch.arange(n_in, dtype=torch.float64,
                                        device=device)[None]).abs()
    wts = _keys_cubic(d)
    total = wts.sum(1, keepdim=True)
    wts = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return (wts * inside[:, None]).float()


def cubic_upsample(x, size):
    """[B, C, h, w] → [B, C, H, W] by ``cubic_matrix`` on each axis."""
    wh = cubic_matrix(x.shape[-2], size[0], x.device)
    ww = cubic_matrix(x.shape[-1], size[1], x.device)
    return wh @ x @ ww.T


def init_fans(module: nn.Module):
    """(fan_in, fan_out) of a convolution's weight, counted over the window
    as flax counts its (kh, kw, in, out) kernels: a transposed convolution's
    fan-in is its input channels times the window."""
    w = module.weight
    window = w[0, 0].numel()
    if isinstance(module, nn.ConvTranspose2d):
        return w.shape[0] * window, w.shape[1] * window
    return w.shape[1] * window, w.shape[0] * window


def is_conv(module: nn.Module) -> bool:
    return isinstance(module, (nn.Conv2d, nn.ConvTranspose2d))


__all__ = ["precision", "round_tf32", "operand", "Call", "Recorder", "recording",
           "Conv2d", "ConvTranspose2d", "BatchNorm2d", "leaky_relu_at_zero_one",
           "displacements", "correlation", "sample", "sample_nearest",
           "pixel_grid", "warp", "resize", "channelnorm", "up4", "cubic_matrix",
           "cubic_upsample", "init_fans", "is_conv"]
