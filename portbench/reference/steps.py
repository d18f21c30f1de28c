"""The reference's registration head, OFE loss, elastic synthesis, Adam and
steps, in plain PyTorch.

- Head: the predictor's flows; the moving image, resized (bilinear,
  align_corners=True) to each distinct flow's size, warped with the "stn"
  convention; the moving segmentation and a 16-px grid image warped by the
  finest flow; the warped segmentation rounded half to even and clipped
  to [0, labels].
- OFE loss: per-scale weights 0.05·(1..n) ascending; γ = 100 times the
  Charbonnier (α 0.25, ε 1e-9) photometric sum over the batch / B, ζ = 100
  times 1 − the batch tensor's Pearson / B (1 where either side is
  constant), λ = 0.5 times the Charbonnier of zero-padded forward
  differences of the flow, each over n; the fixed image resized (bilinear,
  align_corners=False) to each scale; ``num_scales`` keeps the finest k.
- Synthesis: the batch's slices gathered, resized to the image size
  (bilinear, align_corners=False; labels nearest), rotated 90°, the moving
  image an elastic deformation (control points every 16 px plus 3, offsets
  N(0, 1) · magnitude, magnitude ~ U(range) per sample, cubic upsampling,
  zero padding), then a joint per-sample min-max to [0, 1]; channels-last
  [B, S, S, 2]. The draws come from a ``torch.Generator`` on the corpus's
  device seeded with the step's seed: the magnitudes, then the offsets.
- Adam: torch's update, b1 0.9, b2 0.999, ``eps`` as configured.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from . import ops


def grid_image(size: int, device, spacing: int = 16, offset: int = 7):
    img = torch.zeros((size, size), device=device)
    idx = torch.arange(offset, size - 1, spacing, device=device)
    img[idx, :] = 1.0
    img[:, idx] = 1.0
    return img


def register(predictor: nn.Module, imgs, segs=None, labels: int = 3):
    """NCHW [B, 2, H, W] pair (and labels) → (flows, warped images, warped
    labels or None, warped grid)."""
    flows = predictor(imgs)
    moving = imgs[:, 1:2]
    done, warped = {}, []
    for f in flows:
        if id(f) not in done:
            done[id(f)] = ops.warp(ops.resize(moving, f.shape[2:], "bilinear", True),
                                   f, "stn")
        warped.append(done[id(f)])
    out_seg = None
    if segs is not None:
        s = ops.warp(ops.resize(segs[:, 1:2], flows[0].shape[2:], "bilinear", True),
                     flows[0], "stn")
        out_seg = torch.clamp(torch.round(s), 0, labels)
    b, _, h, w = imgs.shape
    grid = grid_image(h, imgs.device)[None, None].expand(b, 1, h, w)
    grid = ops.warp(ops.resize(grid, flows[0].shape[2:], "bilinear", True),
                    flows[0], "stn")
    return tuple(flows), tuple(warped), out_seg, grid


def charbonnier(x, alpha=0.25, eps=1e-9):
    return torch.pow(x * x + eps * eps, alpha)


def _pearson_loss(fixed, warped):
    vx = warped - warped.mean()
    vy = fixed - fixed.mean()
    sx, sy, sxy = (vx * vx).sum(), (vy * vy).sum(), (vx * vy).sum()
    flat = (sx == 0) | (sy == 0)
    one = torch.ones_like(sx)
    corr = torch.where(flat, one, sxy / (torch.sqrt(torch.where(flat, one, sx))
                                         * torch.sqrt(torch.where(flat, one, sy)))
                       / warped.shape[0])
    return 1.0 - corr


def ofe_loss(flows: Sequence, warpeds: Sequence, fixed, num_scales=None,
             lamb_da=0.5, gamma=100.0, zeta=100.0):
    """(photo, corr, smooth, total) of NCHW flows and warped images, finest
    first, against ``fixed`` [B, 1, H, W]."""
    if num_scales is not None:
        flows, warpeds = flows[:num_scales], warpeds[:num_scales]
    n, b = len(flows), fixed.shape[0]
    p = c = s = 0.0
    for i, (f, w) in enumerate(zip(flows, warpeds)):
        wt = 0.05 * (i + 1)
        fx = ops.resize(fixed, w.shape[2:], "bilinear", False)
        p = p + wt * charbonnier(fx - w).sum() / b
        c = c + wt * _pearson_loss(fx, w)
        dv = torch.cat([f[:, :, 1:], torch.zeros_like(f[:, :, :1])], 2)
        dh = torch.cat([f[:, :, :, 1:], torch.zeros_like(f[:, :, :, :1])], 3)
        s = s + wt * ((charbonnier(f - dv) + charbonnier(f - dh)).sum(1) / 2).sum() / b
    p, c, s = gamma / n * p, zeta / n * c, lamb_da / n * s
    return p, c, s, p + c + s


def _prep(x, size, method):
    x = ops.resize(x[:, None], (size, size), method, False)
    return torch.rot90(x, 1, (2, 3))


def _minmax(x):
    lo = torch.amin(x, dim=(1, 2, 3), keepdim=True)
    hi = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    return torch.where(hi > lo, (x - lo) / (hi - lo), x)


def elastic_field(gen, b, size, magnitude, device, spacing=16):
    """[B, 2, S, S] displacement in pixels (x, y)."""
    g = size // spacing + 3
    mags = torch.empty(b, device=device).uniform_(*magnitude, generator=gen)
    offs = torch.randn((b, 2, g, g), device=device, generator=gen)
    return ops.cubic_upsample(offs * mags[:, None, None, None], (size, size))


def synthesize(seed: int, slices, idx, size: int, magnitude, seg_slices=None):
    """Channels-last (images [B, S, S, 2], labels [B, S, S, 2] or None) of
    the slices ``idx`` of [N, X, Y] ``slices`` (module docstring)."""
    gen = torch.Generator(device=slices.device).manual_seed(int(seed))
    img = _prep(slices.index_select(0, idx), size, "bilinear")
    seg = None
    if seg_slices is not None:
        seg = _prep(seg_slices.index_select(0, idx), size, "nearest")
    disp = elastic_field(gen, img.shape[0], size, magnitude, img.device)
    xx, yy = ops.pixel_grid(size, size, img.device)
    px, py = xx + disp[:, 0], yy + disp[:, 1]
    mov = ops.sample(img, px, py)
    pair = _minmax(torch.cat([img, mov], 1)).permute(0, 2, 3, 1).contiguous()
    if seg is None:
        return pair, None
    segs = torch.cat([seg, ops.sample_nearest(seg, px, py)], 1)
    return pair, segs.permute(0, 2, 3, 1).contiguous()


class Adam:
    """torch.optim.Adam's update on a list of tensors."""

    def __init__(self, params: List[torch.Tensor], lr, eps, b1=0.9, b2=0.999):
        self.params, self.lr, self.eps, self.b1, self.b2 = params, lr, eps, b1, b2
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def train_loss(predictor, imgs, num_scales, labels=3):
    """(photo, corr, smooth, total) of channels-last ``imgs`` (predictor in
    train mode)."""
    x = imgs.permute(0, 3, 1, 2)
    flows, warped, _, _ = register(predictor, x, None, labels)
    return ofe_loss(flows, warped, x[:, 0:1], num_scales)


TERMS = ("loss", "photo_loss", "corr_loss", "smooth_loss")


def train_steps(predictor, specs, slices, size, magnitude, lr, eps, num_scales,
                labels=3, rows: Optional[int] = None, flip: bool = False):
    """Run Adam steps of ``predictor`` (parameters in place) on the specs
    (seed, idx); ``rows``: keep only the first rows of each batch (a fault
    the check must catch); ``flip``: the batch's rows in reverse order (the
    same sums in another order: the steps' own spread under rounding).
    Returns (each step's ``TERMS`` as floats, the first gradient of each
    leaf by parameter name)."""
    predictor.train()
    names = [n for n, p in predictor.named_parameters()]
    params = [p for p in predictor.parameters()]
    opt = Adam(params, lr, eps)
    losses, first = [], None
    for seed, idx in specs:
        imgs, _ = synthesize(seed, slices, idx, size, magnitude)
        if rows is not None:
            imgs = imgs[:rows]
        if flip:
            imgs = imgs.flip(0)
        with torch.enable_grad():
            p, c, s, loss = train_loss(predictor, imgs, num_scales, labels)
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        losses.append(dict(zip(TERMS, torch.stack([loss, p, c, s]).detach().tolist())))
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        opt.step(grads)
        del grads, loss, p, c, s
    return losses, first


@torch.no_grad()
def register_requests(predictor, imgs, segs, labels=3) -> Dict[str, torch.Tensor]:
    """Evaluation-mode outputs of channels-last requests: the finest flow
    [B, H, W, 2], warped image [B, H, W, 1] and warped labels."""
    predictor.eval()
    flows, warped, seg, _ = register(predictor, imgs.permute(0, 3, 1, 2),
                                     segs.permute(0, 3, 1, 2), labels)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    return {"flow": nhwc(flows[0]), "image": nhwc(warped[0]), "seg": nhwc(seg)}
