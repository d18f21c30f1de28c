"""Bilinear and trilinear backward warping, the counterpart of
``tpureg/ops/warp.py``.

The reference's three 2-D grid conventions:

- ``"stn"``: the registration head's spatial transformer, which samples at
  ``p = (flow + xy) * (size-1)/size`` with zero padding;
- ``"pixel"``: FlowNet2's Resample2d, which samples at ``p = xy + flow``;
- ``"pwc"``: PWC-Net's feature warp, which samples at
  ``p = (flow + xy) * size/(size-1) - 0.5`` and multiplies the sample by a
  validity mask (a ones image sampled at the same positions, thresholded).

Images are NCHW; flows are ``[B, 2, h, w]`` with channel 0 the x and
channel 1 the y displacement. Volumes are NCDHW; 3-D flows are
``[B, 3, D, H, W]`` with channels (u_x, u_y, u_z), tpureg's last axis.

``sample2d`` and ``sample3d`` call the ops ``torch.ops.tpureg.sample2d`` and
``sample3d`` (``ops/library.py``), which send a CUDA tensor to the
hand-written kernels and a CPU tensor to the plain gathers and autograd;
there is no other route. On the card, in 2-D:

- K3 (``csrc/warp2d.cu``) samples in every forward;
- K4 (``csrc/warp2d_grad.cu``) is the positions' cotangent
  ``Σ_c g · ∂out/∂p`` (tpureg's ``warp_pallas.py:451-453`` product of its
  bases with the cotangent), run in the backward when it reaches the node:
  it gathers the taps again, so no per-channel basis is written or saved;
- K5 (same file) scatters the cotangent into the image when the image needs
  a gradient.

In 3-D (``csrc/warp3d.cu``) the parts are the same: K6a samples in every
forward, K6b is the positions' cotangent and K6c scatters the cotangent
into the volume. tpureg sends only
single-channel volumes to its Pallas kernel (warp.py:191) and the rest to an
XLA gather; here a CUDA volume of any C goes to the kernels, so that the
scaling-and-squaring compositions, which warp a 3-channel field and
differentiate both the field and the positions, run on them too.

``sample2d_nearest`` (label maps) is a plain gather on both devices.
"""

from __future__ import annotations

import torch

from .cuda_lib import DTYPE_CODES, check, load, stream_handle

__all__ = ["base_grid", "sample2d", "sample2d_gather", "sample2d_plain", "sample2d_cuda",
           "sample2d_dpos_cuda", "sample2d_dimg_cuda", "sample2d_taps_reference",
           "sample2d_dpos_reference", "sample2d_dimg_reference", "sample2d_nearest",
           "warp2d", "sample3d", "sample3d_gather", "sample3d_plain", "sample3d_cuda",
           "sample3d_dpos_cuda",
           "sample3d_dvol_cuda", "sample3d_taps_reference",
           "sample3d_dpos_reference", "sample3d_dvol_reference", "voxel_grid",
           "warp3d"]


def base_grid(h: int, w: int, device=None, dtype=torch.float32):
    """(h, w, 2) grid of integer pixel coordinates, last axis (x, y)."""
    xs = torch.arange(w, dtype=dtype, device=device)
    ys = torch.arange(h, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def _compute_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def sample2d_gather(img, px, py):
    """Plain 4-tap gather: bilinear sample of ``img`` [B,C,H,W] at float
    pixel positions ``px``/``py`` [B, ...]; each tap outside the image
    contributes zero. Returns [B, C, ...] in ``img``'s dtype."""
    return sample2d_plain(img, px, py).to(img.dtype)


def sample2d_plain(img, px, py):
    """``sample2d_gather`` before its last cast: the sample in fp32 (fp64
    for an fp64 image), as K3 returns it; the op's CPU version."""
    b, c, h, w = img.shape
    out_shape = (b, c, *px.shape[1:])
    compute = _compute_dtype(img)
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
    return out.reshape(out_shape)


def sample2d_taps_reference(img, px, py):
    """The fp32 sample of ``img`` [B,C,H,W] at ``px``/``py`` [B,P] and its
    derivatives ∂out/∂px, ∂out/∂py [B,C,P] (tpureg's ``_fwd_taps_kernel``),
    by autograd through ``sample2d_gather``, one channel at a time."""
    with torch.enable_grad():
        x = px.detach().requires_grad_()
        y = py.detach().requires_grad_()
        out = sample2d_gather(img.float(), x, y)
        bases = [torch.autograd.grad(out[:, c].sum(), (x, y), retain_graph=True)
                 for c in range(out.shape[1])]
    return (out.detach(), torch.stack([d[0] for d in bases], 1),
            torch.stack([d[1] for d in bases], 1))


def sample2d_dpos_reference(grad, img, px, py):
    """K4's plain version: the positions' cotangent ``Σ_c g_c · ∂out_c/∂p``
    for p = px, py [B,P], from the sample's cotangent ``grad`` [B,C,P] and
    the bases of ``sample2d_taps_reference``; fp32."""
    _, *bases = sample2d_taps_reference(img, px, py)
    return tuple((grad * base).sum(1) for base in bases)


def sample2d_dimg_reference(grad, px, py, image_shape, dtype=torch.float32):
    """K5's plain version: the image cotangent by autograd through
    ``sample2d_gather`` (linear in the image), in fp32, cast to ``dtype``."""
    with torch.enable_grad():
        img = torch.zeros(image_shape, dtype=torch.float32, device=grad.device,
                          requires_grad=True)
        out = sample2d_gather(img, px, py)
        (dimg,) = torch.autograd.grad(out, img, grad.reshape(out.shape).float())
    return dimg.to(dtype)


def _check_positions(name, src, *pos):
    """``src`` (image or volume) and its positions [B,P] on one card, the
    positions fp32, all contiguous."""
    if not (src.is_cuda and all(t.device == src.device for t in pos)):
        raise ValueError(f"{name} takes its input and positions on one CUDA device")
    if any(t.dtype != torch.float32 for t in pos):
        raise TypeError(f"{name} takes fp32 positions")
    if pos[0].dim() != 2 or any(t.shape != pos[0].shape for t in pos) \
            or pos[0].shape[0] != src.shape[0]:
        raise ValueError(f"{name} takes positions [B,P] for {src.shape[0]} "
                         f"inputs, got {[tuple(t.shape) for t in pos]}")
    if not all(t.is_contiguous() for t in (src, *pos)):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_source(name, src, layout):
    """An fp32 or bf16 image or volume with the dimensions of ``layout``."""
    if src.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes an fp32 or bf16 input, got {src.dtype}")
    if src.dim() != len(layout):
        raise ValueError(f"{name} takes [{','.join(layout)}], got {tuple(src.shape)}")


def _check_cotangent(name, grad, shape, device):
    if grad.dtype != torch.float32 or tuple(grad.shape) != shape \
            or not grad.is_contiguous() or grad.device != device:
        raise ValueError(f"{name} takes a contiguous fp32 cotangent [B,C,P] = "
                         f"{shape} on the positions' card, got {grad.dtype} "
                         f"{tuple(grad.shape)}")


def sample2d_cuda(img, px, py):
    """Launch K3: ``img`` [B,C,H,W] (fp32 or bf16) at ``px``/``py`` [B,P]
    (fp32), all contiguous on one card. Returns [B, C, P] fp32, equal to
    ``sample2d_gather``'s fp32 result bit for bit.

    ``sample2d_cuda.launches`` counts the launches.
    """
    _check_source("sample2d_cuda", img, "BCHW")
    _check_positions("sample2d_cuda", img, px, py)
    b, c, h, w = img.shape
    p = px.shape[1]
    if h * w >= 2**31 or p >= 2**31 - 2:
        raise ValueError(f"sample2d_cuda takes planes of fewer than 2^31 pixels and "
                         f"positions, got {h} x {w} and {p}")
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


def sample2d_dpos_cuda(grad, img, px, py):
    """Launch K4: the positions' cotangent ``Σ_c g_c · ∂out_c/∂p`` from the
    sample's cotangent ``grad`` [B,C,P] (fp32) of ``img`` [B,C,H,W] (fp32 or
    bf16) at ``px``/``py`` [B,P] (fp32), all contiguous on one card. Returns
    two [B, P] fp32 tensors. The channels' products are added in a fixed
    order (no atomics), so a launch repeats its result bit for bit.

    ``sample2d_dpos_cuda.launches`` counts the launches.
    """
    _check_source("sample2d_dpos_cuda", img, "BCHW")
    _check_positions("sample2d_dpos_cuda", img, px, py)
    b, c, h, w = img.shape
    p = px.shape[1]
    _check_cotangent("sample2d_dpos_cuda", grad, (b, c, p), img.device)
    if h * w >= 2**31 or p >= 2**31 - 32:
        raise ValueError(f"sample2d_dpos_cuda takes planes of fewer than 2^31 pixels "
                         f"and positions, got {h} x {w} and {p}")
    dpx, dpy = (torch.empty((b, p), dtype=torch.float32, device=img.device)
                for _ in range(2))
    lib = load()
    with torch.cuda.device(img.device):
        code = lib.tpureg_warp2d_dpos(
            img.data_ptr(), px.data_ptr(), py.data_ptr(), grad.data_ptr(),
            dpx.data_ptr(), dpy.data_ptr(), DTYPE_CODES[img.dtype], b, c, h, w, p,
            stream_handle(img))
    check(code, "warp position-cotangent kernel (K4)")
    sample2d_dpos_cuda.launches += 1
    return dpx, dpy


sample2d_dpos_cuda.launches = 0


def sample2d_dimg_cuda(grad, px, py, image_shape, dtype=torch.float32):
    """Launch K5: the cotangent of the image ``image_shape`` [B,C,H,W] from
    the sample's cotangent ``grad`` [B,C,P] (fp32) at ``px``/``py`` [B,P].
    Sums in fp32: neighbouring positions' products are merged in registers
    and added with atomics (their order varies from run to run) into the
    zeroed buffer, which is cast to the image's ``dtype``.

    ``sample2d_dimg_cuda.launches`` counts the launches.
    """
    b, c, h, w = image_shape
    dimg = torch.zeros((b, c, h, w), dtype=torch.float32, device=grad.device)
    _check_positions("sample2d_dimg_cuda", dimg, px, py)
    _check_cotangent("sample2d_dimg_cuda", grad, (b, c, px.shape[1]), dimg.device)
    lib = load()
    with torch.cuda.device(dimg.device):
        code = lib.tpureg_warp2d_dimg(
            px.data_ptr(), py.data_ptr(), grad.data_ptr(), dimg.data_ptr(),
            b, c, h, w, px.shape[1], stream_handle(dimg))
    check(code, "warp image-gradient kernel (K5)")
    sample2d_dimg_cuda.launches += 1
    return dimg.to(dtype)


sample2d_dimg_cuda.launches = 0


def sample2d(img, px, py):
    """Bilinear sample of NCHW ``img`` at float pixel positions (px, py).

    ``px``/``py`` are [B, H_out, W_out]; returns [B, C, H_out, W_out] in
    ``img``'s dtype, with each out-of-image tap contributing zero. The op
    ``tpureg::sample2d``: kernels K3 (forward), K4 and K5 (backward) on
    CUDA, the plain gather and autograd on the CPU; the positions go in as
    [B, P] in fp32 (fp64 for an fp64 image).
    """
    b, c = img.shape[:2]
    compute = _compute_dtype(img)
    out = torch.ops.tpureg.sample2d(img, *(t.reshape(b, -1).to(compute)
                                           for t in (px, py)))
    return out.reshape(b, c, *px.shape[1:]).to(img.dtype)


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


def warp2d(img, flow, convention: str = "stn", return_mask: bool = False,
           mask_threshold: float = 0.9999):
    """Backward-warp NCHW ``img`` by ``flow`` [B, 2, h, w] (x, y displacement).

    For ``"pwc"`` the output is multiplied by the thresholded validity mask,
    and ``return_mask=True`` returns ``(masked output, mask)``, the mask
    [B, 1, h, w]; ``mask_threshold`` is 0.9999 for ``PWCDCNet`` and 0.999 for
    ``PWCDCNetOld``.
    """
    _, _, h, w = flow.shape
    grid = base_grid(h, w, flow.device)
    px = grid[..., 0] + flow[:, 0].float()
    py = grid[..., 1] + flow[:, 1].float()
    mask = None
    if convention == "stn":
        # grid*2/size - 1, then grid_sample(align_corners=True):
        # p_src = (flow + xy) * (size-1)/size
        px = px * ((w - 1) / w)
        py = py * ((h - 1) / h)
        out = sample2d(img, px, py)
    elif convention == "pwc":
        # 2*(flow + xy)/(size-1) - 1, then grid_sample(align_corners=False):
        # p_src = (flow + xy) * size/(size-1) - 0.5
        px = px * (w / max(w - 1, 1)) - 0.5
        py = py * (h / max(h - 1, 1)) - 0.5
        out = sample2d(img, px, py)
        mask = _pwc_mask(img, px.detach(), py.detach(), mask_threshold)
        out = out * mask
    elif convention == "pixel":
        out = sample2d(img, px, py)
    else:
        raise ValueError(f"unknown warp convention: {convention}")
    return (out, mask) if return_mask else out


def _pwc_mask(img, px, py, threshold):
    """The "pwc" validity mask [B, 1, ...] (the positions' shape) in
    ``img``'s dtype: a ones image sampled at the positions, 0 where the sample falls below ``threshold``
    and 1 elsewhere. tpureg samples a C-channel ones image whose channels
    are all equal; one channel broadcasts to the same mask. The sample is
    rounded to ``img``'s dtype and compared there, as tpureg compares (in
    bf16 the threshold 0.9999 rounds to 1.0). The positions come detached,
    so on the card the sample is K3's, and the mask has no gradient, as
    tpureg's ``where`` gives none."""
    b, _, h, w = img.shape
    ones = torch.ones((b, 1, h, w), dtype=img.dtype, device=img.device)
    valid = sample2d(ones, px, py)
    cut = torch.tensor(threshold, dtype=img.dtype, device=img.device)
    return torch.where(valid < cut, 0.0, 1.0).to(img.dtype)


# ---------------------------------------------------------------------------
# 3-D: trilinear sample of NCDHW volumes


def sample3d_gather(vol, px, py, pz):
    """Plain 8-tap gather: trilinear sample of ``vol`` [B,C,D,H,W] at float
    voxel positions ``px``/``py``/``pz`` [B, ...]; each corner outside the
    volume contributes zero. tpureg's order of operations (warp.py:208-245):
    ``wgt = cx·cy·cz``, then ``value·(wgt·inb)``, summed over dz, dy, dx.
    Computes in fp32 (fp64 for an fp64 volume); returns [B, C, ...] in
    ``vol``'s dtype."""
    return sample3d_plain(vol, px, py, pz).to(vol.dtype)


def sample3d_plain(vol, px, py, pz):
    """``sample3d_gather`` before its last cast: the sample in fp32 (fp64
    for an fp64 volume), as K6a returns it; the op's CPU version."""
    b, c, d, h, w = vol.shape
    out_shape = (b, c, *px.shape[1:])
    compute = _compute_dtype(vol)
    px = px.reshape(b, -1).to(compute)
    py = py.reshape(b, -1).to(compute)
    pz = pz.reshape(b, -1).to(compute)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    z0 = torch.floor(pz)
    fx = px - x0
    fy = py - y0
    fz = pz - z0
    x0i = x0.long()
    y0i = y0.long()
    z0i = z0.long()
    flat = vol.reshape(b, c, d * h * w).to(compute)

    def tap(xi, yi, zi, weight):
        inb = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
               & (zi >= 0) & (zi <= d - 1))
        idx = (zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 2, idx[:, None, :].expand(b, c, -1))
        return vals * (weight * inb.to(compute))[:, None, :]

    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                       * (fz if dz else 1 - fz))
                out = out + tap(x0i + dx, y0i + dy, z0i + dz, wgt)
    return out.reshape(out_shape)


def sample3d_taps_reference(vol, px, py, pz):
    """K6b's plain version: the sample of ``vol`` [B,C,D,H,W] at
    ``px``/``py``/``pz`` [B,P] and its derivatives ∂out/∂px, ∂out/∂py,
    ∂out/∂pz [B,C,P], by autograd through ``sample3d_gather``, one channel at
    a time; fp32 (fp64 for an fp64 volume)."""
    compute = _compute_dtype(vol)
    with torch.enable_grad():
        pos = [t.detach().to(compute).requires_grad_() for t in (px, py, pz)]
        out = sample3d_gather(vol.to(compute), *pos)
        bases = [torch.autograd.grad(out[:, c].sum(), pos, retain_graph=True)
                 for c in range(out.shape[1])]
    return (out.detach(), *(torch.stack([d[i] for d in bases], 1)
                            for i in range(3)))


def sample3d_dpos_reference(grad, vol, px, py, pz):
    """K6b's plain version: the positions' cotangent ``Σ_c g_c · ∂out_c/∂p``
    for p = px, py, pz [B,P], from the sample's cotangent ``grad`` [B,C,P]
    and the bases of ``sample3d_taps_reference``; fp32 (fp64 for an fp64
    volume)."""
    _, *bases = sample3d_taps_reference(vol, px, py, pz)
    return tuple((grad * base).sum(1) for base in bases)


def sample3d_dvol_reference(grad, px, py, pz, volume_shape,
                            dtype=torch.float32):
    """K6c's plain version: the volume cotangent by autograd through
    ``sample3d_gather`` (linear in the volume), in fp32, cast to ``dtype``."""
    with torch.enable_grad():
        vol = torch.zeros(volume_shape, dtype=torch.float32, device=grad.device,
                          requires_grad=True)
        out = sample3d_gather(vol, px, py, pz)
        (dvol,) = torch.autograd.grad(out, vol, grad.reshape(out.shape).float())
    return dvol.to(dtype)


def sample3d_cuda(vol, px, py, pz):
    """Launch K6a: ``vol`` [B,C,D,H,W] (fp32 or bf16) at ``px``/``py``/``pz``
    [B,P] (fp32), all contiguous on one card. Returns [B, C, P] fp32, equal
    to ``sample3d_gather``'s fp32 result bit for bit.

    ``sample3d_cuda.launches`` counts the launches.
    """
    _check_source("sample3d_cuda", vol, "BCDHW")
    _check_positions("sample3d_cuda", vol, px, py, pz)
    b, c, d, h, w = vol.shape
    p = px.shape[1]
    out = torch.empty((b, c, p), dtype=torch.float32, device=vol.device)
    lib = load()
    with torch.cuda.device(vol.device):
        code = lib.tpureg_warp3d_fwd(
            vol.data_ptr(), px.data_ptr(), py.data_ptr(), pz.data_ptr(),
            out.data_ptr(), DTYPE_CODES[vol.dtype], b, c, d, h, w, p,
            stream_handle(vol))
    check(code, "3-D warp kernel (K6a)")
    sample3d_cuda.launches += 1
    return out


sample3d_cuda.launches = 0


def sample3d_dpos_cuda(grad, vol, px, py, pz):
    """Launch K6b: the positions' cotangent ``Σ_c g_c · ∂out_c/∂p`` from the
    sample's cotangent ``grad`` [B,C,P] (fp32) of ``vol`` [B,C,D,H,W] (fp32
    or bf16) at ``px``/``py``/``pz`` [B,P] (fp32), all contiguous on one
    card. Returns three [B, P] fp32 tensors; for C = 1 each is the product
    of ``grad`` and the basis, bit for bit.

    ``sample3d_dpos_cuda.launches`` counts the launches.
    """
    _check_source("sample3d_dpos_cuda", vol, "BCDHW")
    _check_positions("sample3d_dpos_cuda", vol, px, py, pz)
    b, c, d, h, w = vol.shape
    p = px.shape[1]
    _check_cotangent("sample3d_dpos_cuda", grad, (b, c, p), vol.device)
    dpx, dpy, dpz = (torch.empty((b, p), dtype=torch.float32, device=vol.device)
                     for _ in range(3))
    lib = load()
    with torch.cuda.device(vol.device):
        code = lib.tpureg_warp3d_dpos(
            vol.data_ptr(), px.data_ptr(), py.data_ptr(), pz.data_ptr(),
            grad.data_ptr(), dpx.data_ptr(), dpy.data_ptr(), dpz.data_ptr(),
            DTYPE_CODES[vol.dtype], b, c, d, h, w, p, stream_handle(vol))
    check(code, "3-D warp position-cotangent kernel (K6b)")
    sample3d_dpos_cuda.launches += 1
    return dpx, dpy, dpz


sample3d_dpos_cuda.launches = 0


def sample3d_dvol_cuda(grad, px, py, pz, volume_shape, dtype=torch.float32):
    """Launch K6c: the cotangent of the volume ``volume_shape`` [B,C,D,H,W]
    from the sample's cotangent ``grad`` [B,C,P] (fp32) at
    ``px``/``py``/``pz`` [B,P]. Sums in fp32 with atomics (their order varies
    from run to run) and returns the volume's ``dtype``.

    ``sample3d_dvol_cuda.launches`` counts the launches.
    """
    b, c, d, h, w = volume_shape
    dvol = torch.zeros((b, c, d, h, w), dtype=torch.float32, device=grad.device)
    _check_positions("sample3d_dvol_cuda", dvol, px, py, pz)
    _check_cotangent("sample3d_dvol_cuda", grad, (b, c, px.shape[1]), dvol.device)
    lib = load()
    with torch.cuda.device(dvol.device):
        code = lib.tpureg_warp3d_dvol(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), grad.data_ptr(),
            dvol.data_ptr(), b, c, d, h, w, px.shape[1], stream_handle(dvol))
    check(code, "3-D warp volume-gradient kernel (K6c)")
    sample3d_dvol_cuda.launches += 1
    return dvol.to(dtype)


sample3d_dvol_cuda.launches = 0


def sample3d(vol, px, py, pz):
    """Trilinear sample of NCDHW ``vol`` at float voxel positions (px, py,
    pz), each [B, ...]; returns [B, C, ...] in ``vol``'s dtype, with each
    out-of-volume corner contributing zero. The op ``tpureg::sample3d``:
    kernels K6a (forward), K6b and K6c (backward) on CUDA, the plain gather
    and autograd on the CPU; the positions go in as [B, P] in fp32 (fp64
    for an fp64 volume)."""
    b, c = vol.shape[:2]
    compute = _compute_dtype(vol)
    out = torch.ops.tpureg.sample3d(vol, *(t.reshape(b, -1).to(compute)
                                           for t in (px, py, pz)))
    return out.reshape(b, c, *px.shape[1:]).to(vol.dtype)


def voxel_grid(d: int, h: int, w: int, device=None, dtype=torch.float32):
    """(z, y, x) integer voxel coordinates, each [D, H, W]."""
    return torch.meshgrid(*(torch.arange(n, dtype=dtype, device=device)
                            for n in (d, h, w)), indexing="ij")


def warp3d(vol, flow):
    """Backward-warp NCDHW ``vol`` by ``flow`` [B, 3, D, H, W] in voxels,
    channels (u_x, u_y, u_z): samples at ``p = xyz + flow`` (tpureg's pixel
    convention, warp.py:248-265). Positions are fp32 (fp64 for an fp64
    flow)."""
    _, _, d, h, w = flow.shape
    compute = _compute_dtype(flow)
    zz, yy, xx = voxel_grid(d, h, w, flow.device, compute)
    return sample3d(vol, xx + flow[:, 0].to(compute),
                    yy + flow[:, 1].to(compute), zz + flow[:, 2].to(compute))
