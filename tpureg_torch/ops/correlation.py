"""Correlation cost volume, the counterpart of ``tpureg/ops/correlation.py``.

For each displacement ``(dy, dx)`` with ``dy, dx ∈ {-md, -md+s2, ..., md}``:

    out[b, iy*K + ix, y, x] = (1/C) * Σ_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx]

with zero contribution where ``(y+dy, x+dx)`` is outside the image and
``K = 2*md/s2 + 1`` (21 for FlowNetC's md 20, s2 2; 9 for PWC's md 4, s2 1).
The output channel order is row-major over (dy, dx), which FlowNetC's
conv3_1 weights depend on. Layout NCHW; the output has the input's dtype and
is accumulated in fp32.

``correlation`` calls the op ``torch.ops.tpureg.correlation``
(``ops/library.py``), which sends a CUDA tensor to kernel K1
(``csrc/correlation.cu``), whose backward is kernel K2
(``csrc/correlation_bwd.cu``), and a CPU tensor to ``correlation_plain``,
whose backward is autograd's through it; there is no other route. K2
computes

    df1[b,c,y,x] = (1/C) Σ_d g[b,d,y,x] · f2[b,c,y+dy,x+dx]
    df2[b,c,y,x] = (1/C) Σ_d g[b,d,y-dy,x-dx] · f1[b,c,y-dy,x-dx]

over the displacements d whose tap lies inside the image, in fp32, and
returns both in the operands' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_lib import DTYPE_CODES, check, load, stream_handle
from .warp import _compute_dtype

__all__ = ["correlation", "correlation_reference", "correlation_plain",
           "correlation_cuda", "correlation_bwd_cuda",
           "correlation_bwd_reference", "displacement_count"]


def displacement_count(max_displacement: int, stride2: int = 1) -> int:
    """Displacements per axis: K = 2*md/s2 + 1 (21 for FlowNetC, 9 for PWC)."""
    return 2 * (max_displacement // stride2) + 1


def _correlation(f1, f2, max_displacement, stride2, compute):
    b, c, h, w = f1.shape
    md, s2 = max_displacement, stride2
    k = displacement_count(md, s2)
    a = f1.to(compute)
    f2p = F.pad(f2.to(compute), (md, md, md, md))
    cols = []
    for iy in range(k):
        for ix in range(k):
            # f2p[..., iy*s2 : iy*s2+h, ix*s2 : ix*s2+w] is f2 shifted by
            # (dy, dx) = (iy*s2 - md, ix*s2 - md), zero-padded
            shifted = f2p[:, :, iy * s2:iy * s2 + h, ix * s2:ix * s2 + w]
            cols.append((a * shifted).sum(1))
    out = torch.stack(cols, 1)
    return (out / c).to(f1.dtype)


def correlation_reference(f1, f2, max_displacement: int, stride2: int = 1):
    """Plain PyTorch correlation: a zero pad, then the K² shifted dot products.

    NCHW in, ``[B, K*K, H, W]`` out, in fp32 and cast to the input dtype:
    what K1 is held to.
    """
    return _correlation(f1, f2, max_displacement, stride2, torch.float32)


def correlation_plain(f1, f2, max_displacement: int, stride2: int = 1):
    """The op's CPU version: ``correlation_reference`` computed in fp64 for
    fp64 operands (in fp32 for the others)."""
    return _correlation(f1, f2, max_displacement, stride2, _compute_dtype(f1))


def correlation_bwd_reference(f1, f2, grad, max_displacement: int,
                              stride2: int = 1):
    """K2's plain version: ``(df1, df2)`` by autograd through
    ``correlation_reference`` in fp32 (which is where it computes), cast to
    the operands' dtype."""
    with torch.enable_grad():
        a = f1.detach().float().requires_grad_()
        b = f2.detach().float().requires_grad_()
        out = correlation_reference(a, b, max_displacement, stride2)
        da, db = torch.autograd.grad(out, (a, b), grad.float())
    return da.to(f1.dtype), db.to(f2.dtype)


def _check_operands(name, f1, f2):
    if not (f1.is_cuda and f2.is_cuda and f1.device == f2.device):
        raise ValueError(f"{name} takes two tensors on one CUDA device")
    if f1.dtype not in DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError(f"{name} takes fp32 or bf16 operands of one "
                        f"dtype, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"{name} takes two [B,C,H,W] tensors of one "
                         f"shape, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def correlation_cuda(f1, f2, max_displacement: int, stride2: int = 1):
    """Launch K1 on CUDA tensors ``[B, C, H, W]`` (fp32 or bf16, contiguous).

    ``correlation_cuda.launches`` counts the launches.
    """
    _check_operands("correlation_cuda", f1, f2)
    b, c, h, w = f1.shape
    k = displacement_count(max_displacement, stride2)
    out = torch.empty((b, k * k, h, w), dtype=f1.dtype, device=f1.device)
    lib = load()
    with torch.cuda.device(f1.device):
        code = lib.tpureg_correlation_fwd(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), DTYPE_CODES[f1.dtype],
            b, c, h, w, max_displacement, stride2, stream_handle(f1))
    check(code, "correlation kernel (K1)")
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0


def correlation_bwd_cuda(f1, f2, grad, max_displacement: int, stride2: int = 1):
    """Launch K2: ``(df1, df2)`` from the operands ``f1``/``f2`` [B,C,H,W]
    and the output cotangent ``grad`` [B,K*K,H,W] (fp32 or bf16, any of the
    two), all contiguous on one card. The cotangents have the operands' dtype.

    ``correlation_bwd_cuda.launches`` counts the launches (one for both).
    """
    _check_operands("correlation_bwd_cuda", f1, f2)
    b, c, h, w = f1.shape
    k = displacement_count(max_displacement, stride2)
    if grad.device != f1.device or grad.dtype not in DTYPE_CODES:
        raise TypeError(f"correlation_bwd_cuda takes an fp32 or bf16 cotangent on "
                        f"the operands' card, got {grad.dtype} on {grad.device}")
    if grad.shape != (b, k * k, h, w) or not grad.is_contiguous():
        raise ValueError(f"correlation_bwd_cuda takes a contiguous cotangent of "
                         f"shape {(b, k * k, h, w)}, got {tuple(grad.shape)}")
    df1 = torch.empty_like(f1)
    df2 = torch.empty_like(f2)
    lib = load()
    with torch.cuda.device(f1.device):
        code = lib.tpureg_correlation_bwd(
            f1.data_ptr(), f2.data_ptr(), grad.data_ptr(), df1.data_ptr(),
            df2.data_ptr(), DTYPE_CODES[f1.dtype], DTYPE_CODES[grad.dtype],
            b, c, h, w, max_displacement, stride2, stream_handle(f1))
    check(code, "correlation backward kernel (K2)")
    correlation_bwd_cuda.launches += 1
    return df1, df2


correlation_bwd_cuda.launches = 0


def correlation(f1, f2, max_displacement: int, stride2: int = 1):
    """Correlation cost volume: the op ``tpureg::correlation``, kernels K1
    (forward) and K2 (backward) on CUDA, the plain version and autograd on
    the CPU."""
    return torch.ops.tpureg.correlation(f1, f2, max_displacement, stride2)
