"""Correlation cost volume, the counterpart of ``tpureg/ops/correlation.py``.

For each displacement ``(dy, dx)`` with ``dy, dx ∈ {-md, -md+s2, ..., md}``:

    out[b, iy*K + ix, y, x] = (1/C) * Σ_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx]

with zero contribution where ``(y+dy, x+dx)`` is outside the image and
``K = 2*md/s2 + 1`` (21 for FlowNetC's md 20, s2 2; 9 for PWC's md 4, s2 1).
The output channel order is row-major over (dy, dx), which FlowNetC's
conv3_1 weights depend on. Layout NCHW; the output has the input's dtype and
is accumulated in fp32.

``correlation`` sends a CUDA tensor to kernel K1 (``csrc/correlation.cu``)
and a CPU tensor to the plain ``correlation_reference``; there is no other
route. The kernel is forward-only: its backward (K2) comes with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_lib import DTYPE_CODES, check, load, stream_handle

__all__ = ["correlation", "correlation_reference", "correlation_cuda",
           "displacement_count"]


def displacement_count(max_displacement: int, stride2: int = 1) -> int:
    """Displacements per axis: K = 2*md/s2 + 1 (21 for FlowNetC, 9 for PWC)."""
    return 2 * (max_displacement // stride2) + 1


def correlation_reference(f1, f2, max_displacement: int, stride2: int = 1):
    """Plain PyTorch correlation: a zero pad, then the K² shifted dot products.

    NCHW in, ``[B, K*K, H, W]`` out, in fp32 and cast to the input dtype.
    """
    b, c, h, w = f1.shape
    md, s2 = max_displacement, stride2
    k = displacement_count(md, s2)
    a = f1.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    cols = []
    for iy in range(k):
        for ix in range(k):
            # f2p[..., iy*s2 : iy*s2+h, ix*s2 : ix*s2+w] is f2 shifted by
            # (dy, dx) = (iy*s2 - md, ix*s2 - md), zero-padded
            shifted = f2p[:, :, iy * s2:iy * s2 + h, ix * s2:ix * s2 + w]
            cols.append((a * shifted).sum(1))
    out = torch.stack(cols, 1)
    return (out / c).to(f1.dtype)


def correlation_cuda(f1, f2, max_displacement: int, stride2: int = 1):
    """Launch K1 on CUDA tensors ``[B, C, H, W]`` (fp32 or bf16, contiguous).

    ``correlation_cuda.launches`` counts the launches.
    """
    if not (f1.is_cuda and f2.is_cuda and f1.device == f2.device):
        raise ValueError("correlation_cuda takes two tensors on one CUDA device")
    if f1.dtype not in DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError(f"correlation_cuda takes fp32 or bf16 operands of one "
                        f"dtype, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation_cuda takes two [B,C,H,W] tensors of one "
                         f"shape, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation_cuda takes contiguous tensors")
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


class _CorrelationKernel(torch.autograd.Function):
    """K1 as an autograd node; its backward is the training slice's K2."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride2):
        return correlation_cuda(f1, f2, max_displacement, stride2)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the CUDA correlation is forward-only: its backward kernel (K2) "
            "comes with the training slice")


def correlation(f1, f2, max_displacement: int, stride2: int = 1):
    """Correlation cost volume: kernel K1 on CUDA, the plain version on CPU."""
    if f1.is_cuda or f2.is_cuda:
        return _CorrelationKernel.apply(f1.contiguous(), f2.contiguous(),
                                        max_displacement, stride2)
    return correlation_reference(f1, f2, max_displacement, stride2)
