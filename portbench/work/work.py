"""The operations and bytes each hand-written kernel's function needs, and
the peaks of one H100, frozen for the benchmark.

Bytes count each input read once and each output written once; FLOP count
what the function needs on these inputs (two a multiply-add), whatever an
implementation reads or computes again. Shapes are tuples, dtypes torch
dtypes. ``bound`` is the least time the card could take: the larger of the
bytes over the HBM bandwidth and the FLOP over the dtype's peak.
"""

from __future__ import annotations

import torch

# one H100 SXM, NVIDIA's data sheet, dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores
TF32_FLOPS = 495e12                     # TF32 tensor cores


def _size(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def displacements(md: int, s2: int = 1) -> int:
    return 2 * (md // s2) + 1


def bound(nbytes, flops, dtype=torch.float32):
    """(seconds, "bytes" or "operations"): the least time and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def correlation_work(shape, md, s2, dtype=torch.float32):
    """(bytes, FLOP) of the cost volume: each input read once, the output
    written once, one multiply-add per in-image tap."""
    b, c, h, w = shape
    k = displacements(md, s2)
    es = _size(dtype)
    taps_y = sum(max(0, min(h, h - (iy * s2 - md)) - max(0, -(iy * s2 - md)))
                 for iy in range(k))
    taps_x = sum(max(0, min(w, w - (ix * s2 - md)) - max(0, -(ix * s2 - md)))
                 for ix in range(k))
    nbytes = 2 * b * c * h * w * es + b * k * k * h * w * es
    return nbytes, 2 * b * c * taps_y * taps_x


def correlation_bwd_work(shape, md, s2, dtype=torch.float32, gdtype=torch.float32):
    """(bytes, FLOP) of the cost volume's VJP: f1, f2 and the cotangent read
    once, df1 and df2 written once; one multiply-add per in-image tap for
    each operand's cotangent."""
    b, c, h, w = shape
    k = displacements(md, s2)
    _, fwd_flops = correlation_work(shape, md, s2, dtype)
    nbytes = 4 * b * c * h * w * _size(dtype) + b * k * k * h * w * _size(gdtype)
    return nbytes, 2 * fwd_flops


def warp_work(shape, p, dtype=torch.float32):
    """(bytes, FLOP) of one bilinear sample of an image ``shape`` [B, C, H,
    W] at ``p`` positions per image: image, positions and fp32 output once
    each; 8 FLOP of weights per position and 7 per channel."""
    b, c, h, w = shape
    nbytes = b * c * h * w * _size(dtype) + 2 * b * p * 4 + b * c * p * 4
    return nbytes, b * p * (8 + 7 * c)


def warp_dpos_work(shape, p, dtype=torch.float32):
    """(bytes, FLOP) of the positions' cotangent: the image, the two position
    arrays and the fp32 cotangent [B, C, P] read once, dpx and dpy [B, P]
    written once in fp32; 4 FLOP of fractions per position, 10 for the two
    bases and 4 for the contraction per channel."""
    b, c, h, w = shape
    nbytes = (b * c * h * w * _size(dtype) + 2 * b * p * 4 + b * c * p * 4
              + 2 * b * p * 4)
    return nbytes, b * p * (4 + 14 * c)


def warp_dimg_work(shape, p, dtype=torch.float32):
    """(bytes, FLOP) of the image's cotangent: positions and the fp32
    cotangent read once, the image cotangent written once in ``dtype``; 8
    FLOP of weights per position and 4 products and 4 sums per channel."""
    b, c, h, w = shape
    nbytes = 2 * b * p * 4 + b * c * p * 4 + b * c * h * w * _size(dtype)
    return nbytes, b * p * (8 + 8 * c)


def warp3d_work(shape, p, dtype=torch.float32):
    """(bytes, FLOP) of a trilinear sample of a volume ``shape`` [B, C, D,
    H, W]: the volume, three position arrays and the fp32 sample once each;
    22 FLOP of corner weights per position and 15 per channel."""
    b, c = shape[:2]
    vox = shape[2] * shape[3] * shape[4]
    nbytes = b * c * vox * _size(dtype) + 3 * b * p * 4 + b * c * p * 4
    return nbytes, b * p * (22 + 15 * c)


def warp3d_dpos_work(shape, p, dtype=torch.float32):
    """(bytes, FLOP) of the 3-D positions' cotangent: the volume, three
    position arrays and the fp32 cotangent read once, three fp32 outputs
    [B, P] written once; 22 FLOP of corner weights per position, 64 for the
    bases and 6 for the contraction per channel."""
    b, c = shape[:2]
    vox = shape[2] * shape[3] * shape[4]
    nbytes = b * c * vox * _size(dtype) + 3 * b * p * 4 + b * c * p * 4 + 3 * b * p * 4
    return nbytes, b * p * (22 + 70 * c)


def warp3d_dvol_work(shape, p, dtype=torch.float32):
    """(bytes, FLOP) of the volume's cotangent: positions and the fp32
    cotangent read once, the volume cotangent written once in ``dtype``; 22
    FLOP of weights per position and 8 products and 8 sums per channel."""
    b, c = shape[:2]
    vox = shape[2] * shape[3] * shape[4]
    nbytes = 3 * b * p * 4 + b * c * p * 4 + b * c * vox * _size(dtype)
    return nbytes, b * p * (22 + 16 * c)
