"""Random elastic deformation for the moving-image synthesis, the 2-D part of
``tpureg/ops/elastic.py:54-94`` (MONAI ``Rand2DElasticd`` semantics,
reference dataset.py:78-79: spacing (16, 16), magnitude (0, 0.5) for
training and (0.5, 1) for evaluation, zero padding, bilinear image, nearest
labels).

A coarse control grid of offsets (one point per ``spacing`` pixels, plus
boundary points) is drawn as ``N(0, 1) · magnitude`` with ``magnitude ~
U(magnitude_range)`` per sample, in pixels, upsampled to the image with
``cubic_resize`` (JAX's cubic, not PyTorch's bicubic) and applied as a
backward warp. Draws come from an explicit ``torch.Generator`` on the
image's device; ``jax.random`` and ``torch.Generator`` give different
numbers from one seed, so callers that compare with tpureg pass the
magnitudes and offsets in. NCHW; displacements are [B, 2, H, W], channel 0
x and channel 1 y.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .resize import cubic_resize
from .warp import base_grid, sample2d, sample2d_nearest

__all__ = ["elastic_displacement_2d", "rand_elastic_2d"]


def elastic_displacement_2d(batch: int, size: Tuple[int, int],
                            spacing: Tuple[int, int] = (16, 16),
                            magnitude_range: Tuple[float, float] = (0.0, 0.5),
                            generator: Optional[torch.Generator] = None,
                            device=None, magnitudes=None, offsets=None):
    """[B, 2, H, W] smooth random displacement field in pixels.

    ``magnitudes`` [B] and ``offsets`` [B, 2, gh, gw] (standard normal, with
    gh = H // spacing + 3) are drawn from ``generator`` unless given."""
    h, w = size
    gh = h // spacing[0] + 3  # control points incl. border padding
    gw = w // spacing[1] + 3
    if generator is not None:
        device = generator.device
    if magnitudes is None:
        magnitudes = torch.empty(batch, device=device).uniform_(
            *magnitude_range, generator=generator)
    if offsets is None:
        offsets = torch.randn((batch, 2, gh, gw), device=device,
                              generator=generator)
    return cubic_resize(offsets * magnitudes[:, None, None, None], (h, w))


def rand_elastic_2d(image, seg=None, spacing: Tuple[int, int] = (16, 16),
                    magnitude_range: Tuple[float, float] = (0.0, 0.5),
                    generator: Optional[torch.Generator] = None):
    """Deform [B, C, H, W] ``image`` (and ``seg``) by one random elastic
    field per sample: bilinear ``sample2d`` for the image (kernel K3 on the
    card), nearest for the labels. Returns (image, seg or None)."""
    b, _, h, w = image.shape
    disp = elastic_displacement_2d(b, (h, w), spacing, magnitude_range,
                                   generator=generator, device=image.device)
    grid = base_grid(h, w, image.device)
    px = grid[..., 0] + disp[:, 0]
    py = grid[..., 1] + disp[:, 1]
    out_seg = None if seg is None else sample2d_nearest(seg, px, py)
    return sample2d(image, px, py), out_seg
