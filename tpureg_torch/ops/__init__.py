from .channelnorm import channelnorm
from .correlation import (
    correlation,
    correlation_cuda,
    correlation_reference,
    displacement_count,
)
from .resize import resize2d
from .warp import base_grid, sample2d, sample2d_cuda, sample2d_gather, warp2d

__all__ = [
    "channelnorm",
    "correlation",
    "correlation_cuda",
    "correlation_reference",
    "displacement_count",
    "resize2d",
    "base_grid",
    "sample2d",
    "sample2d_cuda",
    "sample2d_gather",
    "warp2d",
]
