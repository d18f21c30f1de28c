from .channelnorm import channelnorm
from .correlation import (
    correlation,
    correlation_bwd_cuda,
    correlation_bwd_reference,
    correlation_cuda,
    correlation_reference,
    displacement_count,
)
from .resize import resize2d
from .warp import (
    base_grid,
    sample2d,
    sample2d_cuda,
    sample2d_dimg_cuda,
    sample2d_dimg_reference,
    sample2d_gather,
    sample2d_nearest,
    sample2d_taps_cuda,
    sample2d_taps_reference,
    warp2d,
)

__all__ = [
    "channelnorm",
    "correlation",
    "correlation_bwd_cuda",
    "correlation_bwd_reference",
    "correlation_cuda",
    "correlation_reference",
    "displacement_count",
    "resize2d",
    "base_grid",
    "sample2d",
    "sample2d_cuda",
    "sample2d_dimg_cuda",
    "sample2d_dimg_reference",
    "sample2d_gather",
    "sample2d_nearest",
    "sample2d_taps_cuda",
    "sample2d_taps_reference",
    "warp2d",
]
