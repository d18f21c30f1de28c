from .image import MI, MSE, PSNR, CORR, ssim
from .jacobian import jacobian_determinant, log_jacobian_std, neg_jacobian_fraction
from .seg import dice_average, dice_coefficient, dist_hausdorff, seg_trans
from .viz import flow_mag, flow_mag_sum, grid_generator

__all__ = [
    "MI",
    "MSE",
    "PSNR",
    "CORR",
    "ssim",
    "jacobian_determinant",
    "log_jacobian_std",
    "neg_jacobian_fraction",
    "dice_average",
    "dice_coefficient",
    "dist_hausdorff",
    "seg_trans",
    "flow_mag",
    "flow_mag_sum",
    "grid_generator",
]
