from .head import OpticalFlowReg, grid_image, outputs_to_nhwc, stn_warp

__all__ = ["OpticalFlowReg", "grid_image", "outputs_to_nhwc", "stn_warp"]
