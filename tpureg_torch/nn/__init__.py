from .layers import (
    BatchNorm2d,
    ConvBlock,
    Deconv,
    IConvBlock,
    TorchConvTranspose,
    batch_norm,
    bias_uniform01,
    bias_zeros,
    init_kaiming_leaky,
    init_xavier_uniform,
    predict_flow,
    torch_conv,
)

__all__ = [
    "BatchNorm2d",
    "ConvBlock",
    "Deconv",
    "IConvBlock",
    "TorchConvTranspose",
    "batch_norm",
    "bias_uniform01",
    "bias_zeros",
    "init_kaiming_leaky",
    "init_xavier_uniform",
    "predict_flow",
    "torch_conv",
]
