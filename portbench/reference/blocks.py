"""The reference's building blocks, with the reference's torch key names:
``<block>.0`` the convolution, ``<block>.1`` its BatchNorm."""

from __future__ import annotations

from torch import nn

from .ops import BatchNorm2d, Conv2d, ConvTranspose2d


def conv(cin, cout, k=3, stride=1, dilation=1, bias=True):
    """A convolution with padding (k-1)//2 · dilation."""
    return Conv2d(cin, cout, k, stride, (k - 1) // 2 * dilation, dilation, bias=bias)


def conv_block(cin, cout, k=3, stride=1, dilation=1, use_bn=True):
    """conv [+ BN] + LeakyReLU(0.1); the conv is biased only without BN."""
    layers = [conv(cin, cout, k, stride, dilation, bias=not use_bn)]
    if use_bn:
        layers.append(BatchNorm2d(cout, eps=1e-5))
    layers.append(nn.LeakyReLU(0.1))
    return nn.Sequential(*layers)


def iconv_block(cin, cout, use_bn=True):
    """flownet2's i_conv: a biased 3×3 conv [+ BN], no activation."""
    layers = [conv(cin, cout, 3, 1, bias=True)]
    if use_bn:
        layers.append(BatchNorm2d(cout, eps=1e-5))
    return nn.Sequential(*layers)


def deconv(cin, cout, bias):
    """ConvTranspose(4, 2, 1) + LeakyReLU(0.1)."""
    return nn.Sequential(ConvTranspose2d(cin, cout, 4, 2, 1, bias=bias),
                         nn.LeakyReLU(0.1))


def up_flow(bias, cin=2, cout=2, k=4, stride=2, padding=1):
    """The bare transposed convolution that upsamples a flow."""
    return ConvTranspose2d(cin, cout, k, stride, padding, bias=bias)


def predict_flow(cin, bias):
    return conv(cin, 2, 3, 1, bias=bias)
