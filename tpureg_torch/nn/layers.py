"""Building blocks with the reference's geometry, names and initialisation,
the counterpart of ``tpureg/nn/layers.py``.

- ``ConvBlock``: conv [+ BN] + LeakyReLU(0.1), an ``nn.Sequential`` whose
  members 0 and 1 carry the reference's ``<block>.0.*`` (conv) and
  ``<block>.1.*`` (BN) state-dict keys;
- ``IConvBlock``: flownet2's ``i_conv``, a biased conv [+ BN] with no
  activation;
- ``Deconv``: ``ConvTranspose2d(k=4, s=2, p=1)`` + LeakyReLU(0.1), keys
  ``<deconv>.0.*``;
- ``TorchConvTranspose`` and ``predict_flow``: the bare transposed conv and
  the 3×3 conv to two flow channels;
- ``conv3d``: a 3-D convolution with flax's padding and initialisers;
- ``BatchNorm2d``: eps 1e-5, momentum 0.1 (flax's momentum 0.9), whose
  running variance takes the biased batch variance in training, as flax's
  does (``nn.BatchNorm2d`` takes the unbiased one);
- ``leaky_relu``: flax's, whose slope at exactly 0 is 1.

Initialisation follows the package conventions: kaiming_normal(a=0.1) for
the Pinard lineage, xavier_uniform weights with U(0, 1) biases for NVIDIA's
flownet2 networks, flax's own default (``init_lecun_normal``, zero biases)
for the 3-D networks. Draws come from an explicit ``torch.Generator``. Fans
are counted as flax counts them for its (kh, kw, in, out) kernels, so a
transposed conv's fan-in is its input channels times the window.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_sum, spans_ranks

__all__ = [
    "ConvBlock",
    "IConvBlock",
    "Deconv",
    "TorchConvTranspose",
    "torch_conv",
    "conv3d",
    "predict_flow",
    "batch_norm",
    "BatchNorm2d",
    "init_kaiming_leaky",
    "init_xavier_uniform",
    "init_lecun_normal",
    "init_normal",
    "leaky_relu",
    "bias_uniform01",
    "bias_zeros",
    "init_module_",
]

# An initialiser fills a weight in place: fn(weight, fan_in, fan_out, generator).
WeightInit = Callable[[torch.Tensor, int, int, Optional[torch.Generator]], None]
# A bias initialiser fills a bias in place: fn(bias, generator).
BiasInit = Callable[[torch.Tensor, Optional[torch.Generator]], None]


def init_kaiming_leaky(negative_slope: float = 0.1) -> WeightInit:
    """torch ``kaiming_normal_(w, a)``: std = sqrt(2/(1+a²)) / sqrt(fan_in)."""
    gain = math.sqrt(2.0 / (1.0 + negative_slope**2))

    def init(weight, fan_in, fan_out, generator):
        weight.normal_(0.0, gain / math.sqrt(fan_in), generator=generator)

    return init


def init_xavier_uniform() -> WeightInit:
    def init(weight, fan_in, fan_out, generator):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        weight.uniform_(-limit, limit, generator=generator)

    return init


def init_lecun_normal() -> WeightInit:
    """flax's default kernel initialiser, ``lecun_normal``: a normal
    truncated at ±2σ whose σ is corrected so that the variance is 1/fan_in."""
    # std of a unit normal truncated at ±2 (flax's variance_scaling constant)
    trunc_std = 0.87962566103423978

    def init(weight, fan_in, fan_out, generator):
        std = math.sqrt(1.0 / fan_in) / trunc_std
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)

    return init


def init_normal(std: float) -> WeightInit:
    """flax's ``initializers.normal(std)``: N(0, std²) whatever the fans."""

    def init(weight, fan_in, fan_out, generator):
        weight.normal_(0.0, std, generator=generator)

    return init


def leaky_relu(x, negative_slope: float):
    """flax's ``leaky_relu``: ``where(x >= 0, x, slope·x)``. Its slope at
    exactly 0 is 1, where ``F.leaky_relu``'s is ``negative_slope``; exact
    zeros are common (out-of-image correlation taps, zero-initialised biases
    on the zero background of a volume)."""
    return torch.where(x >= 0, x, x * negative_slope)


def bias_uniform01(bias, generator):
    """torch ``init.uniform_(bias)`` default U(0, 1), a flownet2 quirk."""
    bias.uniform_(0.0, 1.0, generator=generator)


def bias_zeros(bias, generator):
    bias.zero_()


@torch.no_grad()
def init_module_(conv, kernel_init: WeightInit, bias_init: BiasInit,
                 generator=None):
    """Fill a convolution's (1-3 spatial dims, transposed or not) or a dense
    layer's weight and bias in place, with fans counted as flax counts
    them; returns the module."""
    w = conv.weight
    window = w[0, 0].numel()
    if isinstance(conv, nn.modules.conv._ConvTransposeNd):  # (in, out, kh, kw)
        fan_in, fan_out = w.shape[0] * window, w.shape[1] * window
    else:  # (out, in, kh, kw)
        fan_in, fan_out = w.shape[1] * window, w.shape[0] * window
    kernel_init(w, fan_in, fan_out, generator)
    if conv.bias is not None:
        bias_init(conv.bias, generator)
    return conv


def torch_conv(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
               padding: Optional[int] = None, dilation: int = 1,
               use_bias: bool = True,
               kernel_init: WeightInit = init_kaiming_leaky(0.1),
               bias_init: BiasInit = bias_zeros,
               generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """``nn.Conv2d`` with torch geometry: pad = (k-1)//2 · dilation."""
    pad = (kernel_size - 1) // 2 * dilation if padding is None else padding
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, pad, dilation,
                     bias=use_bias)
    return init_module_(conv, kernel_init, bias_init, generator)


def conv3d(in_ch: int, out_ch: int, kernel_size: int = 3, stride=1,
           kernel_init: Optional[WeightInit] = None,
           generator: Optional[torch.Generator] = None) -> nn.Conv3d:
    """``nn.Conv3d`` with flax's padding (k-1)//2 on each side and flax's
    default initialisers (lecun_normal kernel, zero bias) unless
    ``kernel_init`` is given."""
    conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride, (kernel_size - 1) // 2)
    return init_module_(conv, kernel_init or init_lecun_normal(), bias_zeros,
                        generator)


def predict_flow(in_ch: int, use_bias: bool = False,
                 kernel_init: WeightInit = init_kaiming_leaky(0.1),
                 bias_init: BiasInit = bias_zeros,
                 generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """3×3 conv to the 2 flow channels (bias per package convention)."""
    return torch_conv(in_ch, 2, 3, 1, use_bias=use_bias,
                      kernel_init=kernel_init, bias_init=bias_init,
                      generator=generator)


class TorchConvTranspose(nn.ConvTranspose2d):
    """torch ``ConvTranspose2d(k, s, p)``; (in-1)*s - 2p + k output size,
    exactly 2× for the reference's k=4, s=2, p=1."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, use_bias: bool = False,
                 kernel_init: WeightInit = init_kaiming_leaky(0.1),
                 bias_init: BiasInit = bias_zeros,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         bias=use_bias)
        init_module_(self, kernel_init, bias_init, generator)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` over NCHW, with torch's parameter and buffer
    names (so state dicts keep their keys).

    Training normalises by the batch's mean and biased variance, as
    ``nn.BatchNorm2d`` does, but the running statistics are updated as flax
    updates them: ``running = (1 - momentum) · running + momentum · batch``
    with the **biased** batch variance, both taken in fp32 whatever the
    activation dtype. The variance is taken in two passes, E[(x − E[x])²]:
    flax's one-pass E[x²] − E[x]² cancels in fp32 behind the U(0, 1) biases
    of flownet2's i_conv blocks. Evaluation normalises by the running
    statistics. The output has the input's dtype; the scale, shift and
    statistics stay fp32.

    ``process_group``: None, or a group of processes that each hold their
    rows of one global batch (the data-parallel train step sets it for its
    duration; ``parallel/mesh.py``). Where it holds more than one process,
    training normalises by the global batch's mean and biased variance, as
    flax's BatchNorm does over a batch sharded on ``'data'``: two passes,
    the count and the sums all-reduced, then the centred sums of squares,
    in fp32 (fp64 for fp64 input), through ``all_sum`` so that gradients
    flow through both statistics; the running statistics are updated from
    the global ones, so every rank's buffers stay equal. (A subclass of its
    own: ``SyncBatchNorm.convert_sync_batchnorm`` would drop flax's
    running-statistics rule.)
    """

    process_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if spans_ranks(self.process_group):
            return self._global_forward(x)
        if x.numel() == x.shape[1]:
            # one value per channel, which F.batch_norm refuses: flax's
            # normalisation gives the shift (x - mean = 0)
            xf = x.float()
            y = (xf - xf) * self.weight[:, None, None] + self.bias[:, None, None]
            y = y.to(x.dtype)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, momentum=0.0, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3),
                                       correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * self.momentum)
            self.running_var.mul_(keep).add_(var * self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _global_forward(self, x):
        """Training over the global batch of ``process_group``'s ranks."""
        group = self.process_group
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_tensor([x.numel() / x.shape[1]])
        stats = all_sum(torch.cat([xf.sum(dim=(0, 2, 3)), count]), group)
        n = stats[-1]
        mean = stats[:-1] / n
        centred = xf - mean[:, None, None]
        var = all_sum(torch.square(centred).sum(dim=(0, 2, 3)), group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = centred * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean.detach() * self.momentum)
            self.running_var.mul_(keep).add_(var.detach() * self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batch_norm(channels: int) -> BatchNorm2d:
    """BatchNorm with flax's running statistics: eps 1e-5, momentum 0.1
    (flax momentum 0.9)."""
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ConvBlock(nn.Sequential):
    """conv [+ BN] + LeakyReLU(0.1), the universal encoder block."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 dilation: int = 1, use_bn: bool = True,
                 kernel_init: WeightInit = init_kaiming_leaky(0.1),
                 bias_init: BiasInit = bias_zeros,
                 generator: Optional[torch.Generator] = None):
        layers = [torch_conv(in_ch, out_ch, kernel_size, stride, padding,
                             dilation, use_bias=not use_bn,
                             kernel_init=kernel_init, bias_init=bias_init,
                             generator=generator)]
        if use_bn:
            layers.append(batch_norm(out_ch))
        layers.append(nn.LeakyReLU(0.1))
        super().__init__(*layers)


class IConvBlock(nn.Sequential):
    """conv [+ BN], no activation (flownet2 ``i_conv``); the conv keeps its
    bias even in front of BN, as the reference does."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, use_bn: bool = True,
                 kernel_init: WeightInit = init_xavier_uniform(),
                 bias_init: BiasInit = bias_uniform01,
                 generator: Optional[torch.Generator] = None):
        layers = [torch_conv(in_ch, out_ch, kernel_size, stride, use_bias=True,
                             kernel_init=kernel_init, bias_init=bias_init,
                             generator=generator)]
        if use_bn:
            layers.append(batch_norm(out_ch))
        super().__init__(*layers)


class Deconv(nn.Sequential):
    """ConvTranspose(4, 2, 1) + LeakyReLU(0.1)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = False,
                 kernel_init: WeightInit = init_kaiming_leaky(0.1),
                 bias_init: BiasInit = bias_zeros,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            TorchConvTranspose(in_ch, out_ch, use_bias=use_bias,
                               kernel_init=kernel_init, bias_init=bias_init,
                               generator=generator),
            nn.LeakyReLU(0.1),
        )
