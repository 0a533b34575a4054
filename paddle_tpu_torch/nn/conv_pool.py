"""Convolution and pooling layers (counterpart of
paddle_tpu/nn/conv_pool.py): Conv2D and MaxPool2D, AvgPool2D,
AdaptiveAvgPool2D over the port's functional ops. A Conv2D weight is
[out, in / groups, kh, kw], torch's layout and the reference's alike."""
from __future__ import annotations

import math

import torch

from . import functional as F
from .functional import _pair


class _ConvNd(torch.nn.Module):
    """weight [out, in / groups, *kernel] and bias [out] (None with
    bias_attr=False), both Uniform(-k, k) with k = 1 / sqrt(fan_in), as
    the reference initialises them."""

    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", device=None, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size, nd)
        self.stride = _pair(stride, nd)
        self.padding = padding
        self.dilation = _pair(dilation, nd)
        self.groups = groups
        self.data_format = data_format
        factory = {"device": device, "dtype": dtype}
        self.weight = torch.nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size,
            **factory))
        self.bias = (None if bias_attr is False else
                     torch.nn.Parameter(torch.empty(out_channels, **factory)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        fan_in = self.in_channels * math.prod(self.kernel_size)
        k = 1.0 / math.sqrt(fan_in)
        self.weight.uniform_(-k, k, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-k, k, generator=generator)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device, dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class MaxPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.max_pool2d(x, *self.args)


class AvgPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        # the reference's layer passes no divisor_override on to its op
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive)

    def forward(self, x):
        return F.avg_pool2d(x, *self.args)


class AdaptiveAvgPool2D(torch.nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)
