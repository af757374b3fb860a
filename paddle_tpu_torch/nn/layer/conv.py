"""Convolution layers (counterpart of paddle_tpu/nn/layer/conv.py:15-84).

The JAX names and shapes: `weight` [out, in/groups, *k] and `bias` [out]
(none with `bias_attr=False`), both drawn in `reset_parameters(generator)`
from Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = in/groups ·
prod(k), as the JAX layer's default initializer draws them. The
transposed convolutions wait (ROADMAP §1 item 9).
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .layers import Layer, create_parameter


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, device=None, dtype=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: only 'zeros' is ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, dims)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._dims = dims
        self._fan_in = in_channels // groups * math.prod(self._kernel_size)
        self.weight = create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            device, dtype, weight_attr)
        self.bias = create_parameter([out_channels], device, dtype,
                                     bias_attr)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self._fan_in)
        for p in (self.weight, self.bias):
            if p is not None:
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return self._conv(x, self.weight, self.bias, self._stride,
                          self._padding, self._dilation, self._groups,
                          self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    _conv = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 1, device, dtype)


class Conv2D(_ConvNd):
    _conv = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 2, device, dtype)


class Conv3D(_ConvNd):
    _conv = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 3, device, dtype)
