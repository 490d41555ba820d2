"""Conv2D (``paddle_tpu/nn/layer/conv.py``), on :class:`~.layers.Layer`:
weight ``[out_c, in_c / groups, kh, kw]`` drawn by default, as the JAX
package's is (``conv.py:50``), from ``Normal(0, sqrt(2 / (kh * kw *
in_c)))``; bias zeros, or none with ``bias_attr=False``."""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from ..functional.common import _pair
from .layers import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} do "
                             f"not divide into {groups} groups")
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode {padding_mode!r}: "
                                      f"only 'zeros' is ported")
        self._kernel_size = _pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        fan = math.prod(self._kernel_size) * in_channels
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr,
            default_initializer=I.Normal(0.0, math.sqrt(2.0 / fan)))
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)
