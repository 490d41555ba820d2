"""LayerNorm, RMSNorm and the BatchNorms (``paddle_tpu/nn/layer/norm.py``),
on :class:`~.layers.Layer`; parameters through ``create_parameter``
(scales ``Constant(1)``, shifts ``Constant(0)``), ``weight_attr=False`` /
``bias_attr=False`` leaving them out.

* :class:`LayerNorm` normalises over ``normalized_shape`` (an int or a
  list: the trailing axes) with :class:`~...ops.kernels.LayerNormFunction`:
  the ``layer_norm`` kernel wrapper forward (Triton on the card, the plain
  version on the CPU), the plain gradient backward; in f32 under
  ``auto_cast`` (``layer_norm`` is on the black list). Trailing axes are
  contiguous, so several of them are viewed as one row of their product
  and take the same kernel.
* :class:`RMSNorm` (weight only) runs :func:`~..functional.rms_norm`, the
  ``rms_norm`` kernel wrapper forward in the same way.
* :class:`BatchNorm` / :class:`BatchNorm1D` / :class:`BatchNorm2D` run
  :func:`~..functional.batch_norm` with trainable ``weight`` and ``bias``
  and the running statistics as buffers named ``_mean`` (zeros) and
  ``_variance`` (ones), Paddle's ``state_dict`` keys
  (``norm.py:74-77``); ``train()`` normalises by the batch and updates
  them, ``eval()`` normalises by them. The buffers follow the module's
  dtype and ``amp.decorate``'s casts.
"""
from __future__ import annotations

import torch
import math

import torch

from ...device import resolve_device
from ...ops.kernels import LayerNormFunction
from .. import functional as F
from .. import initializer as I
from .common import _amp_cast
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = [int(n) for n in normalized_shape]
        self.epsilon = float(epsilon)
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        x, w, b = _amp_cast("layer_norm", x, self.weight, self.bias)
        k = len(self._normalized_shape)
        if k == 1:
            return LayerNormFunction.apply(x, w, b, self.epsilon)
        n = math.prod(self._normalized_shape)
        rows = x.reshape(*x.shape[:-k], n)
        y = LayerNormFunction.apply(
            rows, None if w is None else w.reshape(n),
            None if b is None else b.reshape(n), self.epsilon)
        return y.reshape(x.shape)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """RMS normalisation over the last axis with a unit-initialised weight
    (``nn/layer/norm.py:45``; default epsilon 1e-6)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.epsilon = float(epsilon)
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class BatchNorm(Layer):
    """``BatchNorm(num_features, momentum=0.9, epsilon=1e-5,
    weight_attr=None, bias_attr=None, data_format="NCHW",
    use_global_stats=None, name=None)`` (``_BatchNormBase``,
    ``norm.py:58``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(
            num_features, device=dev, dtype=self._dtype))
        self.register_buffer("_variance", torch.ones(
            num_features, device=dev, dtype=self._dtype))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm1D(BatchNorm):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype, generator=generator)


class BatchNorm2D(BatchNorm):
    pass
