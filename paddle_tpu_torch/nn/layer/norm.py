"""LayerNorm, RMSNorm and the BatchNorms (``paddle_tpu/nn/layer/norm.py``).

* :class:`LayerNorm` runs :class:`~...ops.kernels.LayerNormFunction`: the
  ``layer_norm`` kernel wrapper forward (Triton on the card, the plain
  version on the CPU), the plain gradient backward; in f32 under
  ``auto_cast`` (``layer_norm`` is on the black list).
* :class:`RMSNorm` (weight only) runs :func:`~..functional.rms_norm`, the
  ``rms_norm`` kernel wrapper forward in the same way.
* :class:`BatchNorm` / :class:`BatchNorm1D` / :class:`BatchNorm2D` run
  :func:`~..functional.batch_norm` with trainable ``weight`` (ones) and
  ``bias`` (zeros) and the running statistics as buffers named ``_mean``
  (zeros) and ``_variance`` (ones), Paddle's ``state_dict`` keys
  (``norm.py:74-77``); ``train()`` normalises by the batch and updates
  them, ``eval()`` normalises by them. The buffers follow the module's
  dtype and ``amp.decorate``'s casts.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.kernels import LayerNormFunction
from .. import functional as F
from .common import _amp_cast, _param

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D"]


class LayerNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-5, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = _param((hidden_size,), device, dtype, generator,
                             fill=1.0)
        self.bias = _param((hidden_size,), device, dtype, generator,
                           fill=0.0)

    def forward(self, x):
        x, w, b = _amp_cast("layer_norm", x, self.weight, self.bias)
        return LayerNormFunction.apply(x, w, b, self.epsilon)


class RMSNorm(nn.Module):
    """RMS normalisation over the last axis with a unit-initialised weight
    (``nn/layer/norm.py:45``; default epsilon 1e-6)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = _param((hidden_size,), device, dtype, generator,
                             fill=1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class BatchNorm(nn.Module):
    """``BatchNorm(num_features, momentum=0.9, epsilon=1e-5,
    weight_attr=None, bias_attr=None, data_format="NCHW",
    use_global_stats=None)``; ``weight_attr=False`` / ``bias_attr=False``
    leave out the scale / shift (``_BatchNormBase``, ``norm.py:58``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else _param(
            (num_features,), device, dtype, generator, fill=1.0)
        self.bias = None if bias_attr is False else _param(
            (num_features,), device, dtype, generator, fill=0.0)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device, dtype=dtype))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device,
                                                     dtype=dtype))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm1D(BatchNorm):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, **kw)


class BatchNorm2D(BatchNorm):
    pass
