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
  dtype and ``amp.decorate``'s casts. :class:`BatchNorm3D` is the same
  over ``NCDHW``; :class:`SyncBatchNorm` is a BatchNorm at world size 1
  (``norm.py:131-152``), and ``convert_sync_batchnorm`` swaps it in for
  every BatchNorm of a model, keeping their parameters and buffers.
* :class:`GroupNorm` and :class:`InstanceNorm2D` run their functionals
  with unit-initialised scales; :class:`LocalResponseNorm` divides by
  ``(k + alpha * window sum of squares)^beta``, the JAX layer's own
  expression (``norm.py:173-194``), which, unlike
  :func:`~..functional.local_response_norm`, does not divide ``alpha``
  by ``size``. :class:`SpectralNorm` raises ``NotImplementedError``, as
  the JAX layer does (``norm.py:197-201``); ``nn.utils.spectral_norm``
  is ported.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from ..functional.norm import layer_norm_rows
from .common import _amp_cast
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm2D",
           "RMSNorm", "LocalResponseNorm", "SpectralNorm"]


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
        return layer_norm_rows(x, self._normalized_shape, w, b, self.epsilon)

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


class BatchNorm3D(BatchNorm):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype, generator=generator)


class SyncBatchNorm(BatchNorm):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm in it (itself included) replaced
        by a :class:`SyncBatchNorm` holding the same parameters and
        buffers."""
        if isinstance(layer, BatchNorm) and not isinstance(layer, cls):
            converted = cls(layer._num_features, layer._momentum,
                            layer._epsilon, weight_attr=False,
                            bias_attr=False,
                            data_format=layer._data_format,
                            use_global_stats=layer._use_global_stats,
                            device=layer._mean.device,
                            dtype=layer._mean.dtype)
            converted.weight, converted.bias = layer.weight, layer.bias
            converted._mean, converted._variance = \
                layer._mean, layer._variance
            converted.train(layer.training)
            return converted
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        # the functional divides alpha by size; this layer does not
        return F.local_response_norm(x, self.size, self.alpha * self.size,
                                     self.beta, self.k)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        raise NotImplementedError(
            "SpectralNorm is not implemented (as in the JAX package); "
            "nn.utils.spectral_norm reparameterises a layer's weight")
