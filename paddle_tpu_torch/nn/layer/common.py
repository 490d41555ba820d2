"""Linear, Embedding, Dropout, Identity and Flatten
(``paddle_tpu/nn/layer/common.py``), on :class:`~.layers.Layer` with the
JAX package's arguments in its order; the port's ``device``, ``dtype``
and ``generator`` are keyword-only extras.

* :class:`Linear` keeps Paddle's ``[in, out]`` weight layout and computes
  :func:`~..functional.linear`; XavierUniform weight, zero bias (none
  with ``bias_attr=False``).
* :class:`Embedding` gathers rows of its ``[num, dim]`` XavierUniform
  table (:func:`~..functional.embedding`); the ``padding_idx`` row (a
  negative index counts from the end) is zeroed at creation and gets no
  gradient.
* :class:`Dropout` is :func:`~..functional.dropout` with the layer's
  ``training`` flag, drawing from its ``generator`` (the default
  generator when None).
"""
from __future__ import annotations

import sys

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Identity", "Flatten"]


def _amp_cast(op_name, *tensors):
    """The package's ``amp_cast`` (``paddle_tpu_torch.nn.layer.amp_cast``),
    read when called: every layer casts through it."""
    return sys.modules[__package__].amp_cast(op_name, *tensors)


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx if padding_idx is None or \
            padding_idx >= 0 else num_embeddings + padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(Layer):
    """Flattens axes ``start_axis`` .. ``stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)
