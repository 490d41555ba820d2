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
  generator when None); :class:`Dropout2D`, :class:`Dropout3D` and
  :class:`AlphaDropout` likewise.
* :class:`Pad1D` / :class:`Pad2D` / :class:`Pad3D`, :class:`Upsample`
  (and its nearest and bilinear forms) and :class:`CosineSimilarity`
  hold their arguments and call the functional.
"""
from __future__ import annotations

import sys

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Embedding", "Flatten", "Identity", "Pad1D", "Pad2D", "Pad3D",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
           "CosineSimilarity"]


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


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format, self.generator = p, data_format, generator

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format, self.generator = p, data_format, generator

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training,
                               generator=self.generator)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._pad, self._mode = padding, mode
        self._value, self._data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self._pad, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)
