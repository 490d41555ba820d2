"""Linear, Embedding, Dropout, Identity and Flatten
(``paddle_tpu/nn/layer/common.py``).

* :class:`Linear` keeps Paddle's ``[in, out]`` weight layout and computes
  ``x @ W + b`` — no transpose at load time. The product is a plain
  ``torch.addmm``/``torch.matmul``: the JAX package leaves these products
  to XLA outside any Pallas kernel. Under ``auto_cast`` O1 it computes in
  the AMP dtype (``linear`` is on the white list).
* :class:`Embedding` is a row gather of its ``[num, dim]`` table (its
  table cast as ``embedding`` says under ``auto_cast``: the AMP dtype
  under O2).
* :class:`Dropout` is upscale-in-train dropout drawing from its own
  ``torch.Generator``.

Random initialisation (normal(0, 0.02) weights, zero biases, unit norm
scales) draws from a ``torch.Generator`` on the parameters' device; pass
``generator=None`` to leave the storage uninitialised for a load.
"""
from __future__ import annotations

import sys

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "Identity", "Flatten",
           "INIT_STD"]

INIT_STD = 0.02


def _amp_cast(op_name, *tensors):
    """The package's ``amp_cast`` (``paddle_tpu_torch.nn.layer.amp_cast``),
    read when called: every layer casts through it."""
    return sys.modules[__package__].amp_cast(op_name, *tensors)


def _param(shape, device, dtype, generator, fill=None, std=INIT_STD):
    """A trainable parameter: normal(0, ``std``) or ``fill`` drawn from
    ``generator``, uninitialised when ``generator`` is None."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if generator is not None:
        if fill is None:
            t.normal_(0.0, std, generator=generator)
        else:
            t.fill_(fill)
    return nn.Parameter(t)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = _param((in_features, out_features), device, dtype,
                             generator)
        self.bias = _param((out_features,), device, dtype, generator,
                           fill=0.0) if bias else None

    def forward(self, x):
        x, w, b = _amp_cast("linear", x, self.weight, self.bias)
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.addmm(b, x2, w) if b is not None else torch.matmul(x2, w)
        return y.reshape(*x.shape[:-1], y.shape[-1])


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = _param((num_embeddings, embedding_dim), device, dtype,
                             generator)

    def forward(self, ids):
        (w,) = _amp_cast("embedding", self.weight)
        return w[ids.long()]


class Dropout(nn.Module):
    """``Dropout(p, generator=None)``: :func:`~..functional.dropout` in
    training mode, the identity in eval mode."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(nn.Module):
    """Flattens axes ``start_axis`` .. ``stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)
