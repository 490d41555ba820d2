"""Layers of the port: Linear, Embedding, LayerNorm, RMSNorm, Dropout.

Parameters keep the JAX package's names and layouts so weights carry over
one to one (``convert.params_from_paddle_tpu``), and are trainable
(``requires_grad=True``); the serving engine runs its rounds under
``torch.no_grad``.

* :class:`Linear` keeps Paddle's ``[in, out]`` weight layout and computes
  ``x @ W + b`` — no transpose at load time. The product is a plain
  ``torch.addmm``/``torch.matmul``: the JAX package leaves these products
  to XLA outside any Pallas kernel. Under ``auto_cast`` O1 it computes in
  the AMP dtype (``linear`` is on the white list).
* :class:`Embedding` is a row gather of its ``[num, dim]`` table (its
  table cast as ``embedding`` says under ``auto_cast``: bf16 under O2).
* :class:`LayerNorm` runs :class:`~..ops.kernels.LayerNormFunction`: the
  ``layer_norm`` kernel wrapper forward (Triton on the card, the plain
  version on the CPU), the plain gradient backward; in f32 under
  ``auto_cast`` (``layer_norm`` is on the black list).
* :class:`RMSNorm` (weight only) runs :func:`~.functional.rms_norm`, the
  ``rms_norm`` kernel wrapper forward in the same way.
* :class:`Dropout` is upscale-in-train dropout drawing from its own
  ``torch.Generator``.

Random initialisation (normal(0, 0.02) weights, zero biases, unit norm
scales) draws from a ``torch.Generator`` on the parameters' device; pass
``generator=None`` to leave the storage uninitialised for a load.
"""
from __future__ import annotations

import torch
from torch import nn

from ..amp import amp_cast
from ..ops.kernels import LayerNormFunction
from . import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "INIT_STD"]

INIT_STD = 0.02


def _param(shape, device, dtype, generator, fill=None):
    t = torch.empty(shape, device=device, dtype=dtype)
    if generator is not None:
        if fill is None:
            t.normal_(0.0, INIT_STD, generator=generator)
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
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
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
        (w,) = amp_cast("embedding", self.weight)
        return w[ids.long()]


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
        x, w, b = amp_cast("layer_norm", x, self.weight, self.bias)
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


class Dropout(nn.Module):
    """``Dropout(p, generator=None)``: :func:`~.functional.dropout` in
    training mode, the identity in eval mode."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)
