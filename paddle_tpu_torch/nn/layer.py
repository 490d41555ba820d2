"""Layers of the serving path: Linear, Embedding, LayerNorm.

Parameters keep the JAX package's names and layouts so weights carry over
one to one (``convert.params_from_paddle_tpu``):

* :class:`Linear` keeps Paddle's ``[in, out]`` weight layout and computes
  ``x @ W + b`` — no transpose at load time. The product is a plain
  ``torch.addmm``/``torch.matmul``: the JAX package leaves these products
  to XLA outside any Pallas kernel.
* :class:`Embedding` is a row gather of its ``[num, dim]`` table.
* :class:`LayerNorm` calls the ``layer_norm`` kernel wrapper (Triton on the
  card, the plain version on the CPU).

Random initialisation (normal(0, 0.02) weights, zero biases, unit norm
scales) draws from a ``torch.Generator`` on the parameters' device; pass
``generator=None`` to leave the storage uninitialised for a load.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import layer_norm

__all__ = ["Linear", "Embedding", "LayerNorm", "INIT_STD"]

INIT_STD = 0.02


def _param(shape, device, dtype, generator, fill=None):
    t = torch.empty(shape, device=device, dtype=dtype)
    if generator is not None:
        if fill is None:
            t.normal_(0.0, INIT_STD, generator=generator)
        else:
            t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = _param((in_features, out_features), device, dtype,
                             generator)
        self.bias = _param((out_features,), device, dtype, generator,
                           fill=0.0) if bias else None

    def forward(self, x):
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.addmm(self.bias, x2, self.weight) if self.bias is not None \
            else torch.matmul(x2, self.weight)
        return y.reshape(*x.shape[:-1], y.shape[-1])


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = _param((num_embeddings, embedding_dim), device, dtype,
                             generator)

    def forward(self, ids):
        return self.weight[ids.long()]


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
        return layer_norm(x, self.weight, self.bias, self.epsilon)
