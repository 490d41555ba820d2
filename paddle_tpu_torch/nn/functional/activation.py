"""Activations (``paddle_tpu/nn/functional/activation.py``): each casts
its input under ``auto_cast`` by its JAX op name (none is on a list, so O2
gives it the AMP dtype and O1 leaves it) and keeps the input's type."""
from __future__ import annotations

import torch

from .common import _amp_cast

__all__ = ["relu", "relu6", "gelu", "sigmoid", "silu", "tanh"]


def relu(x):
    (x,) = _amp_cast("relu", x)
    return torch.relu(x)


def relu6(x):
    (x,) = _amp_cast("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False):
    """GELU (``activation.py:35``): the exact erf form by default, the tanh
    form with ``approximate=True`` (the GPT MLP's)."""
    (x,) = _amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def sigmoid(x):
    (x,) = _amp_cast("sigmoid", x)
    return torch.sigmoid(x)


def silu(x):
    (x,) = _amp_cast("silu", x)
    return torch.nn.functional.silu(x)


def tanh(x):
    (x,) = _amp_cast("tanh", x)
    return torch.tanh(x)
