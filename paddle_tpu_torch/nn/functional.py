"""Functional ops of the serving path."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x, approximate=True):
    """GELU; ``approximate=True`` is the tanh form the GPT MLP uses
    (``jax.nn.gelu(approximate=True)`` in the JAX package)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
