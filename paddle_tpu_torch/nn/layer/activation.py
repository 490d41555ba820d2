"""Activation layers (``paddle_tpu/nn/layer/activation.py``) over
:mod:`..functional.activation`."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "ReLU6", "Tanh", "Sigmoid", "GELU", "Silu"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return F.relu6(x)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return F.sigmoid(x)


class GELU(nn.Module):
    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Silu(nn.Module):
    def forward(self, x):
        return F.silu(x)
