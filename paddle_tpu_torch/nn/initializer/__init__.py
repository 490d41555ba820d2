"""Parameter initializers (``paddle_tpu/nn/initializer/__init__.py``;
reference: python/paddle/nn/initializer).

An initializer is a callable ``init(shape, dtype=None, *, device=None,
generator=None)`` returning a new ``torch.Tensor``: the JAX package's
``(shape, dtype)`` with the port's keyword-only extras. A random one
draws in f32 and casts to ``dtype`` (f32 when None), as the JAX package
does, on ``device`` (the current device when None: the card unless
``set_device("cpu")`` or ``device="cpu"``), from ``generator``, else from
the framework generator of that device (``core/random.py``), so
``paddle.seed(s)`` makes a model's initialisation repeat. The streams
differ bit for bit from JAX's keys; the distributions are the same. Fans
follow ``_compute_fans`` (``nn/initializer/initializer.py:74``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as _random
from ...core.dtype import convert_dtype
from ...device import resolve_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "calculate_gain", "set_global_initializer",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """``paddle.nn.initializer.set_global_initializer``: the initializers
    ``Layer.create_parameter`` takes for weights and biases whose
    ``ParamAttr`` names none, ahead of the layer's own default; ``None``
    drops them."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _global_initializer(is_bias):
    return _global_bias_init if is_bias else _global_weight_init


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of ``nonlinearity``
    (``paddle.nn.initializer.calculate_gain``)."""
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3,
        "relu": math.sqrt(2.0), "selu": 3.0 / 4,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity in recommended:
        return recommended[nonlinearity]
    raise ValueError(f"unsupported nonlinearity: {nonlinearity}")


def _compute_fans(shape):
    """``(fan_in, fan_out)`` of a parameter of ``shape``: a Linear weight
    ``[in, out]`` gives ``(in, out)``, a convolution weight ``[out, in,
    *k]`` gives ``(in * prod(k), out * prod(k))``."""
    if not shape:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        dtype = convert_dtype(dtype) or torch.float32
        device = resolve_device(device)
        if generator is None:
            generator = _random.generator(device)
        return self._generate(tuple(int(s) for s in shape), dtype, device,
                              generator)

    def _generate(self, shape, dtype, device, generator):
        raise NotImplementedError

    @staticmethod
    def _empty(shape, device):
        return torch.empty(shape, dtype=torch.float32, device=device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, dtype, device, generator):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device, generator):
        return self._empty(shape, device).normal_(
            self.mean, self.std, generator=generator).to(dtype)


class TruncatedNormal(Initializer):
    """Normal truncated to ``[mean + a * std, mean + b * std]`` (default
    ``a = -2``, ``b = 2``), drawn by inverting the normal CDF over the
    uniform draws between the bounds' CDF values."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _generate(self, shape, dtype, device, generator):
        lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (self.a, self.b))
        base = self._empty(shape, device).uniform_(lo, hi,
                                                   generator=generator)
        base = torch.erfinv(base).mul_(math.sqrt(2.0)).clamp_(self.a, self.b)
        return base.mul_(self.std).add_(self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, dtype, device, generator):
        return self._empty(shape, device).uniform_(
            self.low, self.high, generator=generator).to(dtype)


class _Fans(Initializer):
    def _fans(self, shape):
        f_in, f_out = _compute_fans(shape)
        f_in = self.fan_in if self.fan_in is not None else f_in
        fan_out = getattr(self, "fan_out", None)
        return f_in, (fan_out if fan_out is not None else f_out)

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return calculate_gain(self.nonlinearity, self.negative_slope)
        return calculate_gain(self.nonlinearity)


class XavierNormal(_Fans):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device, generator):
        f_in, f_out = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (f_in + f_out))
        return self._empty(shape, device).normal_(
            0.0, std, generator=generator).to(dtype)


class XavierUniform(_Fans):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device, generator):
        f_in, f_out = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (f_in + f_out))
        return self._empty(shape, device).uniform_(
            -limit, limit, generator=generator).to(dtype)


class KaimingNormal(_Fans):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device, generator):
        std = self._gain() / math.sqrt(self._fans(shape)[0])
        return self._empty(shape, device).normal_(
            0.0, std, generator=generator).to(dtype)


class KaimingUniform(_Fans):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device, generator):
        limit = self._gain() * math.sqrt(3.0 / self._fans(shape)[0])
        return self._empty(shape, device).uniform_(
            -limit, limit, generator=generator).to(dtype)


class Assign(Initializer):
    """The given value (a tensor, numpy array or nested list), reshaped to
    the parameter's shape; a copy, never the value's own storage."""

    def __init__(self, value):
        self.value = value

    def _generate(self, shape, dtype, device, generator):
        v = self.value
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
        out = v.to(device=device, dtype=dtype)
        if out.data_ptr() == v.data_ptr():
            out = out.clone()
        return out.reshape(shape) if tuple(out.shape) != shape else out


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, dtype, device, generator):
        if len(shape) < 2:
            raise ValueError("Orthogonal initializer needs >=2 dims")
        rows, cols = shape[0], int(np.prod(shape[1:]))
        a = self._empty((max(rows, cols), min(rows, cols)), device).normal_(
            generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


# Paddle also exposes these under their op-style aliases
ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
