"""Activations (``paddle_tpu/nn/functional/activation.py``): each casts
its input under ``auto_cast`` by its JAX op name and keeps the input's
type. ``softplus``, ``softmax`` and ``log_softmax`` are on the black list
(f32); no other is on a list, so O2 gives it the AMP dtype and O1 leaves
it. Each is the JAX expression written with torch ops, so
``hardsigmoid``'s default slope is ``0.1666667`` (not torch's 1/6) and
``hardswish`` is ``x * clip(x + 3, 0, 6) / 6``. At a tie the gradients
are JAX's: at an input of exactly 0 (or a bound) half the gradient
passes, as ``jnp.maximum`` splits it, where ``torch.relu`` passes none
and ``torch.clamp`` all of it. ``relu`` is ``maximum(x, 0)`` with that
gradient as ``heaviside(x, 0.5)``; the clips are ``minimum(maximum(x,
lo), hi)`` (``jnp.clip``) against 0-d tensors of the input's type.
``gumbel_softmax`` is not ported (it waits for the port of
``random_ops``)."""
from __future__ import annotations

import torch

from .common import _amp_cast

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "silu", "swish", "tanh",
    "leaky_relu", "elu", "selu", "celu", "hardtanh", "hardsigmoid",
    "hardswish", "hardshrink", "softshrink", "tanhshrink", "softplus",
    "softsign", "mish", "log_sigmoid", "prelu", "glu", "softmax",
    "log_softmax",
]

_F = torch.nn.functional

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(dtype):
    """A paddle dtype name (``"float32"``, ``"paddle.float32"``) or a torch
    dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype).replace("paddle.", "")]


def _clip(x, lo=None, hi=None):
    """``jnp.clip``'s ``minimum(maximum(x, lo), hi)``: its gradient at a
    tie is split in half, as JAX's."""
    if lo is not None:
        x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype))
    return x


class _Relu(torch.autograd.Function):
    """``maximum(x, 0)`` with JAX's gradient, ``heaviside(x, 0.5)`` of the
    incoming one (half of it at an input of exactly 0), in two passes of
    the backward where ``torch.maximum``'s takes five; in place on ``x``
    for ``relu_``."""

    @staticmethod
    def forward(ctx, x, inplace):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(
                torch.heaviside(x, torch.tensor(0.5, dtype=x.dtype)))
        if inplace:
            ctx.mark_dirty(x)
            return torch.relu_(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * w, None


def relu(x, name=None):
    (x,) = _amp_cast("relu", x)
    return _Relu.apply(x, False)


def relu_(x, name=None):
    """In place on ``x``, in its own type (the JAX package rebinds ``x``
    to ``relu(x)``), with ``relu``'s gradient."""
    return _Relu.apply(x, True)


def relu6(x, name=None):
    (x,) = _amp_cast("relu6", x)
    return _clip(x, 0.0, 6.0)


def gelu(x, approximate=False, name=None):
    """GELU (``activation.py:35``): the exact erf form by default, the tanh
    form with ``approximate=True`` (the GPT MLP's)."""
    (x,) = _amp_cast("gelu", x)
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    (x,) = _amp_cast("sigmoid", x)
    return torch.sigmoid(x)


def silu(x, name=None):
    (x,) = _amp_cast("silu", x)
    return _F.silu(x)


def swish(x, name=None):
    (x,) = _amp_cast("swish", x)
    return _F.silu(x)


def tanh(x, name=None):
    (x,) = _amp_cast("tanh", x)
    return torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = _amp_cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = _amp_cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    (x,) = _amp_cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = _amp_cast("celu", x)
    return _F.celu(x, alpha)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    (x,) = _amp_cast("hardtanh", x)
    return _clip(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = _amp_cast("hardsigmoid", x)
    return _clip(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    (x,) = _amp_cast("hardswish", x)
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def hardshrink(x, threshold=0.5, name=None):
    (x,) = _amp_cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    (x,) = _amp_cast("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    (x,) = _amp_cast("tanhshrink", x)
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = _amp_cast("softplus", x)
    bx = x * beta
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, torch.zeros_like(bx)) / beta)


def softsign(x, name=None):
    (x,) = _amp_cast("softsign", x)
    return x / (1 + x.abs())


def mish(x, name=None):
    (x,) = _amp_cast("mish", x)
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def log_sigmoid(x, name=None):
    (x,) = _amp_cast("log_sigmoid", x)
    return _F.logsigmoid(x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x >= 0, x, w x)``: one slope, or one a channel along the
    channel axis of ``data_format`` (``activation.py:116-129``)."""
    x, weight = _amp_cast("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape = [1] * x.dim()
        shape[axis] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def glu(x, axis=-1, name=None):
    (x,) = _amp_cast("glu", x)
    lhs, rhs = torch.chunk(x, 2, dim=axis)
    return lhs * torch.sigmoid(rhs)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.log_softmax(x, dim=axis)
