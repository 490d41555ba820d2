"""Activation layers (``paddle_tpu/nn/layer/activation.py:14-67``) over
:mod:`..functional.activation`: every layer of the JAX package's
``_simple`` table (positional arguments map onto the functional's
keywords after ``x``, in order) and :class:`PReLU`."""
from __future__ import annotations

import inspect

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax",
           "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU", "Hardtanh",
           "Hardsigmoid", "Hardswish", "Hardshrink", "Softshrink",
           "Tanhshrink", "Softplus", "Softsign", "Mish", "LogSigmoid", "Silu",
           "Swish", "PReLU", "GLU"]


def _simple(name, fn_name):
    """A layer class that calls ``F.<fn_name>(x, **its arguments)``."""
    def __init__(self, *args, name=None, **kw):  # noqa: N807
        Layer.__init__(self)
        keys = list(inspect.signature(getattr(F, fn_name)).parameters)[1:]
        self._kw = dict(zip(keys, args), **kw)

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kw)

    return type(name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "__module__": __name__})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
GELU = _simple("GELU", "gelu")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Softmax = _simple("Softmax", "softmax")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
ELU = _simple("ELU", "elu")
SELU = _simple("SELU", "selu")
CELU = _simple("CELU", "celu")
Hardtanh = _simple("Hardtanh", "hardtanh")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Hardshrink = _simple("Hardshrink", "hardshrink")
Softshrink = _simple("Softshrink", "softshrink")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Softplus = _simple("Softplus", "softplus")
Softsign = _simple("Softsign", "softsign")
Mish = _simple("Mish", "mish")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
GLU = _simple("GLU", "glu")


class PReLU(Layer):
    """A trainable slope ``weight`` of ``num_parameters`` entries (one, or
    one a channel), filled with ``init`` unless ``weight_attr`` names
    another initializer."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
