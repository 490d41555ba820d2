"""Comparison, logical and bitwise ops (``paddle_tpu/ops/logic.py``): no
AMP cast (JAX computes them outside ``apply``); a Python number meets a
tensor as JAX's weak types would."""
from __future__ import annotations

import torch

from ._common import binary_operands

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "bitwise_and", "bitwise_or", "bitwise_xor", "logical_not",
           "bitwise_not", "isclose", "allclose", "equal_all", "is_empty",
           "is_tensor"]


def _cmp(name, fn):
    def op(x, y, name=None):
        return fn(*binary_operands(x, y))
    op.__name__ = op.__qualname__ = name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return torch.logical_not(x)


def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


def _promoted(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float64
    return x.to(dt), y.to(dt)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*_promoted(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor (read on the device, no host sync)."""
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y, name=None):
    if tuple(x.shape) != tuple(y.shape):
        return torch.full((), False, device=x.device)
    return torch.eq(x, y).all()


def is_empty(x, name=None):
    return torch.full((), x.numel() == 0, device=x.device)


def is_tensor(x):
    return torch.is_tensor(x)
