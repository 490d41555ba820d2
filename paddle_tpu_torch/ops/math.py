"""Elementwise ``add`` and ``multiply`` (``paddle_tpu/ops/math.py:34``;
``Tensor.__add__`` / ``__mul__`` dispatch the same op names): torch's
``+`` and ``*`` after the tensor operands are cast as ``auto_cast`` casts
those ops (neither is on a list, so O2 gives them the AMP dtype; a Python
number is left as it is). The models' residual adds go through
:func:`add`, so under O2 their streams stay 16-bit."""
from __future__ import annotations

import torch

from ..amp import amp_cast

__all__ = ["add", "multiply"]


def _cast(op_name, x, y):
    if torch.is_tensor(y):
        return amp_cast(op_name, x, y)
    return amp_cast(op_name, x)[0], y


def add(x, y):
    x, y = _cast("add", x, y)
    return x + y


def multiply(x, y):
    x, y = _cast("multiply", x, y)
    return x * y
