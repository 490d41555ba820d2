"""The port's operators (``paddle_tpu/ops/__init__.py``): the tensor op
surface as plain functions over ``torch.Tensor`` with the JAX package's
names, signatures, defaults and output dtypes (``creation``, ``math``,
``manipulation``, ``logic``, ``search``, ``linalg``, ``random_ops``,
the registry's ``generated_root`` and the ``op_`` family in ``inplace``),
plus ``einsum`` and ``one_hot``. No method is bound onto ``torch.Tensor``.

``kernels`` holds the hand-written Hopper kernels.
"""
from __future__ import annotations

import torch

from . import (creation, generated_root, inplace, logic, manipulation,
               math, random_ops, search)
from . import linalg as _linalg
from ._common import amp as _amp

__all__ = ["einsum", "one_hot"]
for _m in (creation, logic, manipulation, math, _linalg, search, random_ops,
           generated_root, inplace):
    for _n in _m.__all__:
        globals()[_n] = getattr(_m, _n)
        if _n not in __all__:
            __all__.append(_n)


def einsum(equation, *operands, name=None):
    ts = operands[0] if len(operands) == 1 and isinstance(
        operands[0], (list, tuple)) else operands
    return torch.einsum(equation, *_amp("einsum", *ts))


def one_hot(x, num_classes, name=None):
    """float64 one-hot rows (``jax.nn.one_hot``'s default float under x64;
    an index outside [0, num_classes) gives a zero row)."""
    idx = x.to(torch.long)
    ok = (idx >= 0) & (idx < num_classes)
    hot = torch.nn.functional.one_hot(torch.where(ok, idx, 0), num_classes)
    return (hot * ok.unsqueeze(-1)).to(torch.float64)


del _m, _n
