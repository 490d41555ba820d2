"""``concat`` (``paddle_tpu/ops/manipulation.py:81``): ``torch.cat``
after the tensors are cast as ``auto_cast`` casts the JAX op ``concat``
(on neither list, so O2 gives them the AMP dtype and O1 leaves them).
The vision zoo's DenseNet, Inception, ShuffleNet and SqueezeNet blocks
join their branches with it."""
from __future__ import annotations

import torch

from ..amp import amp_cast

__all__ = ["concat"]


def concat(x, axis=0, name=None):
    """Join the tensors of ``x`` along ``axis`` (an int or a one-element
    tensor)."""
    tensors = amp_cast("concat", *x)
    if torch.is_tensor(axis):
        axis = int(axis.item())
    return torch.cat(tensors, dim=int(axis))
