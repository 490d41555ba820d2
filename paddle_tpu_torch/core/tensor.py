"""``to_tensor`` (``paddle_tpu/core/tensor.py:456``) and ``Tensor``.

The port's tensors are ``torch.Tensor`` itself; no Paddle method is bound
onto torch's class (``transpose(perm)`` or ``sum(axis=...)`` would change
torch's own methods for every module). ``stop_gradient=False`` is
``requires_grad=True``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .dtype import convert_dtype, get_default_dtype

__all__ = ["Tensor", "to_tensor", "as_array"]

Tensor = torch.Tensor


def as_array(data, dtype=None, device=None) -> torch.Tensor:
    """``data`` (a tensor, numpy array, Python scalar or nested list) as a
    tensor on ``device`` (the current device when None), with the JAX
    package's dtype rules: a float64 numpy array, a Python float or a
    list of them takes the default dtype, an int becomes int64, a bool
    bool; any other numpy dtype stays. Numpy data is copied; a tensor
    that needs no change is returned as it is."""
    dev = resolve_device(device)
    dt = convert_dtype(dtype)
    if torch.is_tensor(data):
        return data.to(device=dev, dtype=dt)
    arr = np.asarray(data)
    if dt is None and arr.dtype == np.float64:
        dt = get_default_dtype()
    if arr.dtype == object:
        raise TypeError(f"to_tensor cannot take {type(data).__name__} "
                        f"data of mixed types")
    t = torch.tensor(arr) if arr.ndim \
        else torch.tensor(arr.item(), dtype=convert_dtype(arr.dtype))
    return t.to(device=dev, dtype=dt)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new tensor (a copy, also of a tensor) on
    ``place`` (the current device when None) with the JAX package's
    dtype rules (:func:`as_array`); ``stop_gradient=False`` records
    gradients."""
    src = data.detach() if torch.is_tensor(data) else data
    t = as_array(src, dtype, place)
    if t is src or (torch.is_tensor(src) and t.data_ptr() == src.data_ptr()):
        t = t.clone()
    if not stop_gradient:
        t.requires_grad_(True)
    return t
