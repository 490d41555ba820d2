"""``to_tensor`` (``paddle_tpu/core/tensor.py:456``), ``Tensor`` and
``Parameter`` (``:427-440``).

The port's tensors are ``torch.Tensor`` itself; no Paddle method is bound
onto torch's class (``transpose(perm)`` or ``sum(axis=...)`` would change
torch's own methods for every module). ``stop_gradient=False`` is
``requires_grad=True``.

A :class:`Parameter` is a ``torch.nn.Parameter`` that carries the JAX
package's attributes: ``trainable`` (``requires_grad``), ``optimize_attr``
(``{"learning_rate": scale}``, which the optimizers multiply into the
parameter's rate), ``regularizer``, ``need_clip``, ``is_distributed`` and
``name``. To torch it stays a parameter like any other: its storage, its
``data_ptr`` (which the kernels and CUDA graphs hold), ``state_dict`` and
``torch.save`` see no difference, and its arithmetic returns plain
tensors.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..device import resolve_device
from .dtype import convert_dtype, get_default_dtype

__all__ = ["Tensor", "Parameter", "to_tensor", "as_array"]

Tensor = torch.Tensor

_param_counter = [0]


class Parameter(torch.nn.Parameter):
    """``Parameter(data, dtype=None, trainable=True, name=None)``: a
    trainable tensor made from ``data`` (a tensor, kept on its device, or
    array-like data, put on the current device). An unnamed parameter is
    named ``generated_tensor_<n>``, as the JAX package names it."""

    def __new__(cls, data=None, dtype=None, trainable=True, name=None):
        t = data.detach() if torch.is_tensor(data) else as_array(data)
        dt = convert_dtype(dtype)
        if dt is not None and t.dtype != dt:
            t = t.to(dt)
        return super().__new__(cls, t, bool(trainable))

    def __init__(self, data=None, dtype=None, trainable=True, name=None):
        if name is None:
            _param_counter[0] += 1
            name = f"generated_tensor_{_param_counter[0]}"
        self._name = name
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False

    # torch's ``Tensor.name`` is a read-only slot; a parameter's is its own
    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         trainable=self.requires_grad, name=self._name)
        memo[id(self)] = out
        for key, value in self.__dict__.items():
            out.__dict__[key] = copy.deepcopy(value, memo)
        return out


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
