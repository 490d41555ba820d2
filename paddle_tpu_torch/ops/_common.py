"""Helpers the op modules share: AMP casts under the JAX op names,
Python-scalar promotion as the JAX package's weak types give it, and
axis / shape / int normalisation."""
from __future__ import annotations

import builtins
import math

import numpy as np
import torch

from ..amp import amp_cast
from ..amp.auto_cast import _state as _amp_state
from ..core.dtype import float64
from ..core.tensor import as_array

__all__ = ["amp", "scalar_operand", "device_scalar", "binary_operands",
           "axis_arg", "ints", "shape_arg", "tensor_of", "moved_last"]


def amp(op_name, *xs):
    """``xs`` with each floating tensor cast as ``auto_cast`` casts the
    JAX op ``op_name`` (``core/dispatch.py:297-299``); anything that is not
    a tensor passes as it is. -> a tuple."""
    if not _amp_state.enabled:
        return xs
    idx = [i for i, x in enumerate(xs) if torch.is_tensor(x)]
    if not idx:
        return xs
    cast = amp_cast(op_name, *(xs[i] for i in idx))
    out = list(xs)
    for i, c in zip(idx, cast):
        out[i] = c
    return tuple(out)


def scalar_operand(s, like):
    """A Python number (or a 0-d tensor, read as JAX reads ``.item()``) as
    a 0-d tensor beside the tensor ``like``, in the dtype JAX's weak
    typing gives the pair: ``like``'s when the number's kind fits in it
    (an int beside any number, a float beside a float), else float64 (a
    float beside an integer tensor) or int64 (an int beside bool).

    The number lives on ``like``'s device (:func:`device_scalar`): no
    host-to-device copy, so no stream sync and nothing that breaks a
    ``jit.to_static`` capture. A 0-d tensor on ``like``'s device is cast
    there; one on the CPU is read on the host, which syncs nothing."""
    if torch.is_tensor(s):
        if s.device == like.device:
            return s.detach().to(_weak_dtype(_kind(s.dtype), like))
        s = s.item()
    kind = type(s)
    if kind not in _KINDS:
        if isinstance(s, np.generic):
            s = s.item()
        kind = next((k for k in _KINDS if isinstance(s, k)), None)
        if kind is None:
            return as_array(s, device=like.device)
    return device_scalar(s, _weak_dtype(kind, like), like.device)


_KINDS = (builtins.bool, int, float, complex)

# device_scalar's tensors, by (type, value, sign, dtype, device)
_SCALARS = {}
_SCALARS_MAX = 4096


def device_scalar(s, dtype, device):
    """A 0-d ``dtype`` tensor holding the number ``s`` on ``device``,
    filled there once (``torch.full``) and reused, so a number operand
    costs a dict lookup. While a CUDA graph is captured the fill is made
    afresh and captured with it: a cached tensor could be dropped from
    the cache while the graph still reads its memory. The cache is
    emptied after a device sync when it reaches ``_SCALARS_MAX`` values
    (an eager op on another stream may still read a dropped tensor)."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return torch.full((), s, dtype=dtype, device=device)
    if isinstance(s, complex) or s != s:
        return torch.full((), s, dtype=dtype, device=device)
    key = (type(s), s, math.copysign(1.0, s), dtype, device)
    t = _SCALARS.get(key)
    if t is None:
        if len(_SCALARS) >= _SCALARS_MAX:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            _SCALARS.clear()
        t = _SCALARS[key] = torch.full((), s, dtype=dtype, device=device)
    return t


def _kind(dtype):
    """The Python type whose weak typing a tensor of ``dtype`` stands
    for."""
    if dtype == torch.bool:
        return builtins.bool
    if dtype.is_complex:
        return complex
    return float if dtype.is_floating_point else int


def _weak_dtype(kind, like):
    if kind is builtins.bool:
        return like.dtype
    if kind is int:
        return torch.int64 if like.dtype == torch.bool else like.dtype
    if kind is float:
        return like.dtype if (like.is_floating_point() or like.is_complex()) \
            else float64
    return torch.complex128 if like.dtype in (torch.float64,
                                              torch.complex128) \
        else torch.complex64


def binary_operands(x, y):
    """Two operands of a binary op as tensors: a Python number takes the
    dtype :func:`scalar_operand` gives it, and an integer tensor beside a
    float number becomes float64 (JAX's ``int64 + weak float``)."""
    if not torch.is_tensor(x) and not torch.is_tensor(y):
        x = as_array(x)
    if torch.is_tensor(x) and torch.is_tensor(y):
        return x, y
    if torch.is_tensor(x):
        y = scalar_operand(y, x)
        if y.dtype == float64 and not x.is_floating_point():
            x = x.to(float64)
        return x, y
    x = scalar_operand(x, y)
    if x.dtype == float64 and not y.is_floating_point():
        y = y.to(float64)
    return x, y


def tensor_of(x, like=None):
    """``x`` as a tensor (on ``like``'s device when given)."""
    if torch.is_tensor(x):
        return x
    return as_array(x, device=None if like is None else like.device)


def axis_arg(axis):
    """None, an int, a list/tuple or a tensor of axes -> None, an int or a
    tuple of ints."""
    if axis is None:
        return None
    if torch.is_tensor(axis):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def ints(v):
    """An int, a tensor, or a list holding ints and 0-d tensors -> an int
    or a tuple of ints."""
    if type(v) in (list, tuple) and all(type(i) is int for i in v):
        return tuple(v)
    if torch.is_tensor(v):
        return tuple(int(i) for i in v.reshape(-1).tolist()) if v.ndim \
            else int(v.item())
    if isinstance(v, (int, np.integer)):
        return int(v)
    return tuple(int(i.item()) if torch.is_tensor(i) else int(i) for i in v)


def shape_arg(shape):
    """A shape given as an int, a list (of ints or 0-d tensors) or a
    tensor -> a tuple of ints."""
    s = ints(shape)
    return (s,) if isinstance(s, int) else s


def moved_last(x, axis):
    """``x`` with the axes of ``axis`` (all of them when None) flattened
    into one last axis -> (that tensor, ``x``'s shape with 1 where the
    reduced axes were: the ``keepdim`` shape)."""
    ax = axis_arg(axis)
    dims = tuple(range(x.ndim)) if ax is None else \
        (ax,) if isinstance(ax, int) else ax
    dims = tuple(sorted(d % x.ndim for d in dims))
    rest = [d for d in range(x.ndim) if d not in dims]
    flat = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    keep = [1 if d in dims else x.shape[d] for d in range(x.ndim)]
    return flat, keep
