"""AUTO-GENERATED by paddle_tpu_torch/ops/gen.py from ops.yaml — DO NOT EDIT.

Regenerate with: python -m paddle_tpu_torch.ops.gen
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..core.dtype import float_of as _fl
from ..core.dtype import is_floating
from ..core.tensor import as_array
from ._common import amp as _amp
from ._common import moved_last as _moved_last


def _t(x, like=None):
    if torch.is_tensor(x):
        return x
    return as_array(x, device=None if like is None else like.device)


def _check_float(op, *ts):
    for t in ts:
        if not is_floating(t.dtype):
            raise TypeError(
                f"(op:{op}) expects floating-point input, got {t.dtype}")


def _quantile(fn, x, q, axis, keepdim, interpolation):
    if x.dtype in (torch.float16, torch.bfloat16):
        # torch's quantile takes f32 / f64 only: compute in f32
        return _quantile(fn, x.float(), q, axis, keepdim,
                         interpolation).to(x.dtype)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    flat, keep = _moved_last(x, axis)
    out = fn(flat, qt, dim=-1, interpolation=interpolation)
    return out.reshape(tuple(qt.shape) + tuple(keep)) if keepdim else out


def _right_shift(x, y, arithmetic):
    if arithmetic:
        return torch.bitwise_right_shift(x, y)
    bits = torch.iinfo(x.dtype).bits
    y = y.to(x.dtype)
    mask = torch.bitwise_left_shift(torch.ones_like(x), bits - y) - 1
    return torch.where(y == 0, x, torch.bitwise_right_shift(x, y) & mask)


def lu(x, pivot=True, get_infos=False, name=None):
    """LU factorization; pivots are 1-indexed like the reference (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('lu', x)
    x, = _amp('lu', x)
    lu_mat, piv = torch.linalg.lu_factor(x)
    return lu_mat, piv.to(torch.int32)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """unpack lu_factor output into P, L, U (reference: paddle.linalg.lu_unpack); batched via vmap over leading dims (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('lu_unpack', x, y)
    P, L, U = torch.lu_unpack(x, y.to(torch.int32))
    return P, L, U


def cond(x, p=None, name=None):
    """cond (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('cond', x)
    x, = _amp('cond', x)
    return torch.linalg.cond(x, p)


def matrix_exp(x, name=None):
    """matrix_exp (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('matrix_exp', x)
    x, = _amp('matrix_exp', x)
    return torch.linalg.matrix_exp(x)


def householder_product(x, tau, name=None):
    """product of Householder reflectors (reference: paddle.linalg.householder_product); batched via vmap (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    tau = _t(tau, x)
    _check_float('householder_product', x, tau)
    x, tau, = _amp('householder_product', x, tau)
    return torch.linalg.householder_product(x, tau)


def cross(x, y, axis=None, name=None):
    """cross (generated; reference: python/paddle/tensor/linalg.py cross)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('cross', x, y)
    return torch.linalg.cross(x, y, dim=-1 if axis is None else axis)


def dot(x, y, name=None):
    """1-D/2-D row-wise dot product (paddle semantics) (generated; reference: python/paddle/tensor/linalg.py dot)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('dot', x, y)
    return torch.sum(x * y, dim=-1)


__all__ = ['lu', 'lu_unpack', 'cond', 'matrix_exp', 'householder_product', 'cross', 'dot']
