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


def abs(x, name=None):
    """abs (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('abs', x)
    return torch.abs(x)


def neg(x, name=None):
    """neg (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('neg', x)
    return torch.neg(x)


def exp(x, name=None):
    """exp (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('exp', x)
    return torch.exp(_fl(x))


def expm1(x, name=None):
    """expm1 (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('expm1', x)
    return torch.expm1(_fl(x))


def log(x, name=None):
    """log (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('log', x)
    return torch.log(_fl(x))


def log2(x, name=None):
    """log2 (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('log2', x)
    return torch.log2(_fl(x))


def log10(x, name=None):
    """log10 (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('log10', x)
    return torch.log10(_fl(x))


def log1p(x, name=None):
    """log1p (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('log1p', x)
    return torch.log1p(_fl(x))


def sqrt(x, name=None):
    """sqrt (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('sqrt', x)
    return torch.sqrt(_fl(x))


def rsqrt(x, name=None):
    """rsqrt (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('rsqrt', x)
    return torch.rsqrt(_fl(x))


def square(x, name=None):
    """square (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('square', x)
    return torch.square(x)


def sin(x, name=None):
    """sin (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('sin', x)
    return torch.sin(_fl(x))


def cos(x, name=None):
    """cos (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('cos', x)
    return torch.cos(_fl(x))


def tan(x, name=None):
    """tan (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('tan', x)
    return torch.tan(_fl(x))


def asin(x, name=None):
    """asin (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('asin', x)
    return torch.asin(_fl(x))


def acos(x, name=None):
    """acos (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('acos', x)
    return torch.acos(_fl(x))


def atan(x, name=None):
    """atan (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('atan', x)
    return torch.atan(_fl(x))


def sinh(x, name=None):
    """sinh (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('sinh', x)
    return torch.sinh(_fl(x))


def cosh(x, name=None):
    """cosh (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('cosh', x)
    return torch.cosh(_fl(x))


def tanh(x, name=None):
    """tanh (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('tanh', x)
    return torch.tanh(_fl(x))


def asinh(x, name=None):
    """asinh (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('asinh', x)
    return torch.asinh(_fl(x))


def acosh(x, name=None):
    """acosh (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('acosh', x)
    return torch.acosh(_fl(x))


def atanh(x, name=None):
    """atanh (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('atanh', x)
    return torch.atanh(_fl(x))


def ceil(x, name=None):
    """ceil (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('ceil', x)
    return torch.ceil(x)


def floor(x, name=None):
    """floor (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('floor', x)
    return torch.floor(x)


def round(x, name=None):
    """round (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('round', x)
    return torch.round(x)


def trunc(x, name=None):
    """trunc (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('trunc', x)
    return torch.trunc(x)


def frac(x, name=None):
    """frac (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('frac', x)
    return x - torch.trunc(x)


def sign(x, name=None):
    """sign (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('sign', x)
    return torch.sign(x)


def reciprocal(x, name=None):
    """reciprocal (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('reciprocal', x)
    return torch.reciprocal(_fl(x))


def sigmoid(x, name=None):
    """sigmoid (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('sigmoid', x)
    return torch.sigmoid(_fl(x))


def erf(x, name=None):
    """erf (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('erf', x)
    return torch.erf(_fl(x))


def erfinv(x, name=None):
    """erfinv (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('erfinv', x)
    return torch.erfinv(_fl(x))


def digamma(x, name=None):
    """digamma (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('digamma', x)
    return torch.digamma(_fl(x))


def lgamma(x, name=None):
    """lgamma (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('lgamma', x)
    return torch.lgamma(_fl(x))


def i0(x, name=None):
    """i0 (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('i0', x)
    return torch.i0(_fl(x))


def i0e(x, name=None):
    """i0e (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('i0e', x)
    return torch.special.i0e(_fl(x))


def i1(x, name=None):
    """i1 (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('i1', x)
    return torch.special.i1(_fl(x))


def i1e(x, name=None):
    """i1e (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('i1e', x)
    return torch.special.i1e(_fl(x))


def logit(x, eps=None, name=None):
    """logit (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('logit', x)
    return torch.log(x / (1 - x)) if eps is None else torch.log(torch.clamp(x, eps, 1 - eps) / (1 - torch.clamp(x, eps, 1 - eps)))


def angle(x, name=None):
    """angle (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('angle', x)
    return torch.angle(_fl(x))


def conj(x, name=None):
    """conj (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('conj', x)
    return torch.conj_physical(x)


def real(x, name=None):
    """real (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('real', x)
    return torch.real(x).clone() if x.is_complex() else x.clone()


def imag(x, name=None):
    """imag (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('imag', x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def deg2rad(x, name=None):
    """deg2rad (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('deg2rad', x)
    return torch.deg2rad(_fl(x))


def rad2deg(x, name=None):
    """rad2deg (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('rad2deg', x)
    return torch.rad2deg(_fl(x))


def exponent(x, name=None):
    """exponent (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('exponent', x)
    return torch.frexp(x)[1].to(x.dtype)


def quantile(x, q, axis=None, keepdim=False, interpolation='linear', name=None):
    """quantile (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('quantile', x)
    x, = _amp('quantile', x)
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation='linear', name=None):
    """nanquantile (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('nanquantile', x)
    x, = _amp('nanquantile', x)
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


def logcumsumexp(x, axis=None, name=None):
    """logcumsumexp (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('logcumsumexp', x)
    x, = _amp('logcumsumexp', x)
    return torch.logcumsumexp(x if axis is not None else x.reshape(-1), axis if axis is not None else 0)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """diff (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('diff', x)
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """trapezoid (generated; reference: python/paddle/tensor)."""
    y = _t(y)
    _check_float('trapezoid', y)
    y, = _amp('trapezoid', y)
    return torch.trapezoid(y, x, dim=axis) if x is not None else torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """cumulative_trapezoid (generated; reference: python/paddle/tensor)."""
    y = _t(y)
    _check_float('cumulative_trapezoid', y)
    y, = _amp('cumulative_trapezoid', y)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def signbit(x, name=None):
    """signbit (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('signbit', x)
    return torch.signbit(x)


def frexp(x, name=None):
    """frexp (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('frexp', x)
    return tuple(torch.frexp(x))


def ldexp(x, y, name=None):
    """ldexp (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('ldexp', x, y)
    return torch.ldexp(_fl(x), y)


def vander(x, n=None, increasing=False, name=None):
    """vander (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('vander', x)
    return torch.vander(x, N=n, increasing=increasing)


def isposinf(x, name=None):
    """isposinf (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('isposinf', x)
    return torch.isposinf(x)


def isneginf(x, name=None):
    """isneginf (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('isneginf', x)
    return torch.isneginf(x)


def isreal(x, name=None):
    """isreal (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('isreal', x)
    return torch.isreal(x)


def polygamma(x, n, name=None):
    """polygamma (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('polygamma', x)
    x, = _amp('polygamma', x)
    return torch.polygamma(n, x)


def multigammaln(x, p, name=None):
    """multigammaln (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('multigammaln', x)
    x, = _amp('multigammaln', x)
    return torch.mvlgamma(x, p)


def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """baddbmm (generated; reference: python/paddle/tensor)."""
    input = _t(input)
    x = _t(x, input)
    y = _t(y, input)
    _check_float('baddbmm', input, x, y)
    input, x, y, = _amp('baddbmm', input, x, y)
    return beta * input + alpha * torch.matmul(x, y)


def cdist(x, y, p=2.0, compute_mode='use_mm_for_euclid_dist_if_necessary', name=None):
    """cdist (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    _check_float('cdist', x, y)
    x, y, = _amp('cdist', x, y)
    d = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.clamp_min(torch.sum(d * d, -1), 0.0))
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def histc(x, bins=100, min=0.0, max=0.0, name=None):
    """histc (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('histc', x)
    return torch.histc(x.to(torch.float64), bins=bins, min=min, max=max).to(x.dtype)


def renorm(x, p, axis, max_norm, name=None):
    """renorm (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    _check_float('renorm', x)
    x, = _amp('renorm', x)
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7), torch.ones_like(norms))
    return torch.movedim(moved * scale.reshape((-1,) + (1,) * (moved.ndim - 1)), 0, axis)


def take(x, index, mode='raise', name=None):
    """gathers from the flattened input; mode 'raise' clamps under jit (XLA has no runtime bounds traps) (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    index = _t(index, x)
    x, index, = _amp('take', x, index)
    flat = x.reshape(-1)
    idx = index.to(torch.long)
    if mode == 'wrap':
        idx = torch.remainder(idx, flat.shape[0])
    else:
        idx = idx.clamp(0, flat.shape[0] - 1)
    return flat[idx]


def unfold(x, axis, size, step, name=None):
    """unfold (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('unfold', x)
    return x.unfold(axis, size, step)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """diagonal_scatter (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('diagonal_scatter', x, y)
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


def select_scatter(x, values, axis, index, name=None):
    """select_scatter (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    values = _t(values, x)
    x, values, = _amp('select_scatter', x, values)
    out = x.clone()
    idx = [slice(None)] * x.ndim
    idx[axis] = index
    out[tuple(idx)] = values
    return out


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    """slice_scatter (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    value = _t(value, x)
    x, value, = _amp('slice_scatter', x, value)
    out = x.clone()
    idx = [slice(None)] * x.ndim
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        idx[ax] = slice(st, en, sr)
    out[tuple(idx)] = value
    return out


def vecdot(x, y, axis=-1, name=None):
    """vecdot (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('vecdot', x, y)
    return torch.sum(x * y, dim=axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    """returns a tuple; nout is informational (apply unpacks whatever the impl returns) (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('tensor_split', x)
    return tuple(torch.tensor_split(x, num_or_indices, dim=axis))


def hsplit(x, num_or_indices, name=None):
    """hsplit (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('hsplit', x)
    return tuple(torch.hsplit(x, num_or_indices))


def vsplit(x, num_or_indices, name=None):
    """vsplit (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('vsplit', x)
    return tuple(torch.vsplit(x, num_or_indices))


def dsplit(x, num_or_indices, name=None):
    """dsplit (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    x, = _amp('dsplit', x)
    return tuple(torch.dsplit(x, num_or_indices))


def column_stack(x, name=None):
    """column_stack (generated; reference: python/paddle/tensor)."""
    x = list(_amp('column_stack', *[_t(_x) for _x in x]))
    return torch.column_stack(x)


def row_stack(x, name=None):
    """row_stack (generated; reference: python/paddle/tensor)."""
    x = list(_amp('row_stack', *[_t(_x) for _x in x]))
    return torch.vstack(x)


def hstack(x, name=None):
    """hstack (generated; reference: python/paddle/tensor)."""
    x = list(_amp('hstack', *[_t(_x) for _x in x]))
    return torch.hstack(x)


def vstack(x, name=None):
    """vstack (generated; reference: python/paddle/tensor)."""
    x = list(_amp('vstack', *[_t(_x) for _x in x]))
    return torch.vstack(x)


def dstack(x, name=None):
    """dstack (generated; reference: python/paddle/tensor)."""
    x = list(_amp('dstack', *[_t(_x) for _x in x]))
    return torch.dstack(x)


def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    """bitwise_left_shift (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('bitwise_left_shift', x, y)
    return torch.bitwise_left_shift(x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    """is_arithmetic=False performs a logical shift (zero-fill) like the reference (generated; reference: python/paddle/tensor)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('bitwise_right_shift', x, y)
    return _right_shift(x, y, is_arithmetic)


def add_n(inputs, name=None):
    """Sum a list of tensors elementwise (generated; reference: python/paddle/tensor/math.py add_n)."""
    inputs = list(_amp('add_n', *[_t(_x) for _x in inputs]))
    return functools.reduce(torch.add, inputs)


def sgn(x, name=None):
    """Sign for real tensors; unit-phase for complex (generated; reference: python/paddle/tensor/math.py sgn)."""
    x = _t(x)
    x, = _amp('sgn', x)
    return torch.sgn(x)


def unflatten(x, axis, shape, name=None):
    """Expand one axis into the given shape (generated; reference: python/paddle/tensor/manipulation.py unflatten)."""
    x = _t(x)
    x, = _amp('unflatten', x)
    return torch.reshape(x, tuple(x.shape[:axis % x.ndim]) + tuple(int(s) for s in shape) + tuple(x.shape[axis % x.ndim + 1:]))


def reverse(x, axis, name=None):
    """Reverse along axes (legacy alias of flip) (generated; reference: python/paddle/tensor/manipulation.py reverse (legacy fluid.layers.reverse))."""
    x = _t(x)
    x, = _amp('reverse', x)
    return torch.flip(x, tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))


def masked_scatter(x, mask, value, name=None):
    """Fill masked positions with consecutive values from value (generated; reference: python/paddle/tensor/manipulation.py masked_scatter)."""
    x = _t(x)
    mask = _t(mask, x)
    value = _t(value, x)
    x, mask, value, = _amp('masked_scatter', x, mask, value)
    flat_val = value.reshape(-1)
    mask_b = torch.broadcast_to(mask.to(torch.bool), x.shape)
    idx = torch.cumsum(mask_b.reshape(-1).long(), 0) - 1
    picked = flat_val[idx.clamp(0, flat_val.shape[0] - 1)]
    return torch.where(mask_b, picked.reshape(x.shape).to(x.dtype), x)


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distance of rows (generated; reference: python/paddle/tensor/linalg.py pdist)."""
    x = _t(x)
    _check_float('pdist', x)
    x, = _amp('pdist', x)
    n = x.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    iu = torch.as_tensor(iu, device=x.device)
    ju = torch.as_tensor(ju, device=x.device)
    return torch.linalg.vector_norm(x[iu] - x[ju], ord=p, dim=-1)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1, name=None):
    """Recompute global index to shard-local (parameter-server embedding) (generated; reference: python/paddle/tensor/manipulation.py shard_index)."""
    input = _t(input)
    input, = _amp('shard_index', input)
    size = (index_num + nshards - 1) // nshards
    shard = torch.div(input, size, rounding_mode='floor')
    return torch.where(shard == shard_id, torch.remainder(input, size), torch.full_like(input, ignore_value))


def rank(input, name=None):
    """Number of dimensions as a 0-D tensor (generated; reference: python/paddle/tensor/attribute.py rank)."""
    input = _t(input)
    input, = _amp('rank', input)
    return torch.tensor(input.ndim, dtype=torch.int32, device=input.device)


def shape(input, name=None):
    """Runtime shape as a 1-D int64 tensor (generated; reference: python/paddle/tensor/attribute.py shape)."""
    input = _t(input)
    input, = _amp('shape', input)
    return torch.tensor(list(input.shape), dtype=torch.int64, device=input.device)


def combinations(x, r=2, with_replacement=False, name=None):
    """r-length combinations of a 1-D tensor's elements (generated; reference: python/paddle/tensor/math.py combinations)."""
    x = _t(x)
    x, = _amp('combinations', x)
    n = x.shape[0]
    gen = itertools.combinations_with_replacement(range(n), r) if with_replacement else itertools.combinations(range(n), r)
    idx = torch.as_tensor(np.array(list(gen), np.int64).reshape(-1, r), device=x.device)
    return x[idx]


def logaddexp2(x, y, name=None):
    """logaddexp2 (generated; reference: python/paddle/tensor/math.py logaddexp2)."""
    x = _t(x)
    y = _t(y, x)
    _check_float('logaddexp2', x, y)
    x, y, = _amp('logaddexp2', x, y)
    return torch.logaddexp2(x, y)


def float_power(x, y, name=None):
    """float_power (generated; reference: python/paddle/tensor/math.py float_power)."""
    x = _t(x)
    y = _t(y, x)
    x, y, = _amp('float_power', x, y)
    return torch.pow(_fl(x), _fl(y))


__all__ = ['abs', 'neg', 'exp', 'expm1', 'log', 'log2', 'log10', 'log1p', 'sqrt', 'rsqrt', 'square', 'sin', 'cos', 'tan', 'asin', 'acos', 'atan', 'sinh', 'cosh', 'tanh', 'asinh', 'acosh', 'atanh', 'ceil', 'floor', 'round', 'trunc', 'frac', 'sign', 'reciprocal', 'sigmoid', 'erf', 'erfinv', 'digamma', 'lgamma', 'i0', 'i0e', 'i1', 'i1e', 'logit', 'angle', 'conj', 'real', 'imag', 'deg2rad', 'rad2deg', 'exponent', 'quantile', 'nanquantile', 'logcumsumexp', 'diff', 'trapezoid', 'cumulative_trapezoid', 'signbit', 'frexp', 'ldexp', 'vander', 'isposinf', 'isneginf', 'isreal', 'polygamma', 'multigammaln', 'baddbmm', 'cdist', 'histc', 'renorm', 'take', 'unfold', 'diagonal_scatter', 'select_scatter', 'slice_scatter', 'vecdot', 'tensor_split', 'hsplit', 'vsplit', 'dsplit', 'column_stack', 'row_stack', 'hstack', 'vstack', 'dstack', 'bitwise_left_shift', 'bitwise_right_shift', 'add_n', 'sgn', 'unflatten', 'reverse', 'masked_scatter', 'pdist', 'shard_index', 'rank', 'shape', 'combinations', 'logaddexp2', 'float_power']
