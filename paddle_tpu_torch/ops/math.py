"""Elementwise and reduction math (``paddle_tpu/ops/math.py``).

Each op casts its tensor operands as ``auto_cast`` casts the JAX op of the
same name (``add``, ``multiply``, ``sum``, ...: ``amp_cast``), then makes
one torch call. Python numbers follow the JAX package's weak typing (an
int tensor plus a float is float64, a float32 tensor plus a float stays
float32), and the ops JAX computes in floating point on integer input
(``divide``, ``mean``, ``var``, ``std``, ``median``, ``atan2``, ...) give
float64 there. ``max`` / ``min`` with an axis return values only;
``median`` averages the two middle values whatever ``mode`` is; ``var``
and ``std`` are unbiased by default. The models' residual adds go
through :func:`add`, so under O2 their streams stay 16-bit.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import _state as _amp_state
from ..core.dtype import convert_dtype, float_of
from ._common import (amp, axis_arg, binary_operands, moved_last,
                      scalar_operand)
from .inplace import _write

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "logaddexp", "hypot", "nextafter", "copysign", "gcd", "lcm",
    "heaviside", "inner", "outer", "kron", "isnan", "isinf", "isfinite",
    "nan_to_num", "clip", "lerp", "scale", "increment", "multiplex",
    "stanh", "addmm", "sum", "mean", "prod", "max", "min", "amax", "amin",
    "all", "any", "argmax", "argmin", "cumsum", "cumprod", "cummax",
    "cummin", "logsumexp", "median", "nanmedian", "nanmean", "nansum",
    "var", "std", "count_nonzero", "trace", "diagonal", "dot", "cross",
]


# the dtypes in which torch computes with a Python number as JAX's weak
# typing does (the number rounded to the tensor's dtype, no wider math)
_NUMBER_EXACT = (torch.float32, torch.float64)


def _binary(opname, fn, floating=False, numbers=False):
    """The op ``opname`` over ``fn``. With ``numbers``, ``fn`` takes a
    Python number as its second argument, and gets it as it is beside an
    f32 / f64 tensor outside ``auto_cast``: the same value, without the
    number's 0-d tensor."""
    def op(x, y, name=None):
        if numbers and type(y) in (int, float) and torch.is_tensor(x) \
                and x.dtype in _NUMBER_EXACT and not _amp_state.enabled:
            return fn(x, y)
        if not (torch.is_tensor(x) and torch.is_tensor(y)):
            x, y = binary_operands(x, y)
        x, y = amp(opname, x, y)
        if floating and not (x.is_floating_point() or y.is_floating_point()
                             or x.is_complex() or y.is_complex()):
            x, y = float_of(x), float_of(y)
        return fn(x, y)
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = f"Elementwise ``{opname}`` (``paddle_tpu/ops/math.py``)."
    return op


def _flat_outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _heaviside(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.heaviside(a.to(dt), b.to(dt))


# ---- binary elementwise ----
add = _binary("add", torch.add, numbers=True)
subtract = _binary("subtract", torch.sub, numbers=True)
multiply = _binary("multiply", torch.mul, numbers=True)
divide = _binary("divide", torch.true_divide, floating=True,
                 numbers=True)
floor_divide = _binary("floor_divide", torch.floor_divide, numbers=True)
remainder = _binary("remainder", torch.remainder, numbers=True)
mod = remainder
floor_mod = remainder
pow = _binary("pow", torch.pow, numbers=True)  # noqa: A001
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2, floating=True)
logaddexp = _binary("logaddexp", torch.logaddexp, floating=True)
hypot = _binary("hypot", torch.hypot, floating=True)
nextafter = _binary("nextafter", torch.nextafter)
copysign = _binary("copysign", torch.copysign, floating=True)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
heaviside = _binary("heaviside", _heaviside)
inner = _binary("inner", torch.inner)
outer = _binary("outer", _flat_outer)
kron = _binary("kron", torch.kron)


def isnan(x, name=None):
    (x,) = amp("isnan", x.detach())
    return torch.isnan(x)


def isinf(x, name=None):
    (x,) = amp("isinf", x.detach())
    return torch.isinf(x)


def isfinite(x, name=None):
    (x,) = amp("isfinite", x.detach())
    return torch.isfinite(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    (x,) = amp("nan_to_num", x)
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


_BOUND_NUMBER = (int, float, type(None))


def clip(x, min=None, max=None, name=None):  # noqa: A002
    """``minimum(maximum(x, min), max)`` against 0-d tensors in ``x``'s
    dtype (a tie splits the gradient as ``jnp.clip`` does); one
    ``torch.clamp``, of the same value, where no gradient is recorded. A
    bound records no gradient; a tensor bound stays on the device."""
    (x,) = amp("clip", x)
    if x.is_floating_point() and not (x.requires_grad and
                                      torch.is_grad_enabled()) and \
            type(min) in _BOUND_NUMBER and type(max) in _BOUND_NUMBER \
            and (min is not None or max is not None):
        # a number bound rounds to x's grid as the 0-d tensor would, and
        # x's values lie on it: clamp's comparison gives the same result
        return torch.clamp(x, min, max)
    lo = None if min is None else _bound(min, x)
    hi = None if max is None else _bound(max, x)
    if (lo is not None or hi is not None) and not (
            x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, lo)
    if hi is not None:
        x = torch.minimum(x, hi)
    return x


def _bound(v, x):
    """A bound of :func:`clip` as a 0-d tensor in ``x``'s dtype."""
    if torch.is_tensor(v) and v.numel() == 1:
        v = v.reshape(())
    b = scalar_operand(v, x)
    return b if b.dtype == x.dtype else b.to(x.dtype)


def lerp(x, y, weight, name=None):
    if torch.is_tensor(weight):
        x, y, weight = amp("lerp", x, y, weight)
    else:
        x, y = amp("lerp", x, y)
    return x + weight * (y - x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``). A tensor
    ``scale`` is read as JAX reads ``.item()``, but stays on the device:
    no host sync."""
    (x,) = amp("scale", x)
    s = scale
    if torch.is_tensor(s):
        s = s.detach().reshape(()) if s.numel() == 1 else s.detach()
        floats = s.is_floating_point()
    else:
        floats = isinstance(s, float)
    if floats or isinstance(bias, float):
        x = float_of(x) if not x.is_floating_point() else x
    if torch.is_tensor(s):
        s = scalar_operand(s, x)
    if bias_after_scale:
        return x * s + bias
    return (x + bias) * s


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    return _write(x, x + value)


def multiplex(inputs, index, name=None):
    """Row ``i`` of the output is row ``i`` of ``inputs[index[i]]``."""
    xs = amp("multiplex", *inputs)
    stacked = torch.stack(xs, 0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[index.reshape(-1).long(), rows]


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (x,) = amp("stanh", x)
    return scale_b * torch.tanh(scale_a * float_of(x))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    input, x, y = amp("addmm", input, x, y)
    return beta * input + alpha * (x @ y)


# ---- reductions ----
def _dims(x, axis):
    ax = axis_arg(axis)
    if ax is None:
        return None
    return (ax,) if isinstance(ax, int) else ax


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    (x,) = amp("sum", x)
    dims, dt = _dims(x, axis), convert_dtype(dtype)
    if dims is None:
        out = torch.sum(x, dtype=dt)
        return out.reshape([1] * x.ndim) if keepdim else out
    return torch.sum(x, dim=dims, keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    (x,) = amp("mean", x)
    x, dims = float_of(x), _dims(x, axis)
    if dims is None:
        out = torch.mean(x)
        return out.reshape([1] * x.ndim) if keepdim else out
    return torch.mean(x, dim=dims, keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    (x,) = amp("prod", x)
    dims, dt = _dims(x, axis), convert_dtype(dtype)
    if dims is None:
        out = torch.prod(x, dtype=dt)
        return out.reshape([1] * x.ndim) if keepdim else out
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim, dtype=dt)
        dt = None
    return x


def _extreme(opname, fn):
    def op(x, axis=None, keepdim=False, name=None):
        (x,) = amp(opname, x)
        dims = _dims(x, axis)
        if dims is None:
            dims = tuple(range(x.ndim))
        return fn(x, dim=dims, keepdim=keepdim)
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = (f"``{opname}`` over ``axis`` (all when None): values "
                  f"only; a tie shares the gradient evenly, as in JAX.")
    return op


max = _extreme("max", torch.amax)  # noqa: A001
min = _extreme("min", torch.amin)  # noqa: A001
amax = max
amin = min


def _logical_reduce(fn, x, axis, keepdim):
    b = x if x.dtype == torch.bool else x != 0
    dims = _dims(x, axis)
    if dims is None:
        out = fn(b)
        return out.reshape([1] * x.ndim) if keepdim else out
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        b = fn(b, dim=d, keepdim=keepdim)
    return b


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _logical_reduce(torch.all, x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _logical_reduce(torch.any, x, axis, keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    ax = axis_arg(axis)
    if ax is None:
        out = fn(x.reshape(-1), 0)
        if keepdim:
            out = out.reshape([1] * x.ndim)
    else:
        out = fn(x, ax, keepdim=keepdim)
    return out.to(convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def cumsum(x, axis=None, dtype=None, name=None):
    (x,) = amp("cumsum", x)
    dt = convert_dtype(dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = amp("cumprod", x)
    dt = convert_dtype(dtype)
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dt)
    return torch.cumprod(x, int(dim), dtype=dt)


def _cum_extreme(opname, fn, x, axis, dtype):
    (x,) = amp(opname, x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, idx = fn(x, int(axis))
    return vals, idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    """Running maximum and the index of its last occurrence so far."""
    return _cum_extreme("cummax", torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme("cummin", torch.cummin, x, axis, dtype)


def logsumexp(x, axis=None, keepdim=False, name=None):
    (x,) = amp("logsumexp", x)
    x = float_of(x)
    dims = _dims(x, axis)
    if dims is None:
        dims = tuple(range(x.ndim))
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The mean of the two middle values (one when the count is odd),
    whatever ``mode`` is, as ``jnp.median``."""
    (x,) = amp("median", x)
    flat, keep = moved_last(float_of(x), axis)
    n = flat.shape[-1]
    s = torch.sort(flat, dim=-1).values
    out = (s[..., (n - 1) // 2] + s[..., n // 2]) / 2
    out = torch.where(torch.isnan(flat).any(-1),
                      torch.full_like(out, float("nan")), out)
    return out.reshape(keep) if keepdim else out


def nanmedian(x, axis=None, keepdim=False, name=None):
    (x,) = amp("nanmedian", x)
    flat, keep = moved_last(float_of(x), axis)
    half = flat.dtype in (torch.float16, torch.bfloat16)
    out = torch.nanquantile(flat.float() if half else flat, 0.5, dim=-1)
    out = out.to(flat.dtype)
    return out.reshape(keep) if keepdim else out


def nanmean(x, axis=None, keepdim=False, name=None):
    (x,) = amp("nanmean", x)
    x = float_of(x)
    dims = _dims(x, axis)
    if dims is None:
        out = torch.nanmean(x)
        return out.reshape([1] * x.ndim) if keepdim else out
    return torch.nanmean(x, dim=dims, keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    (x,) = amp("nansum", x)
    dims, dt = _dims(x, axis), convert_dtype(dtype)
    if dims is None:
        out = torch.nansum(x, dtype=dt)
        return out.reshape([1] * x.ndim) if keepdim else out
    return torch.nansum(x, dim=dims, keepdim=keepdim, dtype=dt)


def _moment(opname, fn, x, axis, unbiased, keepdim):
    (x,) = amp(opname, x)
    x = float_of(x)
    dims = _dims(x, axis)
    out = fn(x, dim=dims, correction=1 if unbiased else 0,
             keepdim=keepdim and dims is not None)
    if keepdim and dims is None:
        out = out.reshape([1] * x.ndim)
    return out


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment("var", torch.var, x, axis, unbiased, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment("std", torch.std, x, axis, unbiased, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        shape = [1 if dims is None or d in [a % x.ndim for a in dims]
                 else x.shape[d] for d in range(x.ndim)]
        out = out.reshape(shape)
    return out.to(torch.int64)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = amp("trace", x)
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = amp("diagonal", x)
    return torch.diagonal(x, offset, axis1, axis2)


def dot(x, y, name=None):
    """``sum(x * y, -1)``: 1-D vectors, or row by row for 2-D."""
    x, y = amp("dot", x, y)
    return torch.sum(x * y, dim=-1)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (by default, 9, the first axis of
    size 3)."""
    ax = axis if axis != 9 else next(
        i for i, s in enumerate(x.shape) if s == 3)
    x, y = amp("cross", x, y)
    return torch.linalg.cross(x, y, dim=ax)

