"""Creation ops (``paddle_tpu/ops/creation.py``): tensors on the current
device (``set_device``), with the JAX package's default dtypes: float
creation ops take the default dtype, ``arange`` of ints is int64, and
``arange`` of floats, ``linspace`` and ``logspace`` are float64 (JAX
runs with x64 on)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import convert_dtype, get_default_dtype
from ..core.tensor import to_tensor  # noqa: F401
from ..device import resolve_device
from ._common import amp, shape_arg

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "arange", "linspace", "logspace", "eye", "empty",
    "empty_like", "diag", "diagflat", "meshgrid", "tril", "triu", "assign",
    "clone", "numel", "tril_indices", "triu_indices", "diag_embed",
    "complex", "polar",
]


def _dt(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def _v(x):
    return x.item() if torch.is_tensor(x) else x


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_arg(shape), dtype=_dt(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_arg(shape), dtype=_dt(dtype),
                      device=resolve_device())


def _filled(out, fill_value):
    """``out`` filled with ``fill_value``; a tensor on ``out``'s device
    is copied there (no host sync), and records no gradient."""
    if torch.is_tensor(fill_value) and fill_value.device == out.device:
        return out.copy_(fill_value.detach().reshape(()))
    return out.fill_(_v(fill_value))


def full(shape, fill_value, dtype=None, name=None):
    return _filled(torch.empty(shape_arg(shape), dtype=_dt(dtype),
                               device=resolve_device()), fill_value)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    dt = convert_dtype(dtype) or x.dtype
    return _filled(torch.empty_like(x, dtype=dt), fill_value)


def empty(shape, dtype=None, name=None):
    """Zeros, as in the JAX package (a defined value, not garbage)."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    dt = convert_dtype(dtype)
    if dt is None:
        ints = builtins.all(isinstance(v, (int, np.integer))
                            for v in (start, end, step))
        dt = torch.int64 if ints else torch.float64
    return torch.arange(start, end, step, dtype=dt, device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    dt = convert_dtype(dtype) or torch.float64
    return torch.linspace(_v(start), _v(stop), int(_v(num)), dtype=dt,
                          device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    dt = convert_dtype(dtype) or torch.float64
    return torch.logspace(_v(start), _v(stop), int(_v(num)), base=base,
                          dtype=dt, device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(_v(num_rows))
    m = n if num_columns is None else int(_v(num_columns))
    return torch.eye(n, m, dtype=_dt(dtype), device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` -> the matrix with ``x`` on diagonal ``offset`` and
    ``padding_value`` elsewhere; a 2-D ``x`` -> its diagonal."""
    (x,) = amp("diag", x)
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + builtins.abs(offset)
        out = torch.full((n, n), padding_value, dtype=x.dtype,
                         device=x.device)
        return out + torch.diag(x, offset) - torch.diag(
            torch.full_like(x, padding_value), offset)
    return torch.diag(x, offset)


def diagflat(x, offset=0, name=None):
    (x,) = amp("diagflat", x)
    return torch.diagflat(x, offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    (x,) = amp("diag_embed", x)
    return torch.diag_embed(x, offset, dim1, dim2)


def meshgrid(*args, **kwargs):
    """Grids in ``"ij"`` indexing, from tensors given one by one or in a
    list."""
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*ts, indexing="ij"))


def tril(x, diagonal=0, name=None):
    (x,) = amp("tril", x)
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    (x,) = amp("triu", x)
    return torch.triu(x, diagonal)


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(row, col, offset, dtype=convert_dtype(dtype),
                              device=resolve_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=convert_dtype(dtype),
                              device=resolve_device())


def assign(x, output=None):
    """A copy of ``x`` that records no gradient (a numpy array keeps its
    dtype); with ``output``, written into it."""
    val = x.detach().clone() if torch.is_tensor(x) else torch.as_tensor(
        np.asarray(x), device=resolve_device())
    if output is not None:
        with torch.no_grad():
            output.copy_(val)
        return output
    return val


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    """The element count as a 0-d int64 tensor."""
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def complex(real, imag, name=None):  # noqa: A001
    real, imag = amp("complex", real, imag)
    return torch.complex(real, imag)


def polar(abs_, angle, name=None):
    abs_, angle = amp("polar", abs_, angle)
    return torch.polar(abs_, angle)
