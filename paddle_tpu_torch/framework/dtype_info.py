"""``finfo`` / ``iinfo`` and the dtype predicates
(``paddle_tpu/framework/dtype_info.py``), over torch's limits."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, dtype_name
from ..core.dtype import is_complex as _dt_is_complex
from ..core.dtype import is_floating as _dt_is_floating

__all__ = ["finfo", "iinfo", "is_complex", "is_floating_point",
           "is_integer"]


class finfo:
    """Limits of a floating dtype: ``dtype`` (its name), ``bits``,
    ``eps``, ``min``, ``max``, ``tiny``, ``smallest_normal``,
    ``resolution``."""

    def __init__(self, dtype):
        d = convert_dtype(dtype)
        info = torch.finfo(d)
        self.dtype = dtype_name(d)
        self.bits = info.bits
        self.eps = float(info.eps)
        self.min = float(info.min)
        self.max = float(info.max)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.tiny)
        # in the dtype's own precision, as numpy reports it
        self.resolution = float(torch.tensor(info.resolution, dtype=d))


class iinfo:
    """Limits of an integer dtype: ``dtype``, ``bits``, ``min``, ``max``."""

    def __init__(self, dtype):
        d = convert_dtype(dtype)
        info = torch.iinfo(d)
        self.dtype = dtype_name(d)
        self.bits = info.bits
        self.min = int(info.min)
        self.max = int(info.max)


def _dtype_of(x):
    return x.dtype if torch.is_tensor(x) else convert_dtype(x)


def is_complex(x):
    return _dt_is_complex(_dtype_of(x))


def is_floating_point(x):
    return _dt_is_floating(_dtype_of(x))


def is_integer(x):
    """True for the integer dtypes (bool is not one, as in JAX)."""
    d = _dtype_of(x)
    return d in (torch.uint8, torch.int8, torch.int16, torch.int32,
                 torch.int64)
