"""Dtypes of the port (``paddle_tpu/core/dtype.py``): Paddle's dtype names
as torch dtypes, string and numpy conversion, and the default floating
dtype that creation ops and ``to_tensor`` give Python floats.

``set_default_dtype`` changes only the port's default; torch's own
default stays as it is. The JAX package runs with x64 on, so an integer
tensor that meets a float (a Python float, or a floating op such as
``exp`` or ``mean``) becomes float64 there: :func:`float_of` gives the
port the same promotion.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "dtype_name", "is_floating", "is_integer", "is_complex",
           "float_of"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    "half": float16, "float": float32, "double": float64, "long": int64,
    "int": int32,
}
_DTYPE_TO_NAME = {d: n for n, d in list(_NAME_TO_DTYPE.items())[:12]}

FLOATING = {float16, bfloat16, float32, float64}
INTEGER = {uint8, int8, int16, int32, int64}
COMPLEX = {complex64, complex128}

_default_dtype = float32


def set_default_dtype(d):
    """The dtype Python floats and float creation ops take (float16,
    bfloat16, float32 or float64)."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in FLOATING:
        raise TypeError(f"set_default_dtype takes a floating dtype, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype


def convert_dtype(d):
    """A dtype-like (``"float32"``, ``"paddle.int64"``, a torch or numpy
    dtype, ``bool`` / ``int`` / ``float``) -> torch dtype; None stays None."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        name = d[len("paddle."):] if d.startswith("paddle.") else d
        if name.startswith("torch."):
            name = name[len("torch."):]
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
        return convert_dtype(np.dtype(name))
    if d is builtins.bool:
        return bool_
    if d is builtins.int:
        return int64
    if d is builtins.float:
        return _default_dtype
    if d is builtins.complex:
        return complex64
    name = np.dtype(d).name
    if name not in _NAME_TO_DTYPE:
        raise TypeError(f"no torch dtype for {d!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(d) -> str:
    """torch dtype -> Paddle's name (``torch.float32`` -> ``"float32"``)."""
    return _DTYPE_TO_NAME[convert_dtype(d)]


def is_floating(d) -> bool:
    return convert_dtype(d) in FLOATING


def is_integer(d) -> bool:
    d = convert_dtype(d)
    return d in INTEGER or d == bool_


def is_complex(d) -> bool:
    return convert_dtype(d) in COMPLEX


def float_of(t):
    """``t`` as the JAX package's floating ops see it: an integer or bool
    tensor becomes float64 (x64's default float), any other stays."""
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(float64)
