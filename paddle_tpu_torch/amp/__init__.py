"""Automatic mixed precision of the port: O1 and O2 over the JAX package's
lists, ``decorate``, ``GradScaler`` and ``debugging`` (numerics checks
and operator statistics)."""
from . import debugging  # noqa: F401
from .auto_cast import amp_cast, amp_dtype_for, amp_guard, auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_dtype_for",
           "amp_cast", "GradScaler", "AmpScaler", "debugging"]
