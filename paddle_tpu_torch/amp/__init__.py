"""Automatic mixed precision of the port (O1 over the JAX package's lists)."""
from .auto_cast import amp_cast, amp_dtype_for, auto_cast

__all__ = ["auto_cast", "amp_dtype_for", "amp_cast"]
