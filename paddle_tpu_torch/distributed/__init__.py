"""Distributed training of the port (the subset ported so far: ``fleet``'s
activation recomputation)."""
from . import fleet

__all__ = ["fleet"]
