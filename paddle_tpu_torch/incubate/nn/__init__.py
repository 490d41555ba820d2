"""incubate.nn — the functional fused ops the port has."""
from . import functional

__all__ = ["functional"]
