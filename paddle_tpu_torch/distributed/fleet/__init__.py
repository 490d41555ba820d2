"""``fleet`` of the port: activation recomputation (the parallel strategies
are not ported yet)."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
