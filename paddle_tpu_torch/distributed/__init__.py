"""Distributed pieces of the port ported so far: ``fleet``'s activation
recomputation and ``fault``'s injection points and graceful preemption."""
from . import fault, fleet

__all__ = ["fault", "fleet"]
