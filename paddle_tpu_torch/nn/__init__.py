"""Neural-network layers of the port (the serving path's subset)."""
from . import functional
from .layer import Embedding, LayerNorm, Linear

__all__ = ["Linear", "Embedding", "LayerNorm", "functional"]
