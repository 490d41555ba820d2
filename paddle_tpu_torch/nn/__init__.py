"""Neural-network layers of the port (the serving and training paths'
subset)."""
from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "functional"]
