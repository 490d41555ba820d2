"""Neural-network layers of the port (the serving and training paths'
subset)."""
from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "functional"]
