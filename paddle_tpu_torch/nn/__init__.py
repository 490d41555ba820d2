"""Neural-network layers of the port (the serving and training paths'
subset) and gradient clipping."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "functional", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]
