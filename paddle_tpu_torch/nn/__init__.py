"""Neural-network layers (``Layer`` and every ported layer), functionals,
initializers and gradient clipping of the port (``paddle_tpu/nn``)."""
from . import functional, initializer, layer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import *  # noqa: F401,F403  (every layer, as in JAX)
from .layer import __all__ as _layers

__all__ = list(_layers) + [
    "functional", "initializer", "layer", "ClipGradByValue", "ClipGradByNorm",
    "ClipGradByGlobalNorm", "clip_grad_norm_"]
