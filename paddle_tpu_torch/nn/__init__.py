"""Neural-network layers (``Layer`` and every ported layer), functionals,
initializers, ``nn.utils`` and gradient clipping of the port
(``paddle_tpu/nn``). As in JAX, the layer files are reachable here by
name too (``nn.conv``, ``nn.rnn``, ``nn.extra``, ...)."""
from . import functional, initializer, layer, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import *  # noqa: F401,F403  (every layer, as in JAX)
from .layer import __all__ as _layers

__all__ = list(_layers) + [
    "functional", "initializer", "layer", "utils", "ClipGradByValue",
    "ClipGradByNorm", "ClipGradByGlobalNorm", "clip_grad_norm_"]
