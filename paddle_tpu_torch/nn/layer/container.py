"""Sequential and LayerList (``paddle_tpu/nn/layer/container.py``): their
children are named ``"0"``, ``"1"``, ... (or as given), so parameter
names read ``features.0.weight`` as in the JAX package."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList"]


class Sequential(nn.Sequential):
    """``Sequential(*layers)``, ``Sequential(OrderedDict)`` or
    ``Sequential([(name, layer), ...])``."""

    def __init__(self, *layers):
        if layers and isinstance(layers[0], (list, tuple)) \
                and not isinstance(layers[0], nn.Module):
            layers = (OrderedDict(layers[0]),)
        super().__init__(*layers)


class LayerList(nn.ModuleList):
    pass
