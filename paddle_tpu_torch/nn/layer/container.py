"""Sequential, LayerList, LayerDict and ParameterList
(``paddle_tpu/nn/layer/container.py``), on :class:`~.layers.Layer`: their
children are named ``"0"``, ``"1"``, ... (or as given), so parameter
names read ``features.0.weight`` as in the JAX package. Every change goes
through torch's registries, or moves the structural version that
``jit.to_static`` watches."""
from __future__ import annotations

from collections import OrderedDict

from .layers import Layer, _bump

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


def _renumber(layer, items):
    """Replace ``layer``'s children by ``items``, named ``"0"``, ...."""
    layer._modules.clear()
    for i, item in enumerate(items):
        layer._modules[str(i)] = item
    _bump()


class Sequential(Layer):
    """``Sequential(*layers)``, ``Sequential(OrderedDict)``,
    ``Sequential((name, layer), ...)`` or ``Sequential([(name, layer),
    ...])``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        elif layers and isinstance(layers[0], (list, tuple)) and not \
                isinstance(layers[0], Layer):
            # pairs as arguments (JAX's form), or one list of them
            pairs = layers[0] if len(layers) == 1 and layers[0] and \
                isinstance(layers[0][0], (list, tuple)) else layers
            for name, layer in pairs:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __setitem__(self, idx, layer):
        self.add_sublayer(list(self._modules)[idx], layer)

    def __delitem__(self, idx):
        delattr(self, list(self._modules)[idx])

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(self._abs_idx(idx))]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(self._abs_idx(idx)), layer)

    def __delitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            del layers[idx]
        else:
            del layers[self._abs_idx(idx)]
        _renumber(self, layers)

    def _abs_idx(self, idx):
        n = len(self._modules)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f"index {idx} out of range (len={n})")
        return idx

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        _renumber(self, layers)

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        delattr(self, key)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        for key in list(self._modules):
            delattr(self, key)

    def pop(self, key):
        layer = self._modules[key]
        delattr(self, key)
        return layer

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self.add_parameter(str(idx), param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
