"""What every model of the port does with its ``device`` and ``seed``
arguments: parameters drawn from the JAX layers' default initialisers
(``Layer.create_parameter``) out of one generator seeded with ``seed``
(left uninitialised when ``seed`` is None, for a load: the one way to
build a model without initialising it), each parameter named by its
structured name (``param_name``, the optimizers' state keys), and the
dropouts drawing from a generator of the model's own seeded from
``seed + 1`` (the default generator when ``seed`` is None)."""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..nn import Dropout, MultiHeadAttention
from ..nn.layer.layers import UNINITIALIZED

__all__ = ["init_generator", "finish_model"]


def init_generator(device, seed):
    """-> ``(device, generator)``: the resolved device and the
    initialisation generator its layers take (``UNINITIALIZED`` when
    ``seed`` is None)."""
    dev = resolve_device(device)
    if seed is None:
        return dev, UNINITIALIZED
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return dev, gen


def finish_model(model, device, seed):
    """Name ``model``'s parameters and seed its dropouts; -> ``model``."""
    for name, p in model.named_parameters():
        p.param_name = name
    if seed is not None:
        drop = torch.Generator(device=device)
        drop.manual_seed(int(seed) + 1)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = drop
            elif isinstance(m, MultiHeadAttention):
                m.dropout_generator = drop
    return model
