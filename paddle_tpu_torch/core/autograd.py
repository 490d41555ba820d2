"""The public autograd API (``paddle_tpu/core/autograd.py:36-472``) over
torch's autograd: ``grad`` with the JAX package's arguments and
semantics, ``backward``, and the grad-mode switches.

``no_grad`` and ``enable_grad`` are torch's (each a context and a
decorator); ``set_grad_enabled(mode)`` sets the mode, as in JAX.
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "grad", "backward"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def set_grad_enabled(mode: bool):
    """Turn gradient recording on or off (also a context manager, as
    torch's is)."""
    return torch.set_grad_enabled(bool(mode))


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``;
    a tensor that records no graph is skipped, as in JAX."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors) or [None] * len(tensors)
    pairs = [(t, torch.ones_like(t) if g is None else g)
             for t, g in zip(tensors, grads) if t.grad_fn is not None
             or t.requires_grad]
    if not pairs:
        return
    torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs],
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of ``outputs`` with respect to ``inputs`` (a list, as in
    JAX). ``grad_outputs`` defaults to ones; ``retain_graph`` defaults to
    ``create_graph``; ``create_graph=True`` returns gradients that record
    their own graph (double backward). Gradient does not flow through the
    tensors of ``no_grad_vars``. An input the outputs do not reach raises
    unless ``allow_unused``, which gives None for it."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    gos = _as_list(grad_outputs) or [None] * len(outputs)
    gos = [torch.ones_like(o) if g is None else g
           for o, g in zip(outputs, gos)]
    retain = create_graph if retain_graph is None else retain_graph
    hooks = [v.register_hook(torch.zeros_like)
             for v in (no_grad_vars or []) if v.requires_grad]
    try:
        grads = torch.autograd.grad(outputs, inputs, gos,
                                    retain_graph=retain,
                                    create_graph=create_graph,
                                    allow_unused=True)
    finally:
        for h in hooks:
            h.remove()
    if not allow_unused and any(g is None for g in grads):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph. Set allow_unused=True if this is desired.")
    return list(grads)
