"""Optimizer base class, after ``paddle_tpu/optimizer/optimizer.py:24-165``
(reference: python/paddle/optimizer/optimizer.py).

Kept: explicit parameter lists or param groups (dicts with ``params`` and
optional ``learning_rate`` scale and ``weight_decay``), a float learning
rate with ``get_lr``/``set_lr``, a ``step`` that skips parameters with no
gradient (or with ``requires_grad=False``), ``clear_grad``, and
per-parameter accumulators by name (``moment1``, ``moment2``,
``beta_pow``). Unlike the JAX package, which rebinds each parameter to a
new array, the port's updates write parameters and accumulators in place.
Not ported yet: LR schedulers, grad clipping, L1/L2 regularizer objects,
master weights (``multi_precision``), ``state_dict`` and the static-graph
``minimize``.
"""
from __future__ import annotations

from collections import defaultdict

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None):
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters()")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            self._param_groups = []
            self._parameter_list = []
            for g in parameters:
                group = dict(g)
                group["params"] = list(g["params"])
                self._param_groups.append(group)
                self._parameter_list += group["params"]
        else:
            self._parameter_list = parameters
            self._param_groups = [{"params": parameters}]
        self.set_lr(learning_rate)
        self.regularization = weight_decay
        # accumulator name -> {parameter: value}, keyed by the parameter
        # object itself (tensors hash by identity)
        self._accumulators = defaultdict(dict)

    # ---- learning rate ----
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        if not isinstance(value, (int, float)):
            raise TypeError(f"learning_rate must be a float (LR schedulers "
                            f"are not ported), got {type(value).__name__}")
        self._learning_rate = float(value)

    # ---- accumulators ----
    def _get_accumulator(self, name, p, init=None):
        """The ``name`` accumulator of ``p``, created on first use: zeros
        shaped like ``p`` in f32, or ``init``."""
        d = self._accumulators[name]
        if p not in d:
            d[p] = torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) if init is None else init
        return d[p]

    def _set_accumulator(self, name, p, value):
        self._accumulators[name][p] = value

    # ---- the step ----
    def _params_with_grads(self):
        """-> ``[(param, group lr, group)]`` for every parameter that has a
        gradient, in group order."""
        out = []
        for group in self._param_groups:
            lr = self.get_lr() * float(group.get("learning_rate", 1.0))
            out += [(p, lr, group) for p in group["params"]
                    if p.requires_grad and p.grad is not None]
        return out

    @torch.no_grad()
    def step(self):
        items = self._params_with_grads()
        if items:
            self._apply(items)

    def _apply(self, items):
        """Update every ``(param, lr, group)`` of ``items`` in place.
        Subclasses implement."""
        raise NotImplementedError

    # ---- grads ----
    def clear_grad(self):
        """Drop every parameter's gradient (set it to None, as the JAX
        package does)."""
        for p in self._parameter_list:
            p.grad = None
