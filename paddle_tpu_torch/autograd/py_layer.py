"""``PyLayer`` — a user-defined differentiable op with a Python forward and
backward (``paddle_tpu/autograd/py_layer.py``; reference:
python/paddle/autograd/py_layer.py), on ``torch.autograd.Function``.

``apply`` takes what the JAX one takes: positional and keyword
arguments, tensors or not. The tensors among the positional arguments
are the op's inputs; keyword arguments and everything else reach
``forward`` as they are, and get no gradient. As in JAX:

* ``forward`` runs without recording; with no input that records a
  gradient, ``apply`` is just ``forward``;
* the outputs that get a gradient are the floating tensors not given to
  ``ctx.mark_non_differentiable``, and ``backward`` receives one
  cotangent for each of them, in order (zeros for an output the loss
  does not reach: the JAX tape always fills them, so
  ``ctx.set_materialize_grads(False)`` changes nothing);
* ``backward`` returns one gradient for each input that records one, or
  one for each tensor input (entries of inputs that record none are
  dropped);
* ``ctx.save_for_backward(*tensors)`` / ``ctx.saved_tensor()`` keep what
  the backward needs (torch's ``saved_tensors``); under
  ``create_graph=True`` the backward's own ops are recorded (double
  backward).

The op is one ``torch.autograd.Function`` node, so a ``PyLayer`` stages
inside ``jit.to_static`` like any other op.
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]


class PyLayerContext:
    """The context ``forward`` and ``backward`` receive (reference:
    PyLayerContext). User attributes set on it in ``forward`` are there in
    ``backward``."""

    def __init__(self):
        self.container = ()
        self._non_differentiable = set()
        self._materialize_grads = True
        self._fctx = None       # the torch Function's context, when taped
        self._tensor_slots = ()

    def save_for_backward(self, *tensors):
        if self._fctx is None:
            self.container = tensors
            return
        # torch keeps the tensors (with its version checks); other values
        # stay in the container
        self._tensor_slots = tuple(i for i, t in enumerate(tensors)
                                   if torch.is_tensor(t))
        self._fctx.save_for_backward(
            *[tensors[i] for i in self._tensor_slots])
        self.container = tuple(None if torch.is_tensor(t) else t
                               for t in tensors)

    def saved_tensor(self):
        if self._fctx is None or not self._tensor_slots:
            return self.container
        out = list(self.container)
        for i, t in zip(self._tensor_slots, self._fctx.saved_tensors):
            out[i] = t
        return tuple(out)

    def mark_non_differentiable(self, *tensors):
        self._non_differentiable |= {id(t) for t in tensors}

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)

    def mark_not_inplace(self, *args):
        pass


class _PyLayerFunction(torch.autograd.Function):
    """One ``PyLayer.apply``: the call's tensors are the inputs; ``spec``
    carries the class, its context, the other arguments and the tensors'
    places among them."""

    @staticmethod
    def forward(fctx, spec, diff, *tensors):
        cls, ctx, args, kwargs, slots = spec
        merged = list(args)
        for i, t in zip(slots, tensors):
            merged[i] = t
        ctx._fctx = fctx
        outputs = cls.forward(ctx, *merged, **kwargs)
        out_list = list(outputs) if isinstance(outputs, (tuple, list)) \
            else [outputs]
        taped = [i for i, o in enumerate(out_list) if torch.is_tensor(o)
                 and o.is_floating_point()
                 and id(o) not in ctx._non_differentiable]
        frozen = [o for i, o in enumerate(out_list)
                  if torch.is_tensor(o) and i not in taped]
        if frozen:
            fctx.mark_non_differentiable(*frozen)
        fctx.set_materialize_grads(True)
        fctx.cls, fctx.ctx, fctx.diff, fctx.taped = cls, ctx, diff, taped
        return outputs

    @staticmethod
    def backward(fctx, *cts):
        cls, diff = fctx.cls, fctx.diff
        res = cls.backward(fctx.ctx, *[cts[i] for i in fctx.taped])
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        want = [i for i, d in enumerate(diff) if d]
        if len(res) == len(want):
            pairs = zip(want, res)
        elif len(res) == len(diff):
            pairs = ((i, g) for i, g in enumerate(res) if diff[i])
        else:
            raise RuntimeError(
                f"{cls.__name__}.backward returned {len(res)} gradients but "
                f"forward has {len(diff)} tensor inputs ({len(want)} "
                f"differentiable)")
        grads = [None] * len(diff)
        for i, g in pairs:
            grads[i] = g
        return (None, None, *grads)


class PyLayer:
    """Base class of a custom differentiable op::

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x * x

            @staticmethod
            def backward(ctx, dy):
                x, = ctx.saved_tensor()
                return 3 * x * x * dy

        y = Cube.apply(x)
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError(
            "PyLayer subclasses must implement a forward staticmethod")

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError(
            "PyLayer subclasses must implement a backward staticmethod")

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        slots = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        tensors = [args[i] for i in slots]
        diff = [t.requires_grad for t in tensors]
        if not (torch.is_grad_enabled() and any(diff)):
            with torch.no_grad():
                return cls.forward(ctx, *args, **kwargs)
        return _PyLayerFunction.apply((cls, ctx, args, kwargs, slots), diff,
                                      *tensors)


def once_differentiable(backward_fn):
    """Marks a backward as not differentiable again (kept for the API, as
    in JAX)."""
    return staticmethod(backward_fn) if not isinstance(
        backward_fn, staticmethod) else backward_fn
