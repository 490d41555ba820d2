"""auto_cast and decorate — automatic mixed precision, after
``paddle_tpu/amp/auto_cast.py`` (reference: python/paddle/amp/
auto_cast.py:273 amp_guard).

The JAX package decides once per eager op inside ``core.dispatch.apply``:
a black-list op's floating inputs are cast to f32; under O1 a white-list
op's are cast to the AMP dtype and any other op's are left as they are;
under O2 every op's but the black list's (and the ``_EXEMPT`` ops') are
cast to the AMP dtype. The port has no dispatcher, so the decision sits
in the port's own layers and functionals: each op the JAX GPT dispatches
under a name calls :func:`amp_cast` with that name (``linear``,
``layer_norm``, ``rms_norm``, ``embedding``, ``add`` for the residual
adds, ``gelu``, ``scaled_dot_product_attention``, ``lm_head_tied``,
``cross_entropy``). The dtype an op sees is therefore the one the JAX
package's lists give it: under O1 Linear and flash attention compute in
bf16, the norms and cross-entropy in f32, and the tied LM head (on
neither list) in its inputs' type, f32; under O2 the tied head too is a
bf16 product, the norms' inputs go to f32 and the next ``linear`` back to
bf16, and the residual stream stays bf16. Casts are ordinary
differentiable ``Tensor.to`` calls, so a parameter's gradient arrives in
the parameter's type. ``torch.autocast`` is not used: its own op lists
differ from the JAX package's.

:func:`decorate` is O2's other half: it casts every floating parameter
and buffer of the models to bf16 in place (each ``Parameter`` object, and
its ``param_name``, stays, so an optimizer built before keeps its state
by it) and turns on the optimizers' f32 master weights.

The port's kernels take bf16 and f32, so float16 is refused.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import amp_lists

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_dtype_for",
           "amp_cast", "amp_state", "amp_state_scope"]

_EXEMPT = {"cast", "clone", "getitem", "setitem", "assign"}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.white = amp_lists.WHITE_LIST
        self.black = amp_lists.BLACK_LIST


_state = _AmpState()


def amp_state():
    """The active AMP settings ``(enabled, level, white, black)``: what a
    replay of a forward (``recompute``) must run under again."""
    return _state.enabled, _state.level, _state.white, _state.black


@contextlib.contextmanager
def amp_state_scope(state):
    """Run the block under the AMP settings ``state`` (from
    :func:`amp_state`), restoring the current ones after it."""
    prev = amp_state()
    _state.enabled, _state.level, _state.white, _state.black = state
    try:
        yield
    finally:
        _state.enabled, _state.level, _state.white, _state.black = prev


def _amp_dtype(dtype):
    if dtype not in ("bfloat16", torch.bfloat16):
        raise NotImplementedError(f"AMP dtype {dtype!r}: the port's "
                                  f"kernels take bfloat16 and float32")
    return torch.bfloat16


def amp_dtype_for(op_name):
    """The dtype ``op_name``'s floating inputs are cast to under the
    active ``auto_cast``, or None to leave them as they are."""
    if not _state.enabled or op_name in _EXEMPT:
        return None
    if op_name in _state.black:
        return torch.float32
    if _state.level == "O2" or op_name in _state.white:
        return torch.bfloat16
    return None


def amp_cast(op_name, *tensors):
    """``tensors`` with every floating one cast to ``amp_dtype_for(
    op_name)`` (None entries and non-floating tensors pass through)."""
    target = amp_dtype_for(op_name)
    if target is None:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target and t.dtype != torch.float64 else t
                 for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``with auto_cast(level="O1" or "O2", dtype="bfloat16"):`` — mixed
    precision over the JAX package's white and black lists, which
    ``custom_white_list`` / ``custom_black_list`` extend (a name moves
    from the other list); ``O0`` or ``enable=False`` turns it off.
    ``use_promote`` is accepted, as in the JAX package."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"AMP level {level!r}: O0, O1 or O2")
    _amp_dtype(dtype)
    white, black = set(amp_lists.WHITE_LIST), set(amp_lists.BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    with amp_state_scope((bool(enable) and level != "O0", level, white,
                          black)):
        yield


amp_guard = auto_cast


def _cast_floating(model, dtype):
    """Cast ``model``'s floating parameters and buffers to ``dtype`` in
    place, keeping each ``Parameter`` object (``paddle_tpu/nn/layer/
    layers.py:321-332``)."""
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
                if p.grad is not None:
                    p.grad = p.grad.to(dtype)
        for m in model.modules():
            for name, b in m._buffers.items():
                if b is not None and b.is_floating_point():
                    m._buffers[name] = b.to(dtype)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration (reference: paddle.amp.decorate): under ``level="O2"``
    cast the models' floating parameters and buffers to bf16, and, unless
    ``master_weight`` is False, turn on the optimizers' master weights.
    Returns what it was given: a model, or ``(model, optimizer)``, or
    lists of them. ``save_dtype`` is accepted, as in the JAX package."""
    if level not in ("O1", "O2"):
        raise ValueError(f"decorate level {level!r}: O1 or O2")
    target = _amp_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            _cast_floating(m, target)
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if master_weight is not False:
        for opt in opt_list:
            opt._multi_precision = True
    if single_model and single_opt:
        return models, optimizers
    return model_list, opt_list
