"""auto_cast — automatic mixed precision, after
``paddle_tpu/amp/auto_cast.py`` (reference: python/paddle/amp/
auto_cast.py:273 amp_guard).

The JAX package decides once per eager op inside ``core.dispatch.apply``:
under O1 a white-list op's floating inputs are cast to the AMP dtype, a
black-list op's to f32, and any other op's are left as they are. The port
has no dispatcher, so the decision sits in the port's own layers and
functionals: each op the JAX package dispatches under a listed name calls
:func:`amp_cast` with that name (``linear``, ``layer_norm``,
``scaled_dot_product_attention``, ``cross_entropy``).
The dtype an op sees is therefore the one ``amp_lists.py`` gives it:
Linear and flash attention compute in bf16; LayerNorm, the plain
attention chain's softmax and cross-entropy in f32; the tied LM head
(``lm_head_tied``, on neither list) in whatever its inputs are, f32.
Casts are ordinary differentiable ``Tensor.to`` calls, so gradients reach
f32 parameters in f32. ``torch.autocast`` is not used: its own op lists
differ from the JAX package's.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import amp_lists

__all__ = ["auto_cast", "amp_dtype_for", "amp_cast"]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False


_state = _AmpState()


def amp_dtype_for(op_name):
    """The dtype ``op_name``'s floating inputs are cast to under the
    active ``auto_cast``, or None to leave them as they are."""
    if not _state.enabled:
        return None
    if op_name in amp_lists.BLACK_LIST:
        return torch.float32
    if op_name in amp_lists.WHITE_LIST:
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
def auto_cast(enable=True, level="O1", dtype="bfloat16"):
    """``with auto_cast(level="O1", dtype="bfloat16"):`` — O1 mixed
    precision over the JAX package's white and black lists; ``O0`` or
    ``enable=False`` turns it off. O2 (low-precision parameters with
    master weights, ``paddle.amp.decorate``) and float16 (the port's
    kernels take bf16 and f32) are not ported."""
    if level not in ("O0", "O1"):
        raise NotImplementedError(f"auto_cast level {level!r}: the port "
                                  f"has O0 and O1")
    if dtype not in ("bfloat16", torch.bfloat16):
        raise NotImplementedError(f"auto_cast dtype {dtype!r}: the port "
                                  f"has bfloat16")
    prev = _state.enabled
    _state.enabled = bool(enable) and level != "O0"
    try:
        yield
    finally:
        _state.enabled = prev
