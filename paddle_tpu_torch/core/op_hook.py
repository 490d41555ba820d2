"""The op seam of the port: what ``paddle_tpu/core/dispatch.py``'s op hook
(``_op_profiler``) and its NaN/Inf check (``_check_nan_inf``,
``_nan_queue``, ``flush_nan_checks``) give the JAX package.

The port has no single dispatch, so the seam is a
``torch.overrides.TorchFunctionMode`` that sees every ``torch.*`` call and
``Tensor`` method of the thread that installed it. It is installed only
while something listens (a hook of :func:`add_hook`, the tensor checker
and the operator statistics of ``amp.debugging`` are hooks) or
``FLAGS_check_nan_inf`` is on, and removed when the last one stops: with
all of them off no mode is installed and an op costs nothing more.

An op's name is torch's (``matmul``, ``add`` for ``Tensor.__add__``,
``softmax``), not the JAX package's. Nothing here reads a device value
back to the host while the current CUDA stream is capturing a graph, or
while ``jit.to_static`` stages a function: the counterpart of JAX
skipping tracers, so a staged step stays one graph.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["add_hook", "remove_hook", "set_check_nan_inf",
           "set_nan_window", "flush_nan_checks", "reading_allowed",
           "checkable"]

_hooks: list = []        # hook(name, args, kwargs, result)
_check_nan_inf = False   # FLAGS_check_nan_inf
_nan_window = 1          # FLAGS_check_nan_inf_window: results a host read
_nan_pending: list = []  # (op name, tensor, device-side finite flag)
_mode = None             # the installed seam, or None

# attribute reads and conversions are not ops
_SKIP = frozenset({"__get__", "__set__", "__repr__", "__format__",
                   "__len__", "__bool__", "__float__", "__int__",
                   "__index__", "__iter__", "__hash__", "__contains__",
                   "numpy", "tolist", "item", "dim", "size", "numel",
                   "is_floating_point", "data_ptr", "element_size",
                   "stride", "storage_offset", "is_contiguous",
                   "requires_grad_", "register_hook", "backward",
                   "detach", "cpu", "cuda", "to"})


# ops whose results hold whatever the memory held: nothing to check
UNINITIALISED = frozenset({"empty", "empty_like", "new_empty",
                           "empty_strided", "new_empty_strided"})


def op_name(func):
    """torch's name of ``func`` (``Tensor.__add__`` -> ``add``), or None
    for what is not an op."""
    name = getattr(func, "__name__", None)
    if name is None or name in _SKIP:
        return None
    if name.startswith("__") and name.endswith("__"):
        name = name[2:-2]
        if name.startswith(("r", "i")) and name[1:] in (
                "add", "sub", "mul", "truediv", "matmul", "pow", "floordiv",
                "mod", "and", "or", "xor"):
            name = name[1:]
    return name


def reading_allowed():
    """False while the current CUDA stream captures a graph or
    ``jit.to_static`` stages a function: no device value may come back
    to the host then."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return False
    from ..jit.api import is_staging
    return not is_staging()


def checkable(name):
    """Whether an op's results are values to check (not uninitialised
    memory) and reading them back is allowed now."""
    return name not in UNINITIALISED and reading_allowed()


def tensors_of(result):
    """The tensors of an op's result (a tensor, or a tuple / list of
    them)."""
    if torch.is_tensor(result):
        return [result]
    if isinstance(result, (tuple, list)):
        return [r for r in result if torch.is_tensor(r)]
    return []


class _Seam(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = op_name(func)
        if name is not None:
            for hook in list(_hooks):
                hook(name, args, kwargs, out)
            if _check_nan_inf:
                _nan_queue(name, tensors_of(out))
        return out


def _refresh():
    """Install the seam when someone listens, remove it when no one
    does."""
    global _mode
    want = bool(_hooks) or _check_nan_inf
    if want and _mode is None:
        _mode = _Seam()
        _mode.__enter__()
    elif not want and _mode is not None:
        mode, _mode = _mode, None
        mode.__exit__(None, None, None)


def installed():
    return _mode is not None


def add_hook(hook):
    """Call ``hook(name, args, kwargs, result)`` after every op."""
    _hooks.append(hook)
    _refresh()
    return hook


def remove_hook(hook):
    if hook in _hooks:
        _hooks.remove(hook)
    _refresh()


def set_check_nan_inf(on):
    """``FLAGS_check_nan_inf``: every floating result of an op is checked
    for NaN / Inf."""
    global _check_nan_inf
    _check_nan_inf = bool(on)
    if not _check_nan_inf:
        _nan_pending.clear()
    _refresh()


def set_nan_window(window):
    """``FLAGS_check_nan_inf_window``: the results batched per blocking
    read of their finite flags (1: raise at the op)."""
    global _nan_window
    w = int(window)
    if w < 1:
        raise ValueError("FLAGS_check_nan_inf_window must be >= 1")
    _nan_window = w


def _nan_queue(name, tensors):
    """Issue each floating result's finite reduction on the device and
    read the flags once ``_nan_window`` of them wait (``dispatch.py``'s
    ``_nan_queue``); nothing is queued while reading is not allowed."""
    if not checkable(name):
        return
    for t in tensors:
        if t.is_floating_point() or t.is_complex():
            _nan_pending.append((name, t, torch.isfinite(t).all()))
    if len(_nan_pending) >= _nan_window:
        flush_nan_checks()


def flush_nan_checks():
    """Read every pending finite flag in one host read and raise on the
    first non-finite result, in issue order."""
    if not _nan_pending:
        return
    pending = list(_nan_pending)
    _nan_pending.clear()
    if len(pending) > 1 and bool(torch.stack([f for _, _, f in pending])
                                 .all()):
        return
    for name, t, flag in pending:
        if not bool(flag):
            raise FloatingPointError(
                f"(NaN/Inf) op '{name}' produced non-finite values "
                f"(shape {list(t.shape)}, dtype {t.dtype}); set "
                "FLAGS_check_nan_inf=False to disable this check")
