"""paddle.amp.debugging — numerics checks and operator statistics
(``paddle_tpu/amp/debugging.py``; reference: python/paddle/amp/
debugging.py).

The JAX package's checks ride its dispatch hook; the port's ride the op
seam of :mod:`..core.op_hook`, a ``TorchFunctionMode`` installed only
while the tensor checker, the operator statistics or
``FLAGS_check_nan_inf`` is on. Op names are torch's (``matmul``,
``add``, ``softmax``), which is what ``checked_op_list`` /
``skipped_op_list`` and the statistics' keys hold. While a CUDA stream
captures a graph or ``jit.to_static`` stages a function, the checker
reads nothing back (JAX skips tracers, ``debugging.py:83-85``), so a
staged step under an enabled checker is still one graph.
"""
from __future__ import annotations

import contextlib
import functools
from enum import Enum

import numpy as np
import torch

from ..core import op_hook

__all__ = ["DebugMode", "TensorCheckerConfig", "check_numerics",
           "enable_tensor_checker", "disable_tensor_checker",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "compare_accuracy", "check_layer_numerics"]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    """Reference: debugging.py TensorCheckerConfig."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self.debug_step = debug_step


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """-> (NaN count, Inf count, zero count) as int64 tensors; raises
    ``FloatingPointError`` on a NaN or Inf when the mode aborts."""
    t = tensor if torch.is_tensor(tensor) else torch.as_tensor(tensor)
    n_nan = torch.isnan(t).sum().to(torch.int64)
    n_inf = torch.isinf(t).sum().to(torch.int64)
    n_zero = (t == 0).sum().to(torch.int64)
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        bad = int(n_nan) + int(n_inf)
        if bad:
            raise FloatingPointError(
                f"(check_numerics) op={op_type!r} var={var_name!r}: "
                f"{int(n_nan)} NaN, {int(n_inf)} Inf values")
    return n_nan, n_inf, n_zero


_checker_config = None
_checker_hook = None
_op_stats = None
_stats_hook = None


def _check(name, args, kwargs, result):
    cfg = _checker_config
    if cfg is None or not cfg.enable:
        return
    if cfg.checked_op_list and name not in cfg.checked_op_list:
        return
    if name in cfg.skipped_op_list or not op_hook.checkable(name):
        return
    for r in op_hook.tensors_of(result):
        if not r.is_floating_point():
            continue
        if not bool(torch.isfinite(r).all()):
            msg = f"(tensor_checker) op '{name}' produced NaN/Inf"
            if cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                raise FloatingPointError(msg)
            print(msg)


def enable_tensor_checker(checker_config):
    """Every op's floating outputs are checked for NaN / Inf as the config
    says (reference: debugging.py enable_tensor_checker)."""
    global _checker_config, _checker_hook
    _checker_config = checker_config
    if _checker_hook is None:
        _checker_hook = op_hook.add_hook(_check)


def disable_tensor_checker():
    global _checker_config, _checker_hook
    if _checker_hook is not None:
        op_hook.remove_hook(_checker_hook)
    _checker_config = _checker_hook = None


def _count(name, args, kwargs, result):
    dt = ""
    for t in args:
        if torch.is_tensor(t):
            dt = str(t.dtype)
            break
    key = (name, dt)
    _op_stats[key] = _op_stats.get(key, 0) + 1


def enable_operator_stats_collection():
    """Count every op by (name, its first tensor input's dtype)."""
    global _op_stats, _stats_hook
    _op_stats = {}
    if _stats_hook is None:
        _stats_hook = op_hook.add_hook(_count)


def disable_operator_stats_collection():
    """Stop counting; print and return ``{(op, dtype): calls}``."""
    global _stats_hook
    if _stats_hook is not None:
        op_hook.remove_hook(_stats_hook)
        _stats_hook = None
    stats = _op_stats or {}
    if stats:
        print("<------- op list (op, dtype, calls) ------->")
        for (name, dt), n in sorted(stats.items()):
            print(f"  {name:30s} {dt:18s} {n}")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Compare two runs' saved tensor dumps (``paddle.save``'d dicts of name
    -> tensor) and write a csv of each tensor's max abs / rel error."""
    from ..framework import load as _load
    a = _load(dump_path, device="cpu")
    b = _load(another_dump_path, device="cpu")
    rows = ["tensor,max_abs_err,max_rel_err"]
    for k in sorted(set(a) & set(b)):
        va, vb = (np.asarray(x.detach().cpu().double().numpy()
                             if torch.is_tensor(x) else x, np.float64)
                  for x in (a[k], b[k]))
        if va.shape != vb.shape:
            rows.append(f"{k},shape-mismatch,shape-mismatch")
            continue
        abs_err = np.max(np.abs(va - vb)) if va.size else 0.0
        rel = np.max(np.abs(va - vb) / (np.abs(vb) + 1e-12)) \
            if va.size else 0.0
        rows.append(f"{k},{abs_err:.6e},{rel:.6e}")
    with open(output_filename, "w") as f:
        f.write("\n".join(rows) + "\n")
    return output_filename


def check_layer_numerics(func):
    """Decorates a ``Layer.forward`` so its tensor inputs and outputs are
    checked by :func:`check_numerics`."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        for i, a in enumerate(args):
            if torch.is_tensor(a):
                check_numerics(a, op_type=type(self).__name__,
                               var_name=f"input{i}")
        out = func(self, *args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            if torch.is_tensor(o):
                check_numerics(o, op_type=type(self).__name__,
                               var_name=f"output{i}")
        return out

    return wrapper
