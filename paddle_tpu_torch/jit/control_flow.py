"""Tensor-dependent control flow: ``cond``, ``while_loop``, ``scan_loop``,
``case`` and ``switch_case``, after ``paddle_tpu/jit/control_flow.py``
(reference: python/paddle/static/nn/control_flow.py cond:1153,
while_loop:1384).

**A concrete predicate** (an eager call) runs as plain Python, as in JAX
(``:134-139``, ``:219-230``): the predicate is read on the host, one
branch runs, the loop loops, all on the eager tape.

**While a program is staged** (``jit.to_static``'s staging and capture
calls, a CUDA stream capture, or an export) the predicate must not be
read on the host, which would break the graph. JAX lowers to
``lax.cond`` / ``lax.while_loop``; a CUDA graph has no branch, so here:

* ``cond`` runs both branches and selects each output with
  ``torch.where`` on the device predicate. For the effect-free branches
  that JAX demands (``:145-148``) that equals ``lax.cond``'s result and
  gradient, with one caveat, the masked unroll's (``:212-216``): a NaN or
  Inf in the gradient of the branch not taken poisons ``where``'s
  backward (0 * NaN). Both branches launch their kernels on every replay.
  JAX's errors stay: a missing branch, branches of different structure,
  branches with no tensor output.
* ``while_loop(..., max_steps=N)`` is the masked unroll of
  ``_while_loop_grad`` (``:282-332``): N steps, each evaluating the
  predicate on the device and keeping the state where the loop has
  stopped, so the result and its gradient equal the loop's for any trip
  count <= N. It is differentiable and captured. (JAX takes an early-exit
  ``lax.while_loop`` under ``no_grad``; a graph cannot exit early, so the
  port unrolls there too, with the same values.)
* ``while_loop`` with no bound reads its predicate on the host each step
  (the CUDA graphs of this torch build offer no conditional node that the
  port uses): where a program is traced or captured that read is a
  :class:`~.api.GraphBreak`, and the call runs eagerly with the same
  values; in ``to_static``'s warm-up call on the card, which really runs,
  it is Python's read (:func:`read_staged`). JAX's refusal to
  differentiate an unbounded traced loop (``:244-251``) stays.
* ``scan_loop`` is a Python unroll of ``n_steps``, captured whole.
"""
from __future__ import annotations

import torch

from .api import (GraphBreak, _tree_flatten, _tree_rebuild,
                  host_reads_break, is_staging)

__all__ = ["cond", "while_loop", "scan_loop", "case", "switch_case"]


def staged():
    """True where a predicate may not be read on the host: ``to_static``
    stages or captures, a stream captures, or an export traces."""
    return (is_staging() or torch.compiler.is_exporting()
            or (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()))


def _flatten(out):
    tensors: list = []
    return tensors, _tree_flatten(out, tensors)


def _sig(skel, tensors):
    return (repr(skel), tuple((tuple(t.shape), str(t.dtype))
                              for t in tensors))


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _check_same_state(skel, tensors, out, what):
    """Body outputs must match the loop variables' structure, shapes and
    dtypes -> the output tensors."""
    new_tensors, new_skel = _flatten(_as_list(out))
    if _sig(new_skel, new_tensors) != _sig(skel, tensors):
        raise ValueError(
            f"{what} must return the same structure/shapes as loop_vars: "
            f"{_sig(skel, tensors)} vs {_sig(new_skel, new_tensors)}")
    return new_tensors


def _pred(p, like=None):
    """A predicate as a 0-d bool tensor on the device of ``like``."""
    if not isinstance(p, torch.Tensor):
        dev = like.device if like is not None else None
        return torch.full((), bool(p), dtype=torch.bool, device=dev)
    return p.reshape(()).bool()


def _read(p):
    """An eager predicate's value on the host."""
    return bool(p.reshape(()).item()) if isinstance(p, torch.Tensor) \
        else bool(p)


def read_staged(p, why):
    """A staged predicate that only the host can act on, read as Python
    reads it where the call really runs (``to_static``'s warm-up on the
    card); where a program is traced or captured the read raises
    :class:`~.api.GraphBreak` (``why``) before anything it guards has run,
    and ``to_static`` runs the call eagerly."""
    if (host_reads_break() or torch.compiler.is_exporting()
            or (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())):
        raise GraphBreak(why)
    return _read(p)


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """Reference: paddle.static.nn.cond (control_flow.py:1153). Branches
    take no arguments and may close over any tensor in scope; staged, both
    must return the same structure (shapes and dtypes too)."""
    if not (isinstance(pred, torch.Tensor) and staged()):
        fn = true_fn if _read(pred) else false_fn
        return fn() if fn is not None else None
    if true_fn is None or false_fn is None:
        raise ValueError(
            "cond over a traced predicate requires both true_fn and "
            "false_fn (both branches run, and the predicate selects)")
    t_tensors, t_skel = _flatten(true_fn())
    f_tensors, f_skel = _flatten(false_fn())
    if _sig(t_skel, t_tensors) != _sig(f_skel, f_tensors):
        raise ValueError(
            "cond branches must return the same structure/shapes/dtypes: "
            f"true_fn -> {_sig(t_skel, t_tensors)}, "
            f"false_fn -> {_sig(f_skel, f_tensors)}")
    if not t_tensors:
        raise ValueError(
            "cond over a traced predicate requires the branches to return "
            "at least one Tensor (a side-effect-only branch cannot be "
            "selected)")
    p = _pred(pred)
    return _tree_rebuild(t_skel, [torch.where(p, a, b)
                                  for a, b in zip(t_tensors, f_tensors)])


def _loop_state(loop_vars):
    as_seq = isinstance(loop_vars, (list, tuple))
    vars_list = list(loop_vars) if as_seq else [loop_vars]
    tensors, skel = _flatten(vars_list)
    return vars_list, tensors, skel, as_seq


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None,
               max_steps=None):
    """Reference: paddle.static.nn.while_loop (control_flow.py:1384).
    ``cond_fn(*loop_vars)`` -> a boolean tensor; ``body_fn(*loop_vars)``
    -> the loop variables of the next step (same structure and shapes).
    ``max_steps`` bounds the loop in every mode; staged, it is what makes
    the loop a captured, differentiable masked unroll (see the module)."""
    vars_list, tensors, skel, as_seq = _loop_state(loop_vars)
    if not staged():
        steps = 0
        while _read(cond_fn(*vars_list)):
            if max_steps is not None and steps >= max_steps:
                break   # the same hard bound as the staged unroll
            vars_list = _as_list(body_fn(*vars_list))
            steps += 1
        return vars_list if as_seq else vars_list[0]
    if max_steps is not None:
        return _masked_unroll(cond_fn, body_fn, vars_list, tensors, skel,
                              as_seq, int(max_steps))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "while_loop over traced tensors is forward-only (a staged "
            "loop without a bound cannot be differentiated). Pass "
            "max_steps=N for the differentiable masked-unroll path, wrap "
            "in paddle.no_grad(), mark loop vars stop_gradient, or use "
            "paddle.static.nn.scan_loop (bounded, differentiable).")
    why = ("while_loop without max_steps reads its predicate on the host "
           "each step; pass max_steps=N to stage it as a masked unroll")
    while read_staged(cond_fn(*vars_list), why):
        vars_list = _as_list(body_fn(*vars_list))
    return vars_list if as_seq else vars_list[0]


def _masked_unroll(cond_fn, body_fn, vars_list, tensors, skel, as_seq,
                   max_steps):
    """``max_steps`` steps; once the predicate is false the state passes
    through unchanged (``_while_loop_grad``)."""
    done = None
    state = tensors
    for _ in range(max_steps):
        vs = _tree_rebuild(skel, state)
        p = _pred(cond_fn(*vs), state[0] if state else None)
        done = ~p if done is None else done | ~p
        new = _check_same_state(skel, tensors, body_fn(*vs),
                                "while_loop body")
        state = [torch.where(done, o, n) for n, o in zip(new, state)]
    out = _tree_rebuild(skel, state)
    return out if as_seq else out[0]


def scan_loop(body_fn, loop_vars, n_steps, name=None):
    """A bounded, differentiable loop (no reference analog; JAX's
    ``lax.scan``): ``body_fn(step, *loop_vars)`` -> the next loop
    variables, run exactly ``n_steps`` times, ``step`` an int32 0-d tensor.
    Here a Python unroll, captured whole when staged."""
    vars_list, tensors, skel, as_seq = _loop_state(loop_vars)
    if not isinstance(n_steps, int):
        raise TypeError("scan_loop needs a static python int n_steps")
    dev = tensors[0].device if tensors else None
    state = tensors
    for i in range(n_steps):
        step = torch.full((), i, dtype=torch.int32, device=dev)
        state = _check_same_state(skel, tensors,
                                  body_fn(step, *_tree_rebuild(skel, state)),
                                  "scan_loop body")
    out = _tree_rebuild(skel, state)
    return out if as_seq else out[0]


def case(pred_fn_pairs, default=None, name=None):
    """Reference: paddle.static.nn.case — the first true predicate wins."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        return cond(pred, fn, fn if default is None else default)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference: paddle.static.nn.switch_case."""
    pairs = sorted(branch_fns.items()) if isinstance(branch_fns, dict) \
        else list(enumerate(branch_fns))
    if default is None:
        default = pairs[-1][1]
    if not isinstance(branch_index, torch.Tensor):
        return dict(pairs).get(int(branch_index), default)()
    idx = branch_index
    return case([(idx == torch.full_like(idx, i), fn) for i, fn in pairs],
                default)
