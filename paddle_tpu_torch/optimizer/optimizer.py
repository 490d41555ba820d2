"""Optimizer base class, after ``paddle_tpu/optimizer/optimizer.py:24-262``
(reference: python/paddle/optimizer/optimizer.py).

Kept: explicit parameter lists or param groups (dicts with ``params`` and
optional ``learning_rate`` scale and ``weight_decay``); a float or an
:class:`~.lr.LRScheduler` as the learning rate (``set_lr`` raises
``RuntimeError`` under a scheduler; ``set_lr_scheduler``); ``grad_clip``,
applied to each param group's ``[(param, grad)]`` before its update; a
float, :class:`~..regularizer.L2Decay` or :class:`~..regularizer.L1Decay`
as ``weight_decay``, folded into the gradient; a ``step`` that skips
parameters with no gradient (or with ``requires_grad=False``) and counts
``_global_step``; ``clear_grad``, ``backward`` and ``minimize``; each
parameter's rate scaled by its ``ParamAttr(learning_rate=)``
(:func:`lr_scale`), a parameter with ``trainable=False``
(``requires_grad=False``) never updated; and
per-parameter accumulators by name (``moment1``, ``moment2``,
``beta_pow``, ... as the JAX optimizers name them).

**Master weights** (``multi_precision=True``, which ``amp.decorate``
turns on): a bf16 or f16 parameter is updated through an f32 master, made
on its first step from the parameter's current value (``_master_of``,
``:107-116``), with f32 accumulators; the parameter is then written as
the master rounded to its type. Without masters a parameter's accumulators
take its own type (``:96-102``), but for the step counts and Rprop's
step sizes, which the JAX package keeps in f32.

``state_dict`` is the JAX package's format (``:181-235``):
``f"{name}_{accumulator}"`` entries, ``master_weights`` by name,
``LR_Scheduler`` and ``global_step``; ``set_state_dict`` matches each
accumulator key to the parameter whose name is its longest prefix. A
parameter's name is its structured name (``param_name``, which the port's
GPT gives every parameter), or ``param_<i>`` by its place in the list.
The tensors of a ``state_dict`` are copies: later steps leave them alone,
as the JAX package's immutable arrays are left.

Unlike the JAX package, which rebinds each parameter to a new array, the
port's updates write parameters, masters and accumulators in place. Not
ported: the static-graph ``minimize`` and the distributed hooks.

**Staged steps** (``jit.to_static(step, capture=(model, opt))``,
``optimizer.py:237-262``): :meth:`materialize` creates every accumulator
and master up front and :meth:`_state_slots` lists them. While a step is
staged, ``_staged`` holds that step's store (a dict the staging keeps per
compiled step) and the updates keep their per-step host scalars on the
device: SGD, Momentum and the other multi-tensor optimizers multiply by
a 0-d lr tensor (Adamax and Lamb also keep their step counts as device
tensors, which every replay advances), Adam and AdamW launch from a
static :class:`~..ops.kernels.fused_adamw.AdamWTable`. A replay runs no
Python, so :meth:`_replay_step` does before each replay
what the step's host side would have done: it advances ``_global_step``
and each ``beta_pow`` once and rewrites the lr tensors and the AdamW
table from ``get_lr()``, so a scheduler's new lr reaches the graph, as
the JAX package passes ``lrs`` into its compiled step.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict

import torch

from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "lr_scale"]


def lr_scale(p):
    """``p``'s learning-rate scale: ``ParamAttr(learning_rate=)``, kept in
    ``p.optimize_attr`` (``optimizer.py:141-142``); 1 for a parameter
    without one."""
    attr = getattr(p, "optimize_attr", None)
    return float(attr.get("learning_rate", 1.0)) if attr else 1.0


class Optimizer:
    # accumulators kept in f32 whatever the parameter's type (step counts
    # and per-element step sizes), and those kept as host floats
    _F32_ACCUMULATORS = frozenset({"beta_pow", "beta1_pow",
                                   "learning_rates"})
    _HOST_SCALARS = frozenset({"beta_pow"})

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            from ..static import program as _sp
            if not _sp.in_static_mode():
                raise ValueError("parameters is required: pass "
                                 "model.parameters()")
            parameters = []   # minimize fills them from the Program
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
        self._learning_rate = learning_rate
        if not isinstance(learning_rate, LRScheduler):
            self.set_lr(learning_rate)
        self.regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        # accumulator name -> {parameter: value} and parameter -> f32
        # master, keyed by the parameter object itself (tensors hash by
        # identity)
        self._accumulators = defaultdict(dict)
        self._master_weights = {}
        self._global_step = 0
        # the store of the step jit.to_static is staging, or None
        self._staged = None

    # ---- learning rate ----
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is an LRScheduler; "
                "call scheduler.step() instead")
        if not isinstance(value, (int, float)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(value).__name__}")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        if not isinstance(scheduler, LRScheduler):
            raise TypeError(f"an LRScheduler expected, got "
                            f"{type(scheduler).__name__}")
        self._learning_rate = scheduler

    # ---- weight decay ----
    def _coupled_decay_coeff(self, group):
        """-> ``(l2, l1)``: the coefficients of ``w`` and ``sign(w)`` folded
        into the gradient. AdamW overrides it: its decay is decoupled."""
        wd = group.get("weight_decay", self.regularization)
        if wd is None:
            return 0.0, 0.0
        if isinstance(wd, L2Decay):
            return wd.coeff, 0.0
        if isinstance(wd, L1Decay):
            return 0.0, wd.coeff
        return float(wd), 0.0

    # ---- master weights and accumulators ----
    def _use_master(self, p):
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _master_of(self, p):
        """The f32 master of ``p``, made from its current value on first
        use."""
        if p not in self._master_weights:
            self._master_weights[p] = p.detach().float().clone()
        return self._master_weights[p]

    def _acc_dtype(self, p, name=None):
        if name in self._F32_ACCUMULATORS or self._use_master(p):
            return torch.float32
        return p.dtype

    def _get_accumulator(self, name, p, init=None, fill=0.0, shape=None):
        """The ``name`` accumulator of ``p``, created on first use: ``init``
        (a host value), or a tensor of ``fill`` on ``p``'s device, shaped
        like ``p`` (or ``shape``), f32 when ``name`` is one of
        ``_F32_ACCUMULATORS`` or ``p`` has a master, else ``p``'s type."""
        d = self._accumulators[name]
        if p not in d:
            d[p] = init if init is not None else torch.full(
                p.shape if shape is None else shape, fill,
                dtype=self._acc_dtype(p, name), device=p.device)
        return d[p]

    def _set_accumulator(self, name, p, value):
        self._accumulators[name][p] = value

    # ---- the step ----
    @torch.no_grad()
    def step(self):
        items = []
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.requires_grad and p.grad is not None]
            if not params_grads:
                continue
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            lr = self.get_lr() * float(group.get("learning_rate", 1.0))
            items += [(p, g, lr * lr_scale(p), group)
                      for p, g in params_grads if g is not None]
        if items:
            self._apply(items)
        self._global_step += 1
        if self._staged is not None:
            self._staged["steps"] = self._staged.get("steps", 0) + 1

    def _apply(self, items):
        """Update every ``(param, grad, lr, group)`` of ``items`` in place.
        Subclasses implement."""
        raise NotImplementedError

    # ---- staging (jit.to_static) ----
    def materialize(self):
        """Create every accumulator (and master weight) up front, so a
        staged step finds all its state before it is captured."""
        for group in self._param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                if self._use_master(p):
                    self._master_of(p)
                self._materialize_param(p)

    def _materialize_param(self, p):
        """Subclasses create their accumulators of ``p``."""

    def _state_slots(self):
        """``[(container, key)]`` of every accumulator and master: the
        state a staged step reads and writes."""
        slots = [(per, p) for per in self._accumulators.values()
                 for p in per]
        return slots + [(self._master_weights, p)
                        for p in self._master_weights]

    def _host_state(self):
        """A snapshot of the host side of the optimizer's state: the step
        count and the accumulator and master dicts' entries (beta_pow are
        host floats; tensors by reference)."""
        return (self._global_step,
                {n: dict(per) for n, per in self._accumulators.items()},
                dict(self._master_weights))

    def _set_host_state(self, state):
        """Put back a :meth:`_host_state` snapshot: entries made since are
        dropped."""
        self._global_step, accs, masters = state
        for name in list(self._accumulators):
            per = self._accumulators[name]
            per.clear()
            per.update(accs.get(name, {}))
        self._master_weights.clear()
        self._master_weights.update(masters)

    def _replay_step(self, store):
        """The host side of one replay of the staged step whose store is
        ``store``: advance the counters as its ``step`` calls did when it
        was captured, and rewrite its static device scalars."""
        self._replay_scalars(store)
        self._global_step += store.get("steps", 0)

    def _replay_scalars(self, store):
        """Subclasses rewrite the step's lr tensors or launch tables."""

    # ---- grads ----
    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient (set it to None, as the JAX
        package does whatever ``set_to_zero`` says)."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def backward(self, loss, retain_graph=False):
        loss.backward(retain_graph=retain_graph)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``backward`` then ``step`` (the dygraph form). -> (None, None).
        On a static program's loss it records the step, which
        ``Executor.run`` replays (``static/program.py``)."""
        from ..static import program as _sp
        if isinstance(loss, _sp.Variable):
            loss._program.minimize_ops.append((self, loss))
            return None, None
        self.backward(loss)
        self.step()
        return None, None

    # ---- state dict ----
    def _names(self):
        return {p: getattr(p, "param_name", None) or f"param_{i}"
                for i, p in enumerate(self._parameter_list)}

    def state_dict(self):
        """``f"{name}_{accumulator}"`` -> a copy of the accumulator (a
        float for ``beta_pow``), ``master_weights`` -> ``{name: copy}``,
        ``LR_Scheduler`` -> the scheduler's ``state_dict()``, and
        ``global_step``."""
        names = self._names()
        state = OrderedDict()
        for acc, per_param in self._accumulators.items():
            for p, value in per_param.items():
                if p in names:
                    state[f"{names[p]}_{acc}"] = (
                        value.detach().clone() if torch.is_tensor(value)
                        else value)
        if self._master_weights:
            state["master_weights"] = {
                names[p]: w.detach().clone()
                for p, w in self._master_weights.items() if p in names}
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        state["global_step"] = self._global_step
        return state

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load a :meth:`state_dict` (or one carried over from the JAX
        package by ``convert.opt_state_from_paddle_tpu``): values are
        copied into the accumulators and masters, on the parameters'
        devices; keys that name no parameter are skipped."""
        by_name = {name: p for p, name in self._names().items()}
        for key, value in state_dict.items():
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(value)
                continue
            if key == "global_step":
                self._global_step = int(value)
                continue
            if key == "master_weights":
                for pname, w in value.items():
                    p = by_name.get(pname)
                    if p is None:
                        continue
                    w = torch.as_tensor(w)
                    have = self._master_weights.get(p)
                    if have is not None and have.shape == w.shape:
                        # in place: a captured step's graph reads this
                        # storage (an in-process rewind restores into it)
                        have.copy_(w)
                    else:
                        self._master_weights[p] = w.to(
                            p.device, torch.float32).clone()
                continue
            # key = f"{param name}_{accumulator}": the longest name that is
            # a prefix, so "gpt.h.1..." never takes "gpt.h.10..."'s state
            matched = None
            for pname, p in by_name.items():
                if key.startswith(pname + "_") and (
                        matched is None or len(pname) > len(matched[0])):
                    matched = (pname, p)
            if matched is None:
                continue
            pname, p = matched
            acc = key[len(pname) + 1:]
            if acc in self._HOST_SCALARS:
                self._accumulators[acc][p] = float(value)
                continue
            value = torch.as_tensor(value)
            have = self._accumulators[acc].get(p)
            if have is not None and have.shape == value.shape:
                have.copy_(value)
            else:
                self._accumulators[acc][p] = value.to(
                    p.device, self._acc_dtype(p, acc)).clone()
