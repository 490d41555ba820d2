"""SGD, Momentum, Adam and AdamW, after ``paddle_tpu/optimizer/
optimizers.py:20-198`` (reference: python/paddle/optimizer/{sgd,momentum,
adam,adamw}.py).

:class:`SGD` (``w <- w - lr g``) and :class:`Momentum` (``v <- m v + g``,
then ``w <- w - lr v``, or ``w - lr (g + m v)`` with ``use_nesterov``; the
accumulator is named ``velocity``) are jnp expressions in the JAX
package, not Pallas kernels, so they are plain torch multi-tensor ops
(``torch._foreach_*``) here, in place, with the JAX expressions' order of
rounding. Both
fold an ``L2Decay`` / ``L1Decay`` (or a float) ``weight_decay`` into the
gradient and, under ``multi_precision``, update a 16-bit parameter
through its f32 master (an f32 velocity too) and write it back rounded.

``step`` makes **one launch** of the fused AdamW kernel
(:func:`~..ops.kernels.fused_adamw`, the port of
``paddle_tpu/ops/pallas/fused_adamw.py:60``) over every floating parameter
that has a gradient, carrying each tensor's own learning rate, decoupled
decay ``wd`` and bias corrections ``bc1 = 1/(1-b1^t)``,
``bc2 = 1/(1-b2^t)`` from its ``beta_pow`` step count. The JAX package
sends only parameters of at least ``_FUSED_MIN_SIZE`` (16384) elements to
its kernel and updates the rest with the same formula in jnp; the port
sends them all, since the two agree up to f32 rounding.

Each parameter goes in the kernel mode its state asks for: a bf16 or f16
parameter under ``multi_precision`` is a master-mode entry (its f32
master, f32 moments, and the parameter written in the same pass); a
16-bit parameter without masters keeps moments of its type; f32
parameters (f32 training and O1) are updated as they are. The gradient
goes as it is when it is 16-bit for an f32 master (exact in f32) and is
cast to the updated tensor's type otherwise, as ``optimizer.py:136``
casts it.

In a staged step (``jit.to_static``) SGD and Momentum multiply by a 0-d
lr tensor per param group and Adam/AdamW launch from a static table, each
rewritten before every replay (``optimizer.py``'s staging notes).

Adam folds an L2 ``weight_decay`` (a float or ``L2Decay``) or an
``L1Decay`` into the gradient (``optimizer.py:137-140``); AdamW decays
decoupled, per parameter, unless ``apply_decay_param_fun(name)`` says no
(the port's GPT parameters carry their structured name as
``.param_name``), with the learning rate scaled by ``lr_ratio(param)``
when given. ``lazy_mode`` (and Adam's ``use_multi_tensor``) is accepted,
as in the JAX package, and changes nothing.
"""
from __future__ import annotations

import torch

from ..ops.kernels import fused_adamw
from ..ops.kernels.fused_adamw import AdamWTable
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]


class SGD(Optimizer):
    """Reference: python/paddle/optimizer/sgd.py."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _apply(self, items):
        """Per param group, multi-tensor ops over its parameters: the
        gradients in the updated tensors' type with the coupled decay
        folded in (``optimizer.py:131-140``), the update, then each
        16-bit parameter written as its master rounded."""
        groups = {}
        for p, g, lr, group in items:
            groups.setdefault(id(group), (group, lr, [], []))
            groups[id(group)][2].append(p)
            groups[id(group)][3].append(g)
        for group, lr, ps, gs in groups.values():
            ws = [self._master_of(p) if self._use_master(p) else p
                  for p in ps]
            gs = [g.to(w.dtype) for g, w in zip(gs, ws)]
            l2, l1 = self._coupled_decay_coeff(group)
            if l2:
                gs = torch._foreach_add(gs, torch._foreach_mul(ws, l2))
            if l1:
                gs = torch._foreach_add(gs, torch._foreach_mul(
                    torch._foreach_sign(ws), l1))
            if self._staged is not None:
                lr = self._lr_tensor(group, lr, ws[0].device)
            self._update(ps, ws, gs, lr)
            masters = [(p, w) for p, w in zip(ps, ws) if w is not p]
            if masters:
                torch._foreach_copy_([p for p, _ in masters],
                                     [w for _, w in masters])

    def _update(self, ps, ws, gs, lr):
        torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))

    def _lr_tensor(self, group, lr, device):
        """The staged step's 0-d f32 lr of ``group``: made at the step's
        eager first call and written with ``lr`` there; under a capture
        only read (each replay's value comes from :meth:`_replay_scalars`)."""
        bufs = self._staged.setdefault("lr", {})
        if id(group) not in bufs:
            bufs[id(group)] = (group, torch.empty((), dtype=torch.float32,
                                                  device=device))
        buf = bufs[id(group)][1]
        if not (buf.is_cuda and torch.cuda.is_current_stream_capturing()):
            buf.fill_(lr)
        return buf

    def _replay_scalars(self, store):
        for group, buf in store.get("lr", {}).values():
            buf.fill_(self.get_lr() * float(group.get("learning_rate", 1.0)))


class Momentum(SGD):
    """Reference: python/paddle/optimizer/momentum.py."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _materialize_param(self, p):
        self._get_accumulator("velocity", p)

    def _update(self, ps, ws, gs, lr):
        vs = [self._get_accumulator("velocity", p) for p in ps]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        step = vs
        if self._use_nesterov:
            step = torch._foreach_add(gs, torch._foreach_mul(
                vs, self._momentum))
        torch._foreach_sub_(ws, torch._foreach_mul(step, lr))


class Adam(Optimizer):
    """Reference: python/paddle/optimizer/adam.py."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _decoupled(self, p, group, lr):
        """-> ``(lr, wd)``: the tensor's learning rate and decoupled
        decay (none for Adam)."""
        return lr, 0.0

    def _materialize_param(self, p):
        self._get_accumulator("moment1", p)
        self._get_accumulator("moment2", p)
        self._get_accumulator("beta_pow", p, init=0.0)

    def _scalars(self, p, group, lr):
        """``p``'s ``(lr, wd, bc1, bc2)`` for its next update, its
        ``beta_pow`` step count advanced by one."""
        lr, wd = self._decoupled(p, group, lr)
        t = self._get_accumulator("beta_pow", p, init=0.0) + 1.0
        self._set_accumulator("beta_pow", p, t)
        return (lr, wd, 1.0 / (1.0 - self._beta1 ** t),
                1.0 / (1.0 - self._beta2 ** t))

    def _apply(self, items):
        ws, gs, ms, vs, ps, scalars = ([] for _ in range(6))
        for p, g, lr, group in items:
            if not p.is_floating_point():
                raise TypeError(f"Adam updates floating parameters, got "
                                f"{p.dtype}")
            master = self._use_master(p)
            w = self._master_of(p) if master else p
            if not (master and g.dtype in (torch.bfloat16, torch.float16)):
                g = g.to(w.dtype)
            l2, l1 = self._coupled_decay_coeff(group)
            if l2:
                g = g.to(w.dtype) + l2 * w
            if l1:
                g = g.to(w.dtype) + l1 * torch.sign(w)
            ws.append(w)
            gs.append(g)
            ms.append(self._get_accumulator("moment1", p))
            vs.append(self._get_accumulator("moment2", p))
            ps.append(p if master else None)
            scalars.append(self._scalars(p, group, lr))
        lrs, wds, bc1s, bc2s = zip(*scalars)
        fused_adamw(ws, gs, ms, vs, lrs, self._beta1, self._beta2,
                    self._epsilon, wds, bc1s, bc2s, params=ps,
                    table=self._table(items, ws))

    def _table(self, items, ws):
        """A staged step's launch table for this ``_apply`` call (a step
        may call ``step`` more than once), its rows' ``(param, group)``
        recorded for :meth:`_replay_scalars`; None outside staging or on
        the CPU, where the plain version runs."""
        store = self._staged
        if store is None or not ws[0].is_cuda:
            return None
        tables = store.setdefault("adamw", [])
        i = store["calls"] = store.get("calls", 0) + 1
        if i > len(tables):
            tables.append((AdamWTable(), None))
        table = tables[i - 1][0]
        tables[i - 1] = (table, [(p, group) for p, _, _, group in items])
        return table

    def _replay_scalars(self, store):
        base = self.get_lr()
        for table, rows in store.get("adamw", []):
            scalars = [self._scalars(p, group, base * float(
                group.get("learning_rate", 1.0))) for p, group in rows]
            table.set_scalars(*zip(*scalars))
            table.upload()


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/
    adamw.py): ``w <- w - lr * wd * w`` outside the adaptive update, in
    the same kernel pass."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._decay_coeff = float(getattr(weight_decay, "coeff",
                                          weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _coupled_decay_coeff(self, group):
        return 0.0, 0.0               # the decay is decoupled

    def _decoupled(self, p, group, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        wd = group.get("weight_decay", self._decay_coeff)
        wd = float(getattr(wd, "coeff", wd))
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(getattr(p, "param_name", None)):
            wd = 0.0
        return lr, wd
