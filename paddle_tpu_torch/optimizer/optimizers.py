"""The optimizers of ``paddle_tpu/optimizer/optimizers.py`` (reference:
python/paddle/optimizer/{sgd,momentum,adam,adamw,adagrad,rmsprop,
adadelta,adamax,lamb,rprop,lbfgs}.py).

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
that has a gradient, carrying each tensor's own learning rate (the
group's times the parameter's ``ParamAttr`` scale), decoupled
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

The other optimizers of ``optimizers.py:201-583`` follow SGD's form:
:class:`Adagrad`, :class:`RMSProp` (``centered`` too), :class:`Adadelta`,
:class:`Adamax` and :class:`Lamb` are multi-tensor ops per param group,
with the accumulators and ``state_dict`` keys of the JAX package
(``moment``, ``mean_square``, ``mean_grad``, ``momentum``,
``avg_squared_grad``, ``avg_squared_update``, ``inf_norm``,
``beta1_pow``, ``moment1``, ``moment2``, ``beta_pow``), the same masters
and coupled decay; :class:`Rprop` (``prev``, ``learning_rates``) is an
elementwise ``where`` chain a tensor; :class:`LBFGS` runs on the host
through a closure, as in JAX.

In a staged step (``jit.to_static``) the multi-tensor optimizers multiply
by a 0-d lr tensor per param group and rate scale, and Adam/AdamW launch
from a static
table, each rewritten before every replay (``optimizer.py``'s staging
notes); Adamax's ``beta1_pow`` and Lamb's ``beta_pow`` are 0-d device
tensors that the step itself advances, and Lamb's trust ratios stay on
the device, so none of them is frozen at capture or read on the host.

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
from .optimizer import Optimizer, lr_scale

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb", "Rprop", "LBFGS"]


class _MultiTensor(Optimizer):
    """The optimizers whose update is a jnp expression in the JAX package:
    per param group, multi-tensor ops over its parameters (``_update``)."""

    def _apply(self, items):
        """Per param group: the gradients in the updated tensors' type with
        the coupled decay folded in (``optimizer.py:131-140``), the update,
        then each 16-bit parameter written as its master rounded."""
        groups = {}
        for p, g, lr, group in items:
            key = (id(group), lr_scale(p))
            groups.setdefault(key, (group, key[1], lr, [], []))
            groups[key][3].append(p)
            groups[key][4].append(g)
        for group, scale, lr, ps, gs in groups.values():
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
                lr = self._lr_tensor(group, scale, lr, ws[0].device)
            self._update(ps, ws, gs, lr)
            masters = [(p, w) for p, w in zip(ps, ws) if w is not p]
            if masters:
                torch._foreach_copy_([p for p, _ in masters],
                                     [w for _, w in masters])

    def _update(self, ps, ws, gs, lr):
        """Update the tensors ``ws`` (masters or parameters) of ``ps`` in
        place from their gradients ``gs`` at learning rate ``lr`` (a float,
        or a 0-d tensor in a staged step). Subclasses implement."""
        raise NotImplementedError

    def _lr_tensor(self, group, scale, lr, device):
        """The staged step's 0-d f32 lr of ``group``'s parameters whose
        rate scale is ``scale``: made at the step's eager first call and
        written with ``lr`` there; under a capture only read (each
        replay's value comes from :meth:`_replay_scalars`)."""
        bufs = self._staged.setdefault("lr", {})
        key = (id(group), scale)
        if key not in bufs:
            bufs[key] = (group, scale, torch.empty(
                (), dtype=torch.float32, device=device))
        buf = bufs[key][2]
        if not (buf.is_cuda and torch.cuda.is_current_stream_capturing()):
            buf.fill_(lr)
        return buf

    def _replay_scalars(self, store):
        for group, scale, buf in store.get("lr", {}).values():
            buf.fill_(self.get_lr() * float(group.get("learning_rate", 1.0))
                      * scale)


class SGD(_MultiTensor):
    """Reference: python/paddle/optimizer/sgd.py."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, ps, ws, gs, lr):
        torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))


class Momentum(_MultiTensor):
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
                group.get("learning_rate", 1.0)) * lr_scale(p))
                for p, group in rows]
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


# ---- the other optimizers of paddle_tpu/optimizer/optimizers.py:201-583 --
class Adagrad(_MultiTensor):
    """Reference: python/paddle/optimizer/adagrad.py: ``moment += g^2``,
    ``w -= lr g / (sqrt(moment) + epsilon)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _materialize_param(self, p):
        self._get_accumulator("moment", p, fill=self._initial)

    def _update(self, ps, ws, gs, lr):
        accs = [self._get_accumulator("moment", p, fill=self._initial)
                for p in ps]
        torch._foreach_add_(accs, torch._foreach_mul(gs, gs))
        denom = torch._foreach_sqrt(accs)
        torch._foreach_add_(denom, self._epsilon)
        step = torch._foreach_mul(gs, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(ws, step)


class RMSProp(_MultiTensor):
    """Reference: python/paddle/optimizer/rmsprop.py: ``mean_square``
    (and, ``centered``, ``mean_grad``) by ``rho``; the learning rate sits
    inside the ``momentum`` accumulator (``optimizers.py:243``):
    ``mom = momentum mom + lr g / sqrt(ms [- mg^2] + epsilon)``,
    ``w -= mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _materialize_param(self, p):
        self._get_accumulator("mean_square", p)
        self._get_accumulator("momentum", p)
        if self._centered:
            self._get_accumulator("mean_grad", p)

    def _update(self, ps, ws, gs, lr):
        rho = self._rho
        ms = [self._get_accumulator("mean_square", p) for p in ps]
        torch._foreach_mul_(ms, rho)
        torch._foreach_add_(ms, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - rho), gs))
        if self._centered:
            mg = [self._get_accumulator("mean_grad", p) for p in ps]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(gs, 1 - rho))
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        mom = [self._get_accumulator("momentum", p) for p in ps]
        torch._foreach_mul_(mom, self._momentum)
        step = torch._foreach_mul(gs, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(ws, mom)


class Adadelta(_MultiTensor):
    """Reference: python/paddle/optimizer/adadelta.py:
    ``update = sqrt(avg_squared_update + eps) / sqrt(avg_squared_grad +
    eps) g`` with both averages by ``rho``, ``w -= lr update``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._rho = rho

    def _materialize_param(self, p):
        self._get_accumulator("avg_squared_grad", p)
        self._get_accumulator("avg_squared_update", p)

    def _update(self, ps, ws, gs, lr):
        rho, eps = self._rho, self._epsilon
        sq = [self._get_accumulator("avg_squared_grad", p) for p in ps]
        up = [self._get_accumulator("avg_squared_update", p) for p in ps]
        torch._foreach_mul_(sq, rho)
        torch._foreach_add_(sq, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - rho), gs))
        update = torch._foreach_sqrt(torch._foreach_add(up, eps))
        torch._foreach_div_(update, torch._foreach_sqrt(
            torch._foreach_add(sq, eps)))
        torch._foreach_mul_(update, gs)
        torch._foreach_mul_(up, rho)
        torch._foreach_add_(up, torch._foreach_mul(
            torch._foreach_mul(update, 1 - rho), update))
        torch._foreach_sub_(ws, torch._foreach_mul(update, lr))


class Adamax(_MultiTensor):
    """Reference: python/paddle/optimizer/adamax.py: ``moment`` by
    ``beta1``, ``inf_norm = max(beta2 inf_norm, |g|)``, ``w -= lr / (1 -
    beta1_pow) moment / (inf_norm + epsilon)``. ``beta1_pow`` is a 0-d f32
    tensor on the parameter's device (``optimizers.py:282-290``), so a
    replayed step advances it on the card."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _materialize_param(self, p):
        self._get_accumulator("moment", p)
        self._get_accumulator("inf_norm", p)
        self._get_accumulator("beta1_pow", p, fill=1.0, shape=())

    def _update(self, ps, ws, gs, lr):
        b1 = self._beta1
        ms = [self._get_accumulator("moment", p) for p in ps]
        us = [self._get_accumulator("inf_norm", p) for p in ps]
        ts = [self._get_accumulator("beta1_pow", p, fill=1.0, shape=())
              for p in ps]
        torch._foreach_mul_(ts, b1)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(us, self._beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        t = torch.stack(ts)
        if not torch.is_tensor(lr):      # a tensor divided, as staged
            lr = torch.full((), lr, dtype=t.dtype, device=t.device)
        coef = torch.div(lr, 1 - t)
        step = torch._foreach_mul(ms, list(coef.unbind()))
        torch._foreach_div_(step, torch._foreach_add(us, self._epsilon))
        torch._foreach_sub_(ws, step)


class Lamb(_MultiTensor):
    """Reference: python/paddle/optimizer/lamb.py: Adam's moments with
    bias corrections from ``beta_pow`` (a 0-d f32 step count on the
    parameter's device, ``optimizers.py:306-320``), ``update = r + wd w``
    (``wd`` 0 where ``exclude_from_weight_decay_fn(param)`` says so), and
    each tensor's step scaled by its trust ratio ``|w| / |update|`` (1
    where either norm is 0; ``:323-327``). The norms are
    ``torch._foreach_norm`` and the ratio a ``torch.where`` on the device:
    no host read, so a staged step replays it, as JAX stages it."""

    _HOST_SCALARS = frozenset()

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _materialize_param(self, p):
        self._get_accumulator("moment1", p)
        self._get_accumulator("moment2", p)
        self._get_accumulator("beta_pow", p, shape=())

    def _update(self, ps, ws, gs, lr):
        b1, b2 = self._beta1, self._beta2
        ms = [self._get_accumulator("moment1", p) for p in ps]
        vs = [self._get_accumulator("moment2", p) for p in ps]
        ts = [self._get_accumulator("beta_pow", p, shape=()) for p in ps]
        torch._foreach_add_(ts, 1.0)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - b2), gs))
        t = torch.stack(ts)
        bc1 = list((1 - torch.pow(b1, t)).unbind())
        bc2 = list((1 - torch.pow(b2, t)).unbind())
        r = torch._foreach_div(ms, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_div_(r, denom)
        fn = self._exclude_fn
        wds = [0.0 if fn is not None and fn(p) else self._wd for p in ps]
        update = torch._foreach_add(r, torch._foreach_mul(ws, wds))
        w_norm = torch.stack(torch._foreach_norm(ws))
        u_norm = torch.stack(torch._foreach_norm(update))
        one = torch.ones_like(w_norm)
        trust = torch.where(w_norm > 0, torch.where(
            u_norm > 0, w_norm / u_norm, one), one)
        scale = list((lr * trust).unbind())
        torch._foreach_sub_(ws, torch._foreach_mul(update, scale))


class Rprop(Optimizer):
    """Reference: python/paddle/optimizer/rprop.py (phi rprop_kernel.cc):
    per-element step sizes ``learning_rates`` (f32) grown by ``etas[1]``
    where the gradient keeps its sign, shrunk by ``etas[0]`` where it
    flips (and that element's step skipped, its ``prev`` gradient set to
    0), clipped to ``learning_rate_range``; ``w -= sign(g) lrs``. The
    learning rate only seeds the step sizes. A 16-bit parameter without
    masters is updated in its own type, where the JAX package returns an
    f32 array."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        if not (0.0 < learning_rate_range[0] <= learning_rate
                <= learning_rate_range[1]):
            raise ValueError(
                "'0.0 < learning_rate_range[0] <= learning_rate <= "
                "learning_rate_range[1]' must be true")
        if not 0.0 < etas[0] < 1.0 < etas[1]:
            raise ValueError("'0.0 < etas[0] < 1.0 < etas[1]' must be true")
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas
        self._initial_lr = learning_rate

    def _materialize_param(self, p):
        self._get_accumulator("prev", p)
        self._get_accumulator("learning_rates", p, fill=self._initial_lr)

    def _apply(self, items):
        for p, g, _, _ in items:
            w = self._master_of(p) if self._use_master(p) else p
            g = g.to(w.dtype)
            prev = self._get_accumulator("prev", p)
            lrs = self._get_accumulator("learning_rates", p,
                                        fill=self._initial_lr)
            prod = g * prev
            eta = torch.where(prod > 0, self._eta_plus, torch.where(
                prod < 0, self._eta_minus, 1.0))
            g_eff = torch.where(prod < 0, torch.zeros_like(g), g)
            lrs.copy_(torch.clamp(lrs * eta, self._lr_min, self._lr_max))
            prev.copy_(g_eff)
            w.sub_(torch.sign(g_eff) * lrs)
            if w is not p:
                p.copy_(w)


def _loss_of(closure):
    """The loss ``closure()`` returns (it runs its backward), as a float:
    a host read."""
    with torch.enable_grad():
        loss = closure()
    return float(loss.detach()) if torch.is_tensor(loss) else float(loss)


class LBFGS(Optimizer):
    """Reference: python/paddle/optimizer/lbfgs.py — limited-memory BFGS
    with a closure-driven ``step(closure)`` and an optional strong-Wolfe
    line search, driven from the host as in the JAX package
    (``optimizers.py:412-583``): every evaluation reads the loss and the
    directional derivatives with ``float()``, so under ``jit.to_static``
    its step is a graph break, as JAX's is. The closure clears the
    gradients, computes the loss, calls ``backward()`` and returns the
    loss; parameters are gathered into and scattered from one f32 vector."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._max_iter = max_iter
        self._max_eval = max_eval or max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None|'strong_wolfe'")
        self._line_search = line_search_fn
        self._state = {"old_dirs": [], "old_stps": [], "ro": [],
                       "prev_flat_grad": None, "H_diag": 1.0,
                       "n_evals": 0}

    # -- flat-vector helpers --
    def _gather(self, what):
        parts = []
        for p in self._parameter_list:
            a = p.grad if what == "grad" else p
            a = torch.zeros_like(p) if a is None else a
            parts.append(a.detach().reshape(-1).float())
        return torch.cat(parts) if parts else torch.zeros(0)

    @torch.no_grad()
    def _scatter_add(self, flat, alpha):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            upd = flat[off:off + n].reshape(p.shape)
            p.copy_(p.float() + alpha * upd)
            off += n

    @torch.no_grad()
    def _set_flat(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _evaluate(self, closure, flat_x0, d, t):
        self._scatter_add(d, t)
        loss = _loss_of(closure)
        grad = self._gather("grad")
        self._set_flat(flat_x0)          # x0 exactly
        self._state["n_evals"] += 1
        return loss, grad

    def step(self, closure=None):
        if closure is None:
            raise RuntimeError(
                "LBFGS.step requires a closure that re-evaluates the "
                "model, calls loss.backward() and returns the loss "
                "(reference lbfgs.py)")
        st = self._state
        lr = self.get_lr()
        loss = _loss_of(closure)
        flat_grad = self._gather("grad")
        if float(flat_grad.abs().max()) <= self._tol_grad:
            return loss

        for _ in range(self._max_iter):
            # direction: two-loop recursion over the (s, y) history
            if st["prev_flat_grad"] is None:
                d = -flat_grad
                st["H_diag"] = 1.0
            else:
                y = flat_grad - st["prev_flat_grad"]
                s = st["last_step"]
                ys = float(torch.dot(y, s))
                if ys > 1e-10:
                    if len(st["old_dirs"]) >= self._history_size:
                        st["old_dirs"].pop(0)
                        st["old_stps"].pop(0)
                        st["ro"].pop(0)
                    st["old_dirs"].append(y)
                    st["old_stps"].append(s)
                    st["ro"].append(1.0 / ys)
                    st["H_diag"] = ys / float(torch.dot(y, y))
                q = -flat_grad
                al = []
                for s_i, y_i, ro_i in zip(reversed(st["old_stps"]),
                                          reversed(st["old_dirs"]),
                                          reversed(st["ro"])):
                    a_i = ro_i * float(torch.dot(s_i, q))
                    al.append(a_i)
                    q = q - a_i * y_i
                d = q * st["H_diag"]
                for (s_i, y_i, ro_i), a_i in zip(
                        zip(st["old_stps"], st["old_dirs"], st["ro"]),
                        reversed(al)):
                    b_i = ro_i * float(torch.dot(y_i, d))
                    d = d + s_i * (a_i - b_i)
            st["prev_flat_grad"] = flat_grad

            gtd = float(torch.dot(flat_grad, d))
            if gtd > -self._tol_change:
                break
            t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr \
                if not st["old_dirs"] else lr

            if self._line_search == "strong_wolfe":
                x0 = self._gather("param")
                t, loss, flat_grad = self._strong_wolfe(
                    closure, x0, t, d, loss, flat_grad, gtd)
                self._scatter_add(d, t)
            else:
                self._scatter_add(d, t)
                loss = _loss_of(closure)
                flat_grad = self._gather("grad")
            st["last_step"] = d * t
            if st["n_evals"] >= self._max_eval:
                break
            if float(flat_grad.abs().max()) <= self._tol_grad:
                break
            if float((d * t).abs().max()) <= self._tol_change:
                break
        self.clear_grad()
        return loss

    def _strong_wolfe(self, closure, x0, t, d, f0, g0, gtd0,
                      c1=1e-4, c2=0.9, max_ls=25):
        """Strong-Wolfe line search (reference lbfgs.py _strong_wolfe,
        standard bracket + zoom)."""
        f_prev, g_prev, t_prev = f0, g0, 0.0
        f_new, g_new = self._evaluate(closure, x0, d, t)
        for _ in range(max_ls):
            gtd_new = float(torch.dot(g_new, d))
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_prev:
                return self._zoom(closure, x0, d, f0, gtd0, t_prev, t,
                                  f_prev, f_new, c1, c2)
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, g_new
            if gtd_new >= 0:
                return self._zoom(closure, x0, d, f0, gtd0, t, t_prev,
                                  f_new, f_prev, c1, c2)
            t_prev, f_prev, g_prev = t, f_new, g_new
            t = t * 2.0
            f_new, g_new = self._evaluate(closure, x0, d, t)
        return t, f_new, g_new

    def _zoom(self, closure, x0, d, f0, gtd0, lo, hi, f_lo, f_hi, c1, c2,
              max_zoom=25):
        g_best = None
        for _ in range(max_zoom):
            t = 0.5 * (lo + hi)
            f_new, g_new = self._evaluate(closure, x0, d, t)
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                hi, f_hi = t, f_new
            else:
                gtd_new = float(torch.dot(g_new, d))
                if abs(gtd_new) <= -c2 * gtd0:
                    return t, f_new, g_new
                if gtd_new * (hi - lo) >= 0:
                    hi, f_hi = lo, f_lo
                lo, f_lo, g_best = t, f_new, g_new
            if abs(hi - lo) < 1e-9:
                break
        if g_best is None:
            f_new, g_best = self._evaluate(closure, x0, d, lo)
            return lo, f_new, g_best
        return lo, f_lo, g_best
