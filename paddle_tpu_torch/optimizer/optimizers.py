"""Adam and AdamW, after ``paddle_tpu/optimizer/optimizers.py:49-198``
(reference: python/paddle/optimizer/{adam,adamw}.py).

``step`` makes **one launch** of the fused AdamW kernel
(:func:`~..ops.kernels.fused_adamw`, the port of
``paddle_tpu/ops/pallas/fused_adamw.py:60``) over every floating parameter
that has a gradient, carrying each tensor's own learning rate, decoupled
decay ``wd`` and bias corrections ``bc1 = 1/(1-b1^t)``,
``bc2 = 1/(1-b2^t)`` from its ``beta_pow`` step count. The JAX package
sends only parameters of at least ``_FUSED_MIN_SIZE`` (16384) elements to
its kernel and updates the rest with the same formula in jnp; the port
sends them all, since the two agree up to f32 rounding.

Each parameter goes in the kernel mode its state asks for: a bf16
parameter under ``multi_precision`` is a master-mode entry (its f32
master, f32 moments, and the bf16 parameter written in the same pass); a
bf16 parameter without masters keeps bf16 moments; f32 parameters (f32
training and O1) are updated as they are. The gradient goes as it is when
it is bf16 for an f32 master (exact in f32) and is cast to the updated
tensor's type otherwise, as ``optimizer.py:136`` casts it.

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
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


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

    def _apply(self, items):
        ws, gs, ms, vs, ps, lrs, wds, bc1s, bc2s = ([] for _ in range(9))
        for p, g, lr, group in items:
            if not p.is_floating_point():
                raise TypeError(f"Adam updates floating parameters, got "
                                f"{p.dtype}")
            master = self._use_master(p)
            w = self._master_of(p) if master else p
            if not (master and g.dtype == torch.bfloat16):
                g = g.to(w.dtype)
            l2, l1 = self._coupled_decay_coeff(group)
            if l2:
                g = g.to(w.dtype) + l2 * w
            if l1:
                g = g.to(w.dtype) + l1 * torch.sign(w)
            lr, wd = self._decoupled(p, group, lr)
            t = self._get_accumulator("beta_pow", p, init=0.0) + 1.0
            self._set_accumulator("beta_pow", p, t)
            ws.append(w)
            gs.append(g)
            ms.append(self._get_accumulator("moment1", p))
            vs.append(self._get_accumulator("moment2", p))
            ps.append(p if master else None)
            lrs.append(lr)
            wds.append(wd)
            bc1s.append(1.0 / (1.0 - self._beta1 ** t))
            bc2s.append(1.0 / (1.0 - self._beta2 ** t))
        fused_adamw(ws, gs, ms, vs, lrs, self._beta1, self._beta2,
                    self._epsilon, wds, bc1s, bc2s, params=ps)


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
