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
sends them all, since the two agree up to f32 rounding. Adam folds an L2
``weight_decay`` into the gradient (``optimizer.py:137-138``); AdamW
decays decoupled, per parameter, unless ``apply_decay_param_fun(name)``
says no (the port's GPT parameters carry their structured name as
``.param_name``).
"""
from __future__ import annotations

from ..ops.kernels import fused_adamw
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    """Reference: python/paddle/optimizer/adam.py."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None):
        super().__init__(learning_rate, parameters, weight_decay)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _decay(self, p, group):
        """-> ``(l2, wd)``: the coupled L2 coefficient folded into the
        gradient and the decoupled decay of the update."""
        wd = group.get("weight_decay", self.regularization)
        return (0.0 if wd is None else float(wd)), 0.0

    def _apply(self, items):
        ws, gs, ms, vs, lrs, wds, bc1s, bc2s = ([] for _ in range(8))
        for p, lr, group in items:
            if not p.is_floating_point():
                raise TypeError(f"Adam updates floating parameters, got "
                                f"{p.dtype}")
            l2, wd = self._decay(p, group)
            g = p.grad
            if l2:
                g = g + l2 * p
            t = self._get_accumulator("beta_pow", p, init=0.0) + 1.0
            self._set_accumulator("beta_pow", p, t)
            ws.append(p)
            gs.append(g)
            ms.append(self._get_accumulator("moment1", p))
            vs.append(self._get_accumulator("moment2", p))
            lrs.append(lr)
            wds.append(wd)
            bc1s.append(1.0 / (1.0 - self._beta1 ** t))
            bc2s.append(1.0 / (1.0 - self._beta2 ** t))
        fused_adamw(ws, gs, ms, vs, lrs, self._beta1, self._beta2,
                    self._epsilon, wds, bc1s, bc2s)


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/
    adamw.py): ``w <- w - lr * wd * w`` outside the adaptive update, in
    the same kernel pass."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None)
        self._decay_coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, p, group):
        wd = float(group.get("weight_decay", self._decay_coeff))
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(getattr(p, "param_name", None)):
            wd = 0.0
        return 0.0, wd
