"""GradScaler — dynamic loss scaling, after ``paddle_tpu/amp/
grad_scaler.py`` (reference: python/paddle/amp/grad_scaler.py:578).

With bf16 (f32's exponent range) scaling is rarely needed; with float16
(O2 ResNet-50, BASELINE config 2) it keeps small gradients from
underflowing. The full semantics are kept: ``scale`` multiplies the loss, ``unscale_`` divides
every gradient in place (in f32, stored back in its type) and finds
whether any is inf or nan, ``step`` skips the optimizer's step when one
is, and ``update`` grows the scale by ``incr_ratio`` after
``incr_every_n_steps`` good steps or backs it off by ``decr_ratio``
(never below 1) after ``decr_every_n_nan_or_inf`` bad ones. ``step`` does
not update the scale; ``minimize`` does both.

``unscale_`` makes one host sync for the whole parameter set, as the JAX
package does: each gradient's ``isfinite(g).all()`` stays on the device,
the flags are reduced together and read once, and one multi-tensor
multiply (``torch._foreach_mul_``, in f32 for bf16 and f16 gradients)
unscales them all.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._stepped = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        self._found_inf = False
        if grads:
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            with torch.no_grad():
                torch._foreach_mul_(grads, 1.0 / self._scale)
            self._found_inf = not bool(finite.all())
        self._unscaled = True

    def step(self, optimizer):
        """Unscale, then ``optimizer.step()`` unless a gradient is inf or
        nan. Raises if called twice without :meth:`update`."""
        if not self._enable:
            optimizer.step()
            return
        if self._stepped:
            raise RuntimeError(
                "GradScaler.step() has already been called since the last "
                "update(); call scaler.update() first.")
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._stepped = True

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if self._enable and self._dynamic:
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every_n_nan_or_inf:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._stepped = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, value):
        self._scale = float(value)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
