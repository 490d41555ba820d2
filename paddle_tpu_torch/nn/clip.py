"""Gradient clipping, after ``paddle_tpu/nn/clip.py`` (reference:
python/paddle/nn/clip.py).

An optimizer given ``grad_clip`` calls it on each param group's
``[(param, grad)]`` before the update and uses the grads it returns; the
parameters' own ``.grad`` stay as they were. Norms are taken in f32 over
the gradients in their own type, and each clipped gradient is scaled in
f32 and stored back in its type, as the JAX package does. A parameter
with ``need_clip = False`` is passed through and left out of the norms.
:class:`ClipGradByGlobalNorm` takes the global norm with one multi-tensor
reduction (``torch._foreach_norm``) and keeps the scale on the device: no
host sync, so every clip runs inside a staged step (``jit.to_static``).
The JAX clips are jnp, not Pallas kernels, so PyTorch's own ops do the
work here.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param, grad or None)]`` -> the same list with clipped
        grads."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every element into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(-max if min is None else min)

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own to an L2 norm of at most
    ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = torch.linalg.vector_norm(g, dtype=torch.float32)
                scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                                    max=1.0)
                g = _scaled(g, scale)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all the clipped gradients together."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        gs = [g for p, g in params_grads if _clipped(p, g)]
        if not gs:
            return params_grads
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(gs, 2, dtype=torch.float32)))
        scale = self.clip_norm / torch.clamp_min(norm, self.clip_norm)
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so that their
    ``norm_type`` norm together is at most ``max_norm`` (``paddle.nn.
    utils``): the scale is ``min(max_norm / (norm + 1e-6), 1)``. -> the
    norm before clipping (a device scalar). ``error_if_nonfinite`` is
    accepted and, as in the JAX package, not acted on."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    params = [p for p in parameters if p.grad is not None]
    if not params:
        # on the parameters' device: a staged step must not meet a CPU
        # tensor where it expects a device one
        return torch.zeros((), device=parameters[0].device if parameters
                           else None)
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total.float() + 1e-6), max=1.0)
    with torch.no_grad():
        for p in params:
            p.grad = _scaled(p.grad, scale)
    return total
