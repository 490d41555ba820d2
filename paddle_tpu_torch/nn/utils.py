"""``paddle.nn.utils`` (``paddle_tpu/nn/utils.py``): the weight
reparameterisations and the parameter and gradient helpers.

* :func:`weight_norm` replaces a layer's ``weight`` by the parameters
  ``weight_v`` (its value) and ``weight_g`` (its L2 norm over every axis
  but ``dim``; the whole norm when ``dim`` is None) and installs a
  forward pre-hook that sets ``weight = v * g / ||v||`` before each call,
  so gradients reach both; :func:`remove_weight_norm` folds it back into
  one ``weight`` parameter.
* :func:`spectral_norm` keeps ``weight_orig`` and a buffer ``weight_u``
  (numpy's ``RandomState(0)`` normal, normalised, as in JAX) and divides
  the weight by its largest singular value, estimated before each call
  by ``n_power_iterations`` of power iteration that update ``weight_u``
  in place outside autograd; ``dim`` defaults to 1 for ``Linear`` (its
  ``[in, out]`` weight), 0 otherwise.
* :func:`parameters_to_vector` concatenates the flattened parameters;
  :func:`vector_to_parameters` copies slices back into them in place.
* :func:`clip_grad_norm_` scales every ``.grad`` by ``min(max_norm /
  (norm + 1e-6), 1)`` and returns the norm (raising first, with
  ``error_if_nonfinite``, on an infinite or NaN norm);
  :func:`clip_grad_value_` clips each ``.grad`` to ``[-clip_value,
  clip_value]``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_except(w, dim):
    """L2 norm over every axis but ``dim`` (all of them when None)."""
    if dim is None:
        return torch.sqrt((w * w).sum())
    axes = [i for i in range(w.dim()) if i != dim]
    return torch.sqrt((w * w).sum(axes)) if axes else torch.sqrt(w * w)


def _along(t, w, dim):
    shape = [1] * w.dim()
    shape[dim] = -1
    return t.reshape(shape)


def _new_parameter(value):
    return Parameter(value.detach().clone())


class _WeightNormHook:
    def __init__(self, name, dim):
        self.name, self.dim = name, dim

    def compute(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        n = _norm_except(v, self.dim)
        if self.dim is None:
            return v * (g / n)
        return v * (_along(g, v, self.dim) / _along(n, v, self.dim))

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute(layer))


def weight_norm(layer, name="weight", dim=0):
    """``w = g * v / ||v||``, ``g`` and ``v`` the trainable parameters."""
    w = getattr(layer, name)
    del layer._parameters[name]
    with torch.no_grad():
        g = _norm_except(w, dim)
    layer.add_parameter(name + "_v", _new_parameter(w))
    layer.add_parameter(name + "_g", _new_parameter(g))
    hook = _WeightNormHook(name, dim)
    handle = layer.register_forward_pre_hook(hook)
    hooks = layer.__dict__.setdefault("_weight_norm_hooks", {})
    hooks[name] = (hook, handle)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    hook, handle = layer._weight_norm_hooks.pop(name)
    handle.remove()
    w = hook.compute(layer)
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, _new_parameter(w))
    return layer


class _SpectralNormHook:
    def __init__(self, name, n_power_iterations, eps, dim):
        self.name, self.n, self.eps, self.dim = (name, n_power_iterations,
                                                 eps, dim)

    def _matrix(self, w):
        m = w.movedim(self.dim, 0) if self.dim != 0 else w
        return m.reshape(m.shape[0], -1)

    def compute(self, layer):
        w = getattr(layer, self.name + "_orig")
        u = getattr(layer, self.name + "_u")
        with torch.no_grad():
            mat = self._matrix(w)
            uv = u
            for _ in range(self.n):
                v = mat.T @ uv
                v = v / (torch.linalg.vector_norm(v) + self.eps)
                uv = mat @ v
                uv = uv / (torch.linalg.vector_norm(uv) + self.eps)
            u.copy_(uv)
            uv, v = uv.clone(), v.clone()
        return w / (uv @ (self._matrix(w) @ v))

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute(layer))


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``w / sigma_max(w)`` by power iteration (the module's doc)."""
    w = getattr(layer, name)
    if dim is None:
        dim = 1 if type(layer).__name__ in (
            "Linear", "ColumnParallelLinear", "RowParallelLinear") else 0
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", _new_parameter(w))
    h = w.shape[dim]
    u0 = np.random.RandomState(0).randn(h).astype(
        str(w.dtype).replace("torch.", ""))
    u0 /= np.linalg.norm(u0) + eps
    layer.register_buffer(name + "_u", torch.as_tensor(u0, device=w.device))
    hook = _SpectralNormHook(name, n_power_iterations, eps, dim)
    handle = layer.register_forward_pre_hook(hook)
    hooks = layer.__dict__.setdefault("_spectral_norm_hooks", {})
    hooks[name] = (hook, handle)
    hook(layer, None)
    return layer


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    params = list(parameters)
    pos = 0
    for p in params:
        n = p.numel()
        p.copy_(vec[pos:pos + n].reshape(p.shape).to(p.dtype))
        pos += n
    return params


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    if torch.is_tensor(parameters):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), device=parameters[0].device if parameters
                           else None)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"the total norm of gradients is non-finite ({total}); set "
            "error_if_nonfinite=False to scale anyway")
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = p.grad * coef
    return total


def clip_grad_value_(parameters, clip_value):
    if torch.is_tensor(parameters):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)
