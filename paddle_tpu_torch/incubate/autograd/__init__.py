"""paddle.incubate.autograd (``paddle_tpu/incubate/autograd/__init__.py``;
reference: python/paddle/incubate/autograd): the functional derivatives
of :mod:`...autograd.functional`, ``forward_grad`` (``jvp`` with tangents
of ones by default), ``grad``, and the primitive switches, which are
always on, as in JAX."""
from ...autograd.functional import hessian, jacobian, jvp, vjp  # noqa: F401

Jacobian = jacobian
Hessian = hessian


def forward_grad(outputs, inputs, grad_inputs=None):
    """``jvp`` of the callable ``outputs`` at ``inputs`` (reference:
    incubate/autograd/primapi.py forward_grad) -> the tangents."""
    out, tangents = jvp(lambda *xs: outputs(*xs) if callable(outputs)
                        else outputs, inputs, grad_inputs)
    return tangents


def grad(outputs, inputs, grad_outputs=None):
    from ...core.autograd import grad as _grad
    return _grad(outputs, inputs, grad_outputs)


def enable_prim():
    return None


def disable_prim():
    return None


def prim_enabled():
    return True
