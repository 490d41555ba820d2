"""paddle_tpu_torch.autograd — the public autograd namespace
(``paddle_tpu/autograd/__init__.py``): ``backward``, ``grad`` and the
grad-mode switches of :mod:`..core.autograd`, ``PyLayer`` /
``PyLayerContext`` (:mod:`.py_layer`) and ``jacobian`` / ``hessian`` /
``vjp`` / ``jvp`` (:mod:`.functional`)."""
from ..core.autograd import (  # noqa: F401
    backward, enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = [
    "backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
    "set_grad_enabled", "PyLayer", "PyLayerContext", "jacobian", "hessian",
    "vjp", "jvp",
]
