"""Higher-order functional autograd: ``jacobian``, ``hessian``, ``vjp`` and
``jvp`` (``paddle_tpu/autograd/functional.py``; reference:
python/paddle/incubate/autograd/functional.py).

``func`` takes and returns tensors. ``jacobian`` and ``hessian`` take
torch's non-vectorised ``torch.autograd.functional`` path, one backward
per output element: ``torch.func.jacrev`` would ``vmap`` the backward,
which the port's kernel ``autograd.Function``s (``ctypes`` calls into
the hand kernels) cannot take. Their ``create_graph=True`` raises, as
JAX's does (``functional.py:37-42``, ``:55-58``). ``vjp`` is one
backward. ``jvp`` is forward mode (``torch.autograd.forward_ad``): a
kernel ``autograd.Function`` has no forward-mode rule, as a JAX
custom-VJP kernel has none, and ``jvp`` raises where it meets one rather
than return tangents from another rule.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["jacobian", "hessian", "vjp", "jvp"]


def _unpack(xs):
    single = torch.is_tensor(xs)
    return single, [xs] if single else list(xs)


def _inputs(xs_list):
    return [x.detach().requires_grad_(x.is_floating_point())
            for x in xs_list]


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """d func / d xs as full matrices, reverse mode: a tensor for one
    input, else a list with one per input."""
    if create_graph:
        raise NotImplementedError(
            "jacobian(create_graph=True) is not supported, as in the JAX "
            "package: the result is not on the tape. Chain "
            "paddle.grad(..., create_graph=True) for differentiable "
            "derivatives.")
    single, xs_list = _unpack(xs)
    jac = torch.autograd.functional.jacobian(
        func, tuple(x.detach() for x in xs_list), vectorize=False)
    outs = [j.detach() for j in jac]
    return outs[0] if single else outs


def hessian(func, xs, create_graph=False, allow_unused=False):
    """d^2 func / d xs^2 of a scalar ``func``: a tensor for one input,
    else a list of lists."""
    if create_graph:
        raise NotImplementedError(
            "hessian(create_graph=True) is not supported, as in the JAX "
            "package — chain paddle.grad(..., create_graph=True) instead.")
    single, xs_list = _unpack(xs)
    hess = torch.autograd.functional.hessian(
        func, tuple(x.detach() for x in xs_list), vectorize=False)
    if single:
        return hess[0][0].detach()
    return [[h.detach() for h in row] for row in hess]


def vjp(func, xs, v=None):
    """-> (outputs, the vector-Jacobian product): ``v`` defaults to ones
    of each output's shape."""
    single, xs_list = _unpack(xs)
    ins = _inputs(xs_list)
    with torch.enable_grad():
        out = func(*ins)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if v is None:
        cots = [torch.ones_like(o) for o in outs]
    else:
        cots = [v] if torch.is_tensor(v) else list(v)
    diff = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    wrt = [x for x in ins if x.requires_grad]
    found = {}
    if diff and wrt:
        found = dict(zip(map(id, wrt), torch.autograd.grad(
            [o for o, _ in diff], wrt, [c for _, c in diff],
            allow_unused=True)))
    gs = [torch.zeros_like(x) if found.get(id(x)) is None else found[id(x)]
          for x in ins]
    o = [t.detach() for t in outs]
    return (tuple(o) if isinstance(out, (tuple, list)) else o[0]), \
        (gs[0] if single else gs)


def jvp(func, xs, v=None):
    """-> (outputs, the Jacobian-vector product), forward mode: ``v``
    defaults to ones of each input's shape."""
    single, xs_list = _unpack(xs)
    if v is None:
        tangents = [torch.ones_like(x) for x in xs_list]
    else:
        tangents = [v] if torch.is_tensor(v) else list(v)
    try:
        with fwAD.dual_level():
            duals = [fwAD.make_dual(x.detach(), t.to(x.dtype))
                     for x, t in zip(xs_list, tangents)]
            out = func(*duals)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            unpacked = [fwAD.unpack_dual(o) for o in outs]
    except NotImplementedError as e:
        raise NotImplementedError(
            "jvp met an op without a forward-mode rule — a kernel "
            "autograd.Function of the port (the JAX package's custom-VJP "
            "kernels have none either); take the derivative in reverse mode "
            f"(vjp / jacobian) instead. ({e})") from e
    prim = [p.detach() for p, _ in unpacked]
    tan = [torch.zeros_like(p) if t is None else t.detach()
           for p, t in unpacked]
    if isinstance(out, (tuple, list)):
        return tuple(prim), tuple(tan)
    return prim[0], tan[0]
