"""Custom ops — ``custom_op`` and its registry (``paddle_tpu/utils/
cpp_extension.py``; reference: paddle/fluid/framework/custom_operator.cc,
python/paddle/utils/cpp_extension/, test/custom_op/).

A custom op is a Python function over torch tensors, registered under a
name. By default it differentiates by autograd through the function; a
user ``vjp(ct, *args, out=..., **attrs)``, returning one cotangent per
tensor argument in positional order, makes it a
``torch.autograd.Function`` with that backward. Tensors are positional;
keyword arguments are attributes. :meth:`CustomOp.check` is the golden
check: the output against a numpy reference and the gradient against
finite differences along a random direction.

``bind_method=True`` raises: the port binds no method onto
``torch.Tensor``. ``CppExtension``, ``CUDAExtension`` and ``load`` raise
as the JAX package's do: the port's own kernels are built by
``ops/kernels/_build.py``, and a user op is a torch function.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["custom_op", "CustomOp", "get_op", "registered_ops",
           "CppExtension", "CUDAExtension", "load"]

_REGISTRY: dict = {}


class _CustomVJP(torch.autograd.Function):
    """A custom op whose backward is the user's ``vjp``."""

    @staticmethod
    def forward(fctx, op, args, kwargs, slots, *tensors):
        merged = list(args)
        for i, t in zip(slots, tensors):
            merged[i] = t
        out = op.fn(*merged, **kwargs)
        outs = list(out) if isinstance(out, tuple) else [out]
        fctx.save_for_backward(*tensors, *outs)
        fctx.op, fctx.args, fctx.kwargs, fctx.slots = op, args, kwargs, slots
        fctx.n_out, fctx.is_tuple = len(outs), isinstance(out, tuple)
        return out

    @staticmethod
    def backward(fctx, *cts):
        op, saved = fctx.op, fctx.saved_tensors
        n_in = len(saved) - fctx.n_out
        merged = list(fctx.args)
        for i, t in zip(fctx.slots, saved[:n_in]):
            merged[i] = t
        outs = saved[n_in:]
        out = tuple(outs) if fctx.is_tuple else outs[0]
        ct = tuple(cts) if fctx.is_tuple else cts[0]
        res = op.vjp(ct, *merged, out=out, **fctx.kwargs)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        if len(res) != n_in:
            raise ValueError(
                f"custom op '{op.name}': vjp returned {len(res)} "
                f"cotangents for {n_in} tensor inputs")
        return (None, None, None, None, *res)


class CustomOp:
    """A registered custom op (reference: the OpMetaInfo record
    PD_BUILD_OP builds): ``fn(*args, **attrs)`` over torch tensors;
    ``vjp`` as the module says."""

    def __init__(self, name, fn, vjp=None, nout=1, golden=None):
        self.name = name
        self.fn = fn
        self.vjp = vjp
        self.nout = nout
        self.golden = golden
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        for k, v in kwargs.items():
            if torch.is_tensor(v):
                raise TypeError(
                    f"custom op '{self.name}': Tensor keyword argument "
                    f"'{k}' is not supported — pass tensors positionally "
                    "(keywords are attributes)")
        if self.vjp is None:
            return self.fn(*args, **kwargs)
        slots = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        return _CustomVJP.apply(self, args, kwargs, slots,
                                *[args[i] for i in slots])

    def check(self, *args, golden=None, rtol=1e-5, atol=1e-6, grad=True,
              eps=1e-3, seed=0, **kwargs):
        """The output against ``golden`` (numpy in, numpy out) and, for
        the arguments that record a gradient, the gradient against a
        central finite difference along a random direction. Raises on a
        mismatch."""
        golden = golden or self.golden
        out = self(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        if golden is not None:
            np_args = [a.detach().cpu().numpy() if torch.is_tensor(a) else a
                       for a in args]
            ref = golden(*np_args, **kwargs)
            refs = ref if isinstance(ref, tuple) else (ref,)
            for o, r in zip(outs, refs):
                np.testing.assert_allclose(o.detach().cpu().numpy(), r,
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{self.name} forward")
        if not grad:
            return
        tensors = [a for a in args if torch.is_tensor(a) and a.requires_grad]
        if not tensors:
            return
        rng = np.random.RandomState(seed)
        ct = [torch.from_numpy(rng.randn(*o.shape).astype("float32"))
              .to(o.device) for o in outs]

        def scalar_loss(inputs):
            res = self(*inputs, **kwargs)
            res = res if isinstance(res, tuple) else (res,)
            return sum((o.float() * c).sum() for o, c in zip(res, ct))

        analytic = torch.autograd.grad(scalar_loss(list(args)), tensors,
                                       allow_unused=True)
        for t, g in zip(tensors, analytic):
            d = torch.from_numpy(rng.randn(*t.shape)).to(t.device, t.dtype)
            base = t.detach()

            def loss_at(delta, t=t, d=d, base=base):
                shifted = [base + delta * d if a is t else a for a in args]
                with torch.no_grad():
                    return float(scalar_loss(shifted))

            fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
            an = float((g * d).sum()) if g is not None else 0.0
            np.testing.assert_allclose(
                an, fd, rtol=5e-2, atol=5e-3,
                err_msg=f"{self.name} grad wrt input (analytic {an} vs "
                        f"finite-difference {fd})")


def custom_op(name=None, vjp=None, nout=1, bind_method=False, golden=None,
              override=False):
    """Decorator registering a torch function as a custom op::

        @paddle.utils.cpp_extension.custom_op(vjp=my_relu_grad)
        def my_relu(x):
            return torch.clamp(x, min=0)

        y = my_relu(t)                  # eager, differentiable
        paddle.jit.to_static(f)(...)    # stages like any other op
    """
    def decorate(fn):
        op_name = name or fn.__name__
        if op_name in _REGISTRY and not override:
            raise ValueError(
                f"custom op '{op_name}' is already registered; pass "
                "override=True to replace it")
        if bind_method:
            raise NotImplementedError(
                f"custom op '{op_name}': bind_method=True would add a method "
                "to torch.Tensor, and the port binds no method onto torch's "
                "class; call the op as a function")
        op = CustomOp(op_name, fn, vjp=vjp, nout=nout, golden=golden)
        _REGISTRY[op_name] = op
        return op

    if callable(name):  # bare @custom_op
        fn, name = name, None
        return decorate(fn)
    return decorate


def get_op(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no custom op named '{name}' is registered "
            f"(registered: {sorted(_REGISTRY)})") from None


def registered_ops():
    return sorted(_REGISTRY)


def _no_cpp(name):
    raise NotImplementedError(
        f"{name}: C++/CUDA extension builds are not part of the port; "
        "register a PyTorch function with "
        "paddle.utils.cpp_extension.custom_op instead (the same "
        "differentiable op, no build step)")


def CppExtension(*a, **k):
    _no_cpp("CppExtension")


def CUDAExtension(*a, **k):
    _no_cpp("CUDAExtension")


def load(*a, **k):
    _no_cpp("load")
