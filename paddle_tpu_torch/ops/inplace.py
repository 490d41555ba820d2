"""The in-place ``op_`` family (``paddle_tpu/ops/inplace.py``).

On a floating ``x`` outside ``auto_cast``, the elementwise ops (the unary
family, the arithmetic binaries against a number or a tensor of ``x``'s
dtype that broadcasts to ``x``'s shape, ``clip_`` and ``scale_`` with
number arguments) call torch's own in-place method (``x.add_(y)``,
``x.clamp_(...)``): no temporary, one pass over memory, the same values
as the out-of-place op. ``clip_`` does so only where no gradient is
recorded, since ``clamp_``'s gradient at a tie is not ``jnp.clip``'s.

Every other ``name_`` runs the port's out-of-place ``name`` and writes
the result into ``x`` (:func:`_write`), returning ``x``:

* same shape and dtype: ``x.copy_(result)``, torch's in-place copy, which
  autograd records; when ``x`` is a view, the write reaches the tensor it
  views (the port's view rule, ROADMAP Queue 3);
* a result that views ``x``'s storage with another shape (``reshape_``,
  ``squeeze_``, ``transpose_``, ...): ``x`` takes that shape in place
  (``as_strided_``, also recorded by autograd);
* any other change of shape or dtype (``cast_``, the comparisons on a
  float ``x``): ``x`` adopts the result, as JAX's ``_adopt`` does, which
  torch allows only for a tensor that records no gradient.

A leaf that requires grad raises while gradients are on (``inplace.py:
6-8``): the in-place write would divert its gradient.
"""
from __future__ import annotations

import sys

import torch

from ..amp.auto_cast import _state as _amp_state
from ..core import random as prandom
from ._common import scalar_operand

_UNARY = """abs acos acosh asin asinh atan atanh ceil cos cosh digamma erf
erfinv exp expm1 floor frac i0 lgamma log log10 log1p log2 logit neg
polygamma reciprocal round rsqrt sigmoid sin sinh sqrt square tan tanh
trunc nan_to_num sgn""".split()

_BINARY = """add subtract multiply divide pow remainder mod floor_divide
floor_mod gcd lcm hypot ldexp logical_and logical_or logical_xor
bitwise_and bitwise_or bitwise_xor equal not_equal greater_equal
greater_than less_equal less_than fmax fmin maximum minimum
heaviside copysign nextafter""".split()

# the unary ops whose out-of-place form on a floating tensor is one torch
# call with an in-place method of the same name
_NATIVE_UNARY = frozenset("""abs acos acosh asin asinh atan atanh ceil cos
cosh digamma erf erfinv exp expm1 floor frac i0 lgamma log log10 log1p log2
neg reciprocal rsqrt sigmoid sin sinh sqrt square tan tanh
trunc""".split())

# the binary ops -> torch's in-place method
_NATIVE_BINARY = {
    "add": "add_", "subtract": "sub_", "multiply": "mul_",
    "divide": "div_", "pow": "pow_", "remainder": "remainder_",
    "mod": "remainder_", "floor_mod": "remainder_",
    "floor_divide": "floor_divide_", "hypot": "hypot_",
    "copysign": "copysign_", "nextafter": "nextafter_"}

# the methods that take a Python number, and the dtypes in which torch
# computes with one as JAX's weak typing does (see ops/math.py)
_NUMBER_METHODS = frozenset({"add_", "sub_", "mul_", "div_", "pow_",
                             "remainder_", "floor_divide_"})
_NUMBER_EXACT = (torch.float32, torch.float64)

_OTHER = """clip scale cast cumsum cumprod tril triu transpose t squeeze
unsqueeze flatten index_add index_fill index_put addmm
masked_scatter put_along_axis
masked_fill renorm multigammaln lerp logical_not bitwise_not""".split()

__all__ = []


def _check_leaf(x):
    if torch.is_grad_enabled() and x.is_leaf and x.requires_grad:
        raise RuntimeError(
            "a leaf Tensor that requires grad is being used in an "
            "in-place operation; wrap the update in paddle.no_grad()")


def _write(x, out):
    """Make ``x`` hold ``out`` in place (the rules in the module's doc)."""
    _check_leaf(x)
    shares = out.untyped_storage().data_ptr() == \
        x.untyped_storage().data_ptr()
    if out.shape == x.shape and out.dtype == x.dtype:
        if shares:
            if out.stride() == x.stride() and \
                    out.storage_offset() == x.storage_offset():
                return x
            out = out.clone()
        return x.copy_(out)
    if shares and out.dtype == x.dtype:
        return x.as_strided_(out.size(), out.stride(), out.storage_offset())
    if x.requires_grad or out.requires_grad:
        raise RuntimeError(
            f"an in-place op cannot change the shape or dtype ({tuple(x.shape)}"
            f" {x.dtype} -> {tuple(out.shape)} {out.dtype}) of a tensor that "
            f"records gradients")
    x.data = out
    return x


def _resolve(name):
    import paddle_tpu_torch as _p
    fn = getattr(_p, name, None)
    if fn is None:
        raise NotImplementedError(
            f"in-place variant '{name}_' has no out-of-place base "
            f"'paddle.{name}'")
    return fn


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _native_ok(x):
    """True where torch's in-place method on ``x`` gives the out-of-place
    op's value: a floating tensor outside ``auto_cast``."""
    return torch.is_tensor(x) and x.is_floating_point() and \
        not _amp_state.enabled


def _native_operand(x, y):
    """``y`` as the operand of torch's in-place binary on ``x`` (a number
    as the out-of-place op makes it), or None where that would not give
    the out-of-place result (another dtype, a broadcast past ``x``)."""
    if _number(y):
        return scalar_operand(y, x)
    if not torch.is_tensor(y) or y.dtype != x.dtype:
        return None
    if y.shape == x.shape or not y.dim() or \
            torch.broadcast_shapes(x.shape, y.shape) == x.shape:
        return y
    return None


def _make_unary(name):
    method = getattr(torch.Tensor, name + "_")

    def op_(x, *args, **kwargs):
        if not args and not kwargs.keys() - {"name"} and _native_ok(x):
            _check_leaf(x)
            return method(x)
        return _write(x, _resolve(name)(x, *args, **kwargs))
    return op_


def _make_binary(name):
    method = getattr(torch.Tensor, _NATIVE_BINARY[name])
    numbers = _NATIVE_BINARY[name] in _NUMBER_METHODS

    def op_(x, *args, **kwargs):
        if len(args) == 1 and not kwargs.keys() - {"name"} and \
                _native_ok(x):
            y = args[0]
            if numbers and type(y) in (int, float) and \
                    x.dtype in _NUMBER_EXACT:
                _check_leaf(x)
                return method(x, y)
            y = _native_operand(x, y)
            if y is not None:
                _check_leaf(x)
                return method(x, y)
        return _write(x, _resolve(name)(x, *args, **kwargs))
    return op_


def _write_op(name):
    def op_(x, *args, **kwargs):
        return _write(x, _resolve(name)(x, *args, **kwargs))
    return op_


def _named(name, op_):
    op_.__name__ = op_.__qualname__ = name + "_"
    op_.__doc__ = (f"In-place ``{name}``: the out-of-place result written "
                   f"into ``x`` (see the module's rules).")
    return op_


def clip_(x, min=None, max=None, name=None):  # noqa: A002
    """In-place ``clip``: ``clamp_`` with number bounds where no gradient
    is recorded (the module's rules; ``ops/math.py``'s ``clip`` says why
    the values are the same), else the out-of-place result written into
    ``x``."""
    if _native_ok(x) and (min is None or _number(min)) and \
            (max is None or _number(max)) and \
            not (x.requires_grad and torch.is_grad_enabled()):
        _check_leaf(x)
        if min is None and max is None:
            return x
        return x.clamp_(min, max)
    return _write(x, _resolve("clip")(x, min, max))


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    """In-place ``scale``: ``mul_`` and ``add_`` for number arguments (the
    module's rules), else the out-of-place result written into ``x``."""
    if act is None and _number(scale) and _number(bias) and _native_ok(x):
        _check_leaf(x)
        if bias_after_scale:
            return x.mul_(scale).add_(bias)
        return x.add_(bias).mul_(scale)
    return _write(x, _resolve("scale")(x, scale, bias, bias_after_scale,
                                       act))


_mod = sys.modules[__name__]
for _base in _UNARY + _BINARY + _OTHER:
    _n = _base + "_"
    if not hasattr(_mod, _n):
        _maker = _make_unary if _base in _NATIVE_UNARY else \
            _make_binary if _base in _NATIVE_BINARY else _write_op
        setattr(_mod, _n, _named(_base, _maker(_base)))
        __all__.append(_n)


def _fill(x, draw):
    """Overwrite ``x`` with ``draw`` (a fresh tensor of ``x``'s shape),
    recording no gradient for it."""
    return _write(x, draw.to(x.dtype).detach())


def _uniform(x, lo, hi):
    g = prandom.generator(x.device)
    return torch.rand(x.shape, device=x.device, generator=g) * (hi - lo) + lo


def cauchy_(x, loc=0.0, scale=1.0, name=None):
    """Fill with Cauchy(loc, scale) draws."""
    u = _uniform(x, 1e-7, 1.0 - 1e-7)
    return _fill(x, loc + scale * torch.tan(torch.pi * (u - 0.5)))


def geometric_(x, probs, name=None):
    """Fill with Geometric(probs) draws (trials to the first success)."""
    u = _uniform(x, 1e-7, 1.0 - 1e-7)
    return _fill(x, torch.ceil(torch.log(u) / torch.log1p(
        torch.full((), -probs, device=x.device))))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    g = torch.Generator(device=x.device).manual_seed(int(seed)) if seed \
        else prandom.generator(x.device)
    u = torch.rand(x.shape, device=x.device, generator=g)
    return _fill(x, u * (max - min) + min)


def normal_(x, mean=0.0, std=1.0, name=None):
    g = prandom.generator(x.device)
    return _fill(x, mean + std * torch.randn(x.shape, device=x.device,
                                             generator=g))


def exponential_(x, lam=1.0, name=None):
    g = prandom.generator(x.device)
    e = torch.empty(x.shape, device=x.device).exponential_(1.0, generator=g)
    return _fill(x, e / lam)


def zero_(x, name=None):
    return _write(x, torch.zeros_like(x))


def where_(condition, x, y, name=None):
    """``x`` where ``condition`` holds, else ``y``, written into ``x``."""
    return _write(x, _resolve("where")(condition, x, y))


__all__ += ["clip_", "scale_", "cauchy_", "geometric_", "uniform_", "normal_",
            "exponential_", "zero_", "where_"]
