"""The case table of the port's op surface against the JAX package, on
the CPU (used by ``tests/test_torch_port_surface_*.py``).

Every case builds numpy inputs from a seed, passes the same values to
``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>`` and compares each
output's values, dtype and shape. Tolerances by family (``FAMILIES``):
ints and bools exact; f32 elementwise and reductions ``rtol 1e-5 /
atol 1e-5`` (transcendentals the same); f64 ``1e-10``; ``lin32`` (f32
linear algebra that goes through a factorisation) ``1e-4``. Gradients of
``sum(out * w)`` (``w`` fixed random weights) are compared at ``rtol
1e-4`` where a case sets ``grad``.
"""
from __future__ import annotations

import numpy as np
import torch

FAMILIES = {
    "int": (0.0, 0.0), "bool": (0.0, 0.0),
    "f32": (1e-5, 1e-5), "f64": (1e-10, 1e-10), "lin32": (1e-4, 1e-4),
}
GRAD_TOL = 1e-4


def f32(*s):
    return lambda r: np.asarray(r.randn(*s), np.float32)


def f64(*s):
    return lambda r: r.randn(*s)


def pos(*s, lo=0.1, hi=1.0):
    return lambda r: (lo + (hi - lo) * r.rand(*s)).astype(np.float32)


def i64(*s, lo=-5, hi=6):
    return lambda r: r.randint(lo, hi, s).astype(np.int64)


def idx(*s, n):
    return lambda r: r.randint(0, n, s).astype(np.int64)


def const(v):
    return lambda r: v


class TList(list):
    """Inputs passed as one list of tensors."""


def lst(*makers):
    return lambda r: TList(m(r) for m in makers)


def spd(n, dt=np.float64):
    def make(r):
        a = r.randn(n, n)
        return (a @ a.T + n * np.eye(n)).astype(dt)
    return make


class Case:
    """One call: ``op`` (a name in the namespace, ``linalg.<name>`` for the
    linear-algebra module) on the inputs ``make`` builds (each a callable
    of the RandomState), with ``kw``; ``call(lib, *args)`` replaces the
    plain call for ops with other signatures."""

    def __init__(self, op, make=(), kw=None, fam="f32", grad=False,
                 call=None, tag="", check=None):
        self.op, self.make, self.kw = op, list(make), dict(kw or {})
        self.fam, self.grad, self.call, self.check = fam, grad, call, check
        self.id = op + (f"-{tag}" if tag else "")
        self.dtypes = True


def _u(op, dom=None, fam="f32", grad=True, tag="", **kw):
    return Case(op, [dom or f32(3, 4)], kw, fam=fam, grad=grad, tag=tag)


def _b(op, a=None, b=None, fam="f32", grad=True, tag="", **kw):
    return Case(op, [a or f32(3, 4), b or f32(3, 4)], kw, fam=fam, grad=grad,
                tag=tag)


UNIT = lambda r: (r.rand(3, 4) * 1.6 - 0.8).astype(np.float32)  # noqa: E731

# ---------------------------------------------------------------- unary
UNARY = [
    _u("abs"), _u("neg"), _u("exp"), _u("expm1"), _u("log", pos(3, 4)),
    _u("log2", pos(3, 4)), _u("log10", pos(3, 4)), _u("log1p", pos(3, 4)),
    _u("sqrt", pos(3, 4)), _u("rsqrt", pos(3, 4)), _u("square"),
    _u("sin"), _u("cos"), _u("tan"), _u("asin", UNIT), _u("acos", UNIT),
    _u("atan"), _u("sinh"), _u("cosh"), _u("tanh"), _u("asinh"),
    _u("acosh", pos(3, 4, lo=1.1, hi=3.0)), _u("atanh", UNIT),
    _u("ceil", grad=False), _u("floor", grad=False),
    _u("round", grad=False), _u("trunc", grad=False), _u("frac"),
    _u("sign", grad=False), _u("reciprocal", pos(3, 4)), _u("sigmoid"),
    _u("erf"), _u("erfinv", UNIT), _u("digamma", pos(3, 4, lo=0.5, hi=3)),
    _u("lgamma", pos(3, 4, lo=0.5, hi=3)), _u("i0"), _u("i0e"), _u("i1"),
    _u("i1e"), _u("logit", pos(3, 4, lo=0.1, hi=0.9)),
    _u("logit", pos(3, 4, lo=0.01, hi=0.99), eps=0.05),
    _u("angle", grad=False), _u("conj"), _u("real"), _u("imag", grad=False),
    _u("deg2rad"), _u("rad2deg"), _u("exponent", pos(3, 4, lo=0.5, hi=9),
                                     grad=False),
    _u("sgn", grad=False), _u("signbit", grad=False, fam="bool"),
    _u("isnan", grad=False, fam="bool"), _u("isinf", grad=False, fam="bool"),
    _u("isfinite", grad=False, fam="bool"),
    Case("isposinf", [const(np.array([1.0, np.inf, -np.inf, np.nan],
                                     np.float32))], fam="bool"),
    Case("isneginf", [const(np.array([1.0, np.inf, -np.inf, np.nan],
                                     np.float32))], fam="bool"),
    Case("isreal", [f32(3)], fam="bool"),
    Case("nan_to_num", [const(np.array([1.0, np.nan, np.inf, -np.inf],
                                       np.float32))], {"nan": 2.0}),
    _u("stanh"), _u("polygamma", pos(3, 4, lo=0.5, hi=3), n=1),
    _u("multigammaln", pos(3, 4, lo=2.0, hi=4), p=3),
    # int inputs of the floating ops: float64, as JAX's x64 gives
    Case("exp", [i64(3, 4)], fam="f64", tag="int"),
    Case("sqrt", [i64(3, 4, lo=0, hi=9)], fam="f64", tag="int"),
    Case("tanh", [i64(3, 4)], fam="f64", tag="int"),
    Case("abs", [i64(3, 4)], fam="int", tag="int"),
    Case("square", [i64(3, 4)], fam="int", tag="int"),
    Case("frexp", [pos(3, 4, lo=0.5, hi=9)]),
    Case("frac", [f64(3, 4)], fam="f64", tag="f64"),
]

# ---------------------------------------------------------------- binary
BINARY = [
    _b("add"), _b("subtract"), _b("multiply"), _b("divide", b=pos(3, 4)),
    _b("floor_divide", b=pos(3, 4), grad=False),
    _b("remainder", b=pos(3, 4), grad=False), _b("mod", b=pos(3, 4),
                                                 grad=False),
    _b("floor_mod", b=pos(3, 4), grad=False),
    _b("pow", a=pos(3, 4), b=f32(3, 4)), _b("maximum"), _b("minimum"),
    _b("fmax"), _b("fmin"), _b("atan2"), _b("logaddexp"), _b("hypot"),
    _b("nextafter", grad=False), _b("copysign", grad=False),
    _b("gcd", i64(3, 4), i64(3, 4), fam="int", grad=False),
    _b("lcm", i64(3, 4), i64(3, 4), fam="int", grad=False),
    _b("heaviside", grad=False), _b("logaddexp2"),
    _b("float_power", pos(3, 4), f32(3, 4), grad=False),
    _b("float_power", i64(3, 4, lo=1, hi=4), i64(3, 4, lo=0, hi=3),
       fam="f64", grad=False, tag="int"),
    _b("inner", f32(3, 4), f32(5, 4)), _b("outer", f32(3), f32(4)),
    _b("kron", f32(2, 3), f32(3, 2)),
    _b("ldexp", f32(3, 4), i64(3, 4, lo=-3, hi=3), grad=False),
    _b("add", f32(3, 4), f32(4), tag="broadcast"),
    Case("add", [i64(3, 4), const(1.5)], fam="f64", tag="int+float"),
    Case("add", [f32(3, 4), const(2.5)], tag="f32+float", grad=True),
    Case("multiply", [i64(3, 4), const(3)], fam="int", tag="int*int"),
    Case("divide", [i64(3, 4), const(np.array([1, 2, 3, 4]))],
         fam="f64", tag="int/int"),
    Case("pow", [f32(3, 4), const(2)], tag="scalar", grad=True),
    Case("subtract", [const(2.0), f32(3, 4)], tag="scalar-first",
         grad=True),
    Case("maximum", [f32(3, 4), const(0.0)], tag="scalar", grad=True),
    _b("bitwise_left_shift", i64(3, 4, lo=0, hi=16),
       i64(3, 4, lo=0, hi=4), fam="int", grad=False),
    _b("bitwise_right_shift", i64(3, 4, lo=-64, hi=64),
       i64(3, 4, lo=0, hi=4), fam="int", grad=False),
    _b("bitwise_right_shift", i64(3, 4, lo=-64, hi=64),
       i64(3, 4, lo=0, hi=4), fam="int", grad=False, is_arithmetic=False),
    _b("vecdot"),
]
BINARY[-2].id = "bitwise_right_shift-logical"

# ------------------------------------------------------------ reductions
def _r(op, make=None, fam="f32", grad=True, tag="", **kw):
    return Case(op, [make or f32(3, 4, 5)], kw, fam=fam, grad=grad, tag=tag)


REDUCE = [
    _r("sum"), _r("sum", axis=1, tag="axis"), _r("sum", axis=[0, 2],
                                               keepdim=True, tag="axes"),
    _r("sum", i64(3, 4), fam="int", grad=False, tag="int"),
    _r("sum", i64(3, 4), fam="f64", grad=False, dtype="float64",
       tag="dtype"),
    _r("mean"), _r("mean", axis=-1, keepdim=True, tag="axis"),
    _r("mean", i64(3, 4), fam="f64", grad=False, tag="int"),
    _r("prod", pos(3, 4)), _r("prod", pos(3, 4, 2), axis=[0, 2],
                              tag="axes"),
    _r("max"), _r("max", axis=1, tag="axis"), _r("min", axis=[0, 1],
                                                keepdim=True, tag="axes"),
    _r("min"), _r("amax", axis=0), _r("amin", axis=2),
    _r("all", const(np.array([[True, False], [True, True]])),
       fam="bool", grad=False, axis=1),
    _r("any", const(np.array([[True, False], [False, False]])),
       fam="bool", grad=False),
    _r("argmax", fam="int", grad=False), _r("argmax", fam="int", grad=False,
                                            axis=1, keepdim=True,
                                            tag="axis"),
    _r("argmin", fam="int", grad=False, axis=0),
    _r("cumsum", axis=1), _r("cumsum", tag="flat"),
    _r("cumsum", i64(3, 4), fam="int", grad=False, axis=0, tag="int"),
    _r("cumprod", pos(3, 4), dim=1),
    _r("cummax", axis=1), _r("cummin", axis=0),
    _r("logsumexp", axis=1), _r("logsumexp"),
    _r("median"), _r("median", f32(3, 6), axis=1, tag="even"),
    _r("median", f32(3, 5), axis=1, keepdim=True, tag="odd"),
    _r("median", i64(4, 6), fam="f64", grad=False, axis=1, tag="int"),
    _r("nanmedian", const(np.array([[1.0, np.nan, 3.0, 4.0],
                                    [2.0, 5.0, np.nan, 1.0]], np.float32)),
       grad=False, axis=1),
    _r("nanmean", const(np.array([1.0, np.nan, 3.0], np.float32)),
       grad=False),
    _r("nansum", const(np.array([1.0, np.nan, 3.0], np.float32)),
       grad=False),
    _r("var"), _r("var", axis=1, unbiased=False, tag="biased"),
    _r("std"), _r("std", axis=[0, 1], keepdim=True, tag="axes"),
    _r("count_nonzero", i64(3, 4, lo=-1, hi=2), fam="int", grad=False,
       axis=1),
    _r("trace", f32(4, 4)), _r("trace", f32(3, 4, 4), offset=1, axis1=1,
                               axis2=2, tag="batched"),
    _r("diagonal", f32(4, 5), offset=-1),
    Case("dot", [f32(5), f32(5)], grad=True),
    Case("dot", [f32(3, 5), f32(3, 5)], grad=True, tag="rows"),
    Case("cross", [f32(4, 3), f32(4, 3)], grad=True),
    Case("quantile", [f32(4, 6)], {"q": 0.3, "axis": 1}, grad=True),
    Case("quantile", [f32(4, 6)], {"q": [0.25, 0.5]}, tag="list"),
    Case("nanquantile", [const(np.array([[1.0, np.nan, 3.0, 4.0],
                                         [2.0, 5.0, np.nan, 1.0]],
                                        np.float32))], {"q": 0.5, "axis": 1}),
    Case("logcumsumexp", [f32(3, 4)], {"axis": 1}, grad=True),
    Case("diff", [f32(3, 5)], {"axis": 1}, grad=True),
    Case("trapezoid", [f32(3, 5)], {"dx": 0.5}, grad=True),
    Case("cumulative_trapezoid", [f32(3, 5)], {"axis": 1}, grad=True),
    Case("histc", [pos(50)], {"bins": 8, "min": 0.0, "max": 1.0}),
    Case("histogram", [pos(50)], {"bins": 8}, fam="int"),
    Case("bincount", [i64(20, lo=0, hi=6)], fam="int"),
    Case("renorm", [f32(3, 4)], {"p": 2, "axis": 0, "max_norm": 1.0},
         grad=True),
    Case("add_n", [lst(f32(2, 3), f32(2, 3), f32(2, 3))], grad=True),
]

# -------------------------------------------------------------- creation
def _mk(op, *args, fam="f32", tag="", **kw):
    return Case(op, [const(a) for a in args], kw, fam=fam, tag=tag)


CREATION = [
    _mk("zeros", [2, 3]), _mk("zeros", [2], dtype="int32", fam="int",
                              tag="int32"),
    _mk("ones", [2, 3]), _mk("full", [2, 2], 3, tag="int-fill"),
    _mk("full", [2], 2.5, dtype="float64", fam="f64", tag="f64"),
    Case("zeros_like", [i64(2, 3)], fam="int"),
    Case("ones_like", [f32(2, 3)], {"dtype": "float64"}, fam="f64"),
    Case("full_like", [i64(2, 3)], {"fill_value": 2.5}, fam="int"),
    _mk("arange", 5, fam="int"), _mk("arange", 1, 10, 3, fam="int",
                                     tag="step"),
    _mk("arange", 0.0, 1.0, 0.25, fam="f64", tag="float"),
    _mk("arange", 5, dtype="float32", tag="dtype"),
    _mk("linspace", 0, 1, 5, fam="f64"), _mk("linspace", -1.0, 2.0, 7,
                                             dtype="float32", tag="f32"),
    _mk("logspace", 0, 2, 5, fam="f64"),
    _mk("eye", 3), _mk("eye", 2, 4, dtype="int64", fam="int", tag="rect"),
    _mk("empty", [2, 3]), Case("empty_like", [f32(2, 3)]),
    Case("diag", [f32(4)], {"offset": 1}, grad=True),
    Case("diag", [f32(3)], {"padding_value": 7.0}, tag="padding"),
    Case("diag", [f32(4, 4)], tag="2d", grad=True),
    Case("diagflat", [f32(2, 2)], {"offset": -1}, grad=True),
    Case("diag_embed", [f32(2, 3)], grad=True),
    Case("diag_embed", [f32(2, 3)], {"offset": 1, "dim1": 0, "dim2": 2},
         tag="dims"),
    Case("meshgrid", [f32(3), f32(4)]),
    Case("meshgrid", [lst(f32(2), f32(3))], tag="list"),
    Case("tril", [f32(4, 4)], {"diagonal": -1}, grad=True),
    Case("triu", [f32(3, 4)], {"diagonal": 1}, grad=True),
    _mk("tril_indices", 4, 3, fam="int"), _mk("tril_indices", 4, 4, 1,
                                              fam="int", tag="offset"),
    _mk("triu_indices", 3, 4, fam="int"),
    _mk("triu_indices", 4, None, -1, fam="int", tag="offset"),
    Case("assign", [f32(2, 3)]), Case("clone", [f32(2, 3)], grad=True),
    Case("numel", [f32(2, 3)], fam="int"),
    Case("complex", [f32(3), f32(3)]), Case("polar", [pos(3), f32(3)]),
    _mk("to_tensor", [1, 2, 3], fam="int"), _mk("to_tensor", 1.5,
                                                tag="float"),
    _mk("to_tensor", [[1.0, 2.0]], tag="list"),
    _mk("to_tensor", np.zeros(3), tag="np-f64"),
    _mk("to_tensor", np.arange(3, dtype=np.int32), fam="int", tag="np-i32"),
    _mk("to_tensor", True, fam="bool", tag="bool"),
    _mk("to_tensor", [1, 2], dtype="float64", fam="f64", tag="dtype"),
    Case("one_hot", [idx(5, n=4)], {"num_classes": 4}),
    Case("einsum", [f32(2, 3), f32(3, 4)], grad=True,
         call=lambda L, a, b: L.einsum("ij,jk->ik", a, b)),
    Case("einsum", [f32(2, 3, 4)], tag="trace",
         call=lambda L, a: L.einsum("bij->bj", a)),
]

# ------------------------------------------------------------------ logic
LOGIC = [
    _b(n, fam="bool", grad=False) for n in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal")
] + [
    Case("equal", [i64(3, 4), const(2)], fam="bool", tag="scalar"),
    Case("less_than", [f32(3, 4), const(0.0)], fam="bool", tag="scalar"),
    _b("logical_and", i64(3, 4, lo=0, hi=2), i64(3, 4, lo=0, hi=2),
       fam="bool", grad=False),
    _b("logical_or", i64(3, 4, lo=0, hi=2), i64(3, 4, lo=0, hi=2),
       fam="bool", grad=False),
    _b("logical_xor", i64(3, 4, lo=0, hi=2), i64(3, 4, lo=0, hi=2),
       fam="bool", grad=False),
    _b("bitwise_and", i64(3, 4), i64(3, 4), fam="int", grad=False),
    _b("bitwise_or", i64(3, 4), i64(3, 4), fam="int", grad=False),
    _b("bitwise_xor", i64(3, 4), i64(3, 4), fam="int", grad=False),
    Case("logical_not", [i64(3, 4, lo=0, hi=2)], fam="bool"),
    Case("bitwise_not", [i64(3, 4)], fam="int"),
    Case("isclose", [f32(3, 4), f32(3, 4)], fam="bool"),
    Case("isclose", [const(np.array([1.0, 2.0], np.float32)),
                     const(np.array([1.0 + 1e-7, 2.1], np.float32))],
         fam="bool", tag="near"),
    Case("allclose", [const(np.array([1.0, 2.0], np.float32)),
                      const(np.array([1.0 + 1e-7, 2.0], np.float32))],
         fam="bool"),
    Case("equal_all", [const(np.arange(4)), const(np.arange(4))],
         fam="bool"),
    Case("equal_all", [const(np.arange(4)), const(np.arange(3))],
         fam="bool", tag="shapes"),
    Case("is_empty", [const(np.zeros((0, 2), np.float32))], fam="bool"),
    Case("is_tensor", [f32(2)], fam="bool"),
]

# ----------------------------------------------------------------- search
def _distinct(*s):
    def make(r):
        n = int(np.prod(s))
        return (r.permutation(n).reshape(s) * 0.5 - 3).astype(np.float32)
    return make


SEARCH = [
    Case("sort", [_distinct(3, 5)], grad=True),
    Case("sort", [_distinct(3, 5)], {"axis": 0, "descending": True},
         tag="desc", grad=True),
    Case("argsort", [_distinct(3, 5)], fam="int"),
    Case("argsort", [const(np.array([2.0, 1.0, 2.0, 1.0], np.float32))],
         {"descending": True}, fam="int", tag="ties-desc"),
    Case("topk", [_distinct(3, 6)], {"k": 2}, grad=True),
    Case("topk", [_distinct(4, 3)], {"k": 2, "axis": 0, "largest": False},
         tag="smallest", grad=True),
    Case("kthvalue", [_distinct(3, 5)], {"k": 2}, grad=True),
    Case("kthvalue", [_distinct(3, 5)], {"k": 1, "axis": 0,
                                         "keepdim": True}, tag="keepdim"),
    Case("mode", [const(np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]]))],
         fam="int"),
    Case("nonzero", [i64(3, 4, lo=-1, hi=2)], fam="int"),
    Case("nonzero", [i64(3, 4, lo=-1, hi=2)], {"as_tuple": True},
         fam="int", tag="tuple"),
    Case("searchsorted", [const(np.array([1.0, 2.0, 4.0, 8.0], np.float32)),
                          const(np.array([0.5, 2.0, 5.0, 9.0],
                                         np.float32))], fam="int"),
    Case("searchsorted", [const(np.array([1.0, 2.0, 4.0], np.float32)),
                          const(np.array([2.0, 4.0], np.float32))],
         {"right": True, "out_int32": True}, fam="int", tag="right"),
    Case("bucketize", [const(np.array([0.5, 2.0, 5.0], np.float32)),
                       const(np.array([1.0, 2.0, 4.0], np.float32))],
         fam="int"),
    Case("index_fill", [f32(3, 4), const(np.array([0, 2]))],
         {"axis": 1, "value": -1.0}, grad=True),
]

# ------------------------------------------------------------ manipulation
MANIP = [
    Case("cast", [f32(2, 3)], {"dtype": "int32"}, fam="int"),
    Case("reshape", [f32(2, 6)], {"shape": [3, -1]}, grad=True),
    Case("transpose", [f32(2, 3, 4)], {"perm": [2, 0, 1]}, grad=True),
    Case("t", [f32(2, 3)], grad=True), Case("t", [f32(3)], tag="1d"),
    Case("flatten", [f32(2, 3, 4)], {"start_axis": 1}, grad=True),
    Case("squeeze", [f32(1, 3, 1)], grad=True),
    Case("squeeze", [f32(1, 3, 1)], {"axis": [0, 1]}, tag="axes"),
    Case("unsqueeze", [f32(2, 3)], {"axis": [0, 2]}, grad=True),
    Case("concat", [lst(f32(2, 3), f32(1, 3))], grad=True),
    Case("concat", [lst(f32(2, 3), f32(2, 2))], {"axis": -1}, tag="last"),
    Case("stack", [lst(f32(2, 3), f32(2, 3))], {"axis": 1}, grad=True),
    Case("split", [f32(6, 4)], {"num_or_sections": 3}, grad=True),
    Case("split", [f32(3, 8)], {"num_or_sections": [2, -1, 3],
                                "axis": -1}, tag="minus1", grad=True),
    Case("chunk", [f32(4, 6)], {"chunks": 2, "axis": 1}, grad=True),
    Case("unbind", [f32(3, 4)], {"axis": 1}, grad=True),
    Case("unstack", [f32(3, 4)], grad=True),
    Case("tile", [f32(2, 3)], {"repeat_times": [2, 1, 2]}, grad=True),
    Case("expand", [f32(1, 3)], {"shape": [2, 4, -1]}, grad=True),
    Case("expand_as", [f32(1, 3), f32(4, 3)]),
    Case("broadcast_to", [f32(3)], {"shape": [2, 3]}, grad=True),
    Case("broadcast_tensors", [lst(f32(1, 3), f32(2, 1))]),
    Case("broadcast_shape", [const([2, 1, 3]), const([4, 1])], fam="int"),
    Case("flip", [f32(2, 3)], {"axis": [0, 1]}, grad=True),
    Case("reverse", [f32(2, 3)], {"axis": 1}),
    Case("rot90", [f32(2, 3)], {"k": 3}, grad=True),
    Case("roll", [f32(3, 4)], {"shifts": 2, "axis": 1}, grad=True),
    Case("roll", [f32(3, 4)], {"shifts": -1}, tag="flat"),
    Case("moveaxis", [f32(2, 3, 4)], {"source": 0, "destination": -1}),
    Case("swapaxes", [f32(2, 3, 4)], {"axis0": 0, "axis1": 2}),
    Case("gather", [f32(5, 3), const(np.array([4, 0, 2]))], grad=True),
    Case("gather", [f32(3, 5), const(np.array([[1], [3]]))], {"axis": 1},
         tag="2d-index"),
    Case("gather_nd", [f32(3, 4, 2), const(np.array([[0, 1], [2, 3]]))],
         grad=True),
    Case("scatter", [f32(5, 3), const(np.array([1, 3])), f32(2, 3)],
         grad=True),
    Case("scatter", [f32(5, 3), const(np.array([1, 3, 1])), f32(3, 3)],
         {"overwrite": False}, tag="accumulate", grad=True),
    Case("scatter_nd_add", [f32(4, 3), const(np.array([[1], [1], [3]])),
                            f32(3, 3)], grad=True),
    Case("scatter_nd", [const(np.array([[1], [3]])), f32(2, 3)],
         {"shape": [5, 3]}),
    Case("index_select", [f32(4, 3), const(np.array([3, 0, 3]))],
         {"axis": 0}, grad=True),
    Case("index_sample", [f32(3, 5), const(np.array([[0, 4], [1, 1],
                                                     [2, 3]]))], grad=True),
    Case("index_add", [f32(4, 3), const(np.array([0, 2, 0])), f32(4, 3)],
         {"axis": 1}, grad=True, call=lambda L, x, i, v: L.index_add(
             x, i, 1, v[:, :3])),
    Case("index_put", [f32(4, 3), const(np.array([0, 2])),
                       const(np.array([1, 0])), f32(2)], grad=True,
         call=lambda L, x, i, j, v: L.index_put(x, (i, j), v)),
    Case("index_put", [f32(4, 3), const(np.array([0, 0])),
                       const(np.array([1, 1])), f32(2)], tag="accumulate",
         call=lambda L, x, i, j, v: L.index_put(x, (i, j), v,
                                                accumulate=True)),
    Case("masked_select", [f32(3, 4), const(np.array([True, False, True,
                                                      True]))], grad=True),
    Case("masked_fill", [f32(3, 4), const(np.array([True, False, True,
                                                    False]))],
         {"value": -2.0}, grad=True),
    Case("where", [const(np.array([[True, False, True]])), f32(2, 3),
                   f32(2, 3)], grad=True),
    Case("where", [const(np.array([True, False, True])), f32(3)],
         tag="scalar", call=lambda L, c, x: L.where(c, x, 0.5)),
    Case("where", [const(np.array([[1, 0], [0, 1]]))], fam="int",
         tag="nonzero", call=lambda L, c: L.where(c)),
    Case("take_along_axis", [f32(3, 4), const(np.array([[0], [3], [1]]))],
         {"axis": 1}, grad=True),
    Case("take_along_axis", [f32(3, 4), const(np.array([[2, 0, 1, 1]]))],
         {"axis": 0}, tag="broadcast"),
    Case("put_along_axis", [f32(3, 4), const(np.array([[0], [3], [1]])),
                            f32(3, 1)], {"axis": 1}, grad=True),
    Case("put_along_axis", [f32(3, 4), const(np.array([[0, 0], [3, 1],
                                                       [1, 1]]))],
         {"values": 2.0, "axis": 1, "reduce": "add"}, tag="add"),
    Case("put_along_axis", [f32(3, 4), const(np.array([[0], [3], [1]])),
                            f32(3, 1)], {"axis": 1, "reduce": "mul"},
         tag="mul"),
    Case("repeat_interleave", [f32(2, 3)], {"repeats": 2, "axis": 1},
         grad=True),
    Case("repeat_interleave", [f32(3), const(np.array([1, 0, 2]))],
         tag="tensor", call=lambda L, x, r: L.repeat_interleave(x, r, 0)),
    Case("unique", [i64(12, lo=0, hi=5)], fam="int"),
    Case("unique", [i64(3, 4, lo=0, hi=5)], {"return_index": True,
                                             "return_inverse": True,
                                             "return_counts": True},
         fam="int", tag="all"),
    Case("unique", [const(np.array([[1, 2], [0, 1], [1, 2]]))],
         {"axis": 0, "return_counts": True}, fam="int", tag="axis"),
    Case("unique_consecutive", [const(np.array([1, 1, 2, 2, 3, 1, 1]))],
         {"return_inverse": True, "return_counts": True}, fam="int"),
    Case("slice", [f32(4, 5)], {"axes": [0, 1], "starts": [1, -3],
                                "ends": [3, 10]}, grad=True),
    Case("strided_slice", [f32(6, 5)], {"axes": [0, 1], "starts": [0, 4],
                                        "ends": [6, 0], "strides": [2, -1]},
         grad=True),
    Case("crop", [f32(4, 5)], {"shape": [2, 3], "offsets": [1, 2]},
         grad=True),
    Case("as_complex", [f32(3, 2)]), Case("as_real", [f32(3)],
                                          call=lambda L, x: L.as_real(
                                              L.complex(x, x * 2))),
    Case("view", [f32(2, 6)], {"shape_or_dtype": [4, 3]}),
    Case("view", [f32(2, 4)], {"shape_or_dtype": "int32"}, fam="int",
         tag="dtype"),
    Case("view_as", [f32(2, 6), f32(3, 4)]),
    Case("atleast_1d", [f32()], call=lambda L, x: L.atleast_1d(x)),
    Case("atleast_2d", [f32(3), f32()], call=lambda L, a, b:
         L.atleast_2d(a, b)),
    Case("atleast_3d", [f32(3), f32(2, 2)], call=lambda L, a, b:
         L.atleast_3d(a, b)),
    Case("tensordot", [f32(2, 3, 4), f32(3, 4, 5)], grad=True),
    Case("tensordot", [f32(2, 3), f32(3, 2)], {"axes": [[1], [0]]},
         tag="lists"),
    Case("tolist", [i64(2, 3)], fam="int"),
    Case("as_strided", [f32(4, 4)], {"shape": [2, 3], "stride": [4, 1],
                                     "offset": 1}, grad=True),
    Case("histogramdd", [f32(20, 2)], {"bins": 3}),
    Case("histogramdd", [f32(20, 2)], {"bins": [2, 3],
                                       "ranges": [[-1.0, 1.0], [-2.0, 2.0]],
                                       "density": True}, fam="f64",
         tag="ranges"),
    Case("multiplex", [lst(f32(3, 2), f32(3, 2)),
                       const(np.array([[1], [0], [1]]))], grad=True),
    Case("clip", [f32(3, 4)], {"min": -0.5, "max": 0.5}, grad=True),
    Case("clip", [f32(3, 4)], {"min": 0.0}, tag="min", grad=True),
    Case("lerp", [f32(3), f32(3)], {"weight": 0.3}, grad=True),
    Case("lerp", [f32(3), f32(3), f32(3)], tag="tensor", grad=True),
    Case("scale", [f32(3)], {"scale": 2.0, "bias": 1.0}, grad=True),
    Case("scale", [f32(3)], {"scale": 2.0, "bias": 1.0,
                             "bias_after_scale": False}, tag="before"),
    Case("addmm", [f32(2, 4), f32(2, 3), f32(3, 4)], {"beta": 0.5,
                                                       "alpha": 2.0},
         grad=True),
    Case("baddbmm", [f32(2, 3, 5), f32(2, 3, 4), f32(2, 4, 5)], grad=True),
    Case("cdist", [f32(4, 3), f32(5, 3)], grad=True),
    Case("cdist", [f32(4, 3), f32(5, 3)], {"p": 1.0}, tag="p1"),
    Case("pdist", [f32(4, 3)], grad=True),
    Case("take", [f32(3, 4), const(np.array([0, 11, 13, -2]))], grad=True),
    Case("take", [f32(3, 4), const(np.array([0, 13, -2]))],
         {"mode": "wrap"}, tag="wrap"),
    Case("unfold", [f32(8)], {"axis": 0, "size": 4, "step": 2}, grad=True),
    Case("diagonal_scatter", [f32(4, 4), f32(3)], {"offset": 1},
         grad=True),
    Case("select_scatter", [f32(3, 4), f32(4)], {"axis": 0, "index": 1},
         grad=True),
    Case("slice_scatter", [f32(6, 4), f32(2, 4)], {"axes": [0],
                                                   "starts": [1],
                                                   "ends": [5],
                                                   "strides": [2]},
         grad=True),
    Case("tensor_split", [f32(7, 2)], {"num_or_indices": 3}),
    Case("hsplit", [f32(2, 4)], {"num_or_indices": 2}),
    Case("vsplit", [f32(4, 2)], {"num_or_indices": 2}),
    Case("dsplit", [f32(2, 2, 4)], {"num_or_indices": 2}),
    Case("column_stack", [lst(f32(4), f32(4))]),
    Case("row_stack", [lst(f32(2, 4), f32(4))]),
    Case("hstack", [lst(f32(3, 2), f32(3, 5))], grad=True),
    Case("vstack", [lst(f32(2, 4), f32(3, 4))]),
    Case("dstack", [lst(f32(2, 3), f32(2, 3))]),
    Case("unflatten", [f32(4, 6)], {"axis": 1, "shape": [2, 3]}),
    Case("masked_scatter", [f32(2, 3), const(np.array([[True, False, True],
                                                       [False, True,
                                                        False]])),
                            f32(6)], grad=True),
    Case("shard_index", [const(np.array([[1], [6], [12], [19]]))],
         {"index_num": 20, "nshards": 2, "shard_id": 1}, fam="int"),
    Case("rank", [f32(2, 3, 4)], fam="int"),
    Case("shape", [f32(2, 5)], fam="int"),
    Case("combinations", [f32(4)], {"r": 2}),
    Case("combinations", [f32(3)], {"r": 2, "with_replacement": True},
         tag="replacement"),
    Case("vander", [f32(4)], {"n": 3}),
    Case("increment", [f32(3)], {"value": 2.0}),
]

# ----------------------------------------------------------------- linalg
def _lin(op, make, fam="f64", grad=False, tag="", call=None, check=None,
         dtypes=True, **kw):
    c = Case(op, make, kw, fam=fam, grad=grad, tag=tag, call=call,
             check=check)
    c.dtypes = dtypes
    return c


def C_real(t):
    return _np(t).real


def _recon_svd(out, x):
    u, s, vh = (_np(t) for t in out)
    return u @ np.diag(s) @ vh, x


def _recon_qr(out, x):
    q, r = (_np(t) for t in out)
    return q @ r, x


def _recon_eigh(out, x):
    w, v = (_np(t) for t in out)
    return v @ np.diag(w) @ v.T, x


def _recon_eig(out, x):
    w, v = (_np(t) for t in out)
    return (v @ np.diag(w) @ np.linalg.inv(v)).real, x


LINALG = [
    _lin("matmul", [f32(2, 3), f32(3, 4)], fam="f32", grad=True),
    _lin("matmul", [f32(2, 3, 4), f32(2, 5, 4)], fam="f32", grad=True,
         transpose_y=True, tag="transpose_y"),
    _lin("matmul", [f32(4, 3), f32(4)], fam="f32", transpose_x=True,
         tag="vec"),
    _lin("mm", [f32(2, 3), f32(3, 2)], fam="f32"),
    _lin("bmm", [f32(2, 2, 3), f32(2, 3, 2)], fam="f32", grad=True),
    _lin("mv", [f32(2, 3), f32(3)], fam="f32", grad=True),
    _lin("multi_dot", [lst(f32(2, 3), f32(3, 4), f32(4, 2))], fam="f32"),
    _lin("norm", [f32(3, 4)], fam="f32", grad=True),
    _lin("norm", [f32(3, 4)], fam="f32", p=1, axis=1, tag="p1"),
    _lin("norm", [f32(3, 4)], fam="f32", p=np.inf, tag="inf"),
    _lin("norm", [f32(3, 4)], fam="f32", p=3, tag="p3"),
    _lin("norm", [f32(2, 3, 4)], fam="f32", axis=[1, 2], keepdim=True,
         tag="matrix"),
    _lin("vector_norm", [f32(3, 4)], fam="f32", p=3.0, axis=1, grad=True),
    _lin("matrix_norm", [f32(3, 4)], fam="lin32", p="nuc"),
    _lin("matrix_norm", [f32(2, 3, 4)], fam="f32", tag="fro"),
    _lin("dist", [f32(3, 4), f32(3, 4)], fam="f32", grad=True),
    _lin("dist", [f32(3, 4), f32(3, 4)], fam="f32", p=np.inf, tag="inf"),
    _lin("cholesky", [spd(4)], grad=True),
    _lin("cholesky", [spd(3)], upper=True, tag="upper"),
    _lin("inverse", [spd(3)], grad=True), _lin("inv", [spd(3)]),
    _lin("det", [f64(3, 3)], grad=True), _lin("slogdet", [f64(3, 3)]),
    _lin("pinv", [f64(4, 3)], grad=True),
    _lin("solve", [spd(3), f64(3, 2)], grad=True),
    _lin("triangular_solve", [lambda r: np.triu(r.randn(3, 3)) +
                              3 * np.eye(3), f64(3, 2)], grad=True),
    _lin("triangular_solve", [lambda r: np.tril(r.randn(3, 3)) +
                              3 * np.eye(3), f64(3, 2)], upper=False,
         transpose=True, tag="lower-t"),
    _lin("cholesky_solve", [f64(3, 3), lambda r: np.linalg.cholesky(
        spd(3)(r))], grad=True),
    _lin("lstsq", [f32(5, 3), f32(5, 2)], fam="lin32"),
    _lin("lstsq", [f32(3, 4), f32(3, 2)], fam="lin32", tag="wide"),
    _lin("matrix_power", [f64(3, 3)], n=3, grad=True),
    _lin("matrix_rank", [lambda r: np.outer(r.randn(4), r.randn(3))],
         fam="int"),
    _lin("qr", [f64(4, 3)], check=_recon_qr),
    _lin("qr", [f64(3, 4)], mode="complete", tag="complete",
         check=_recon_qr),
    _lin("svd", [f64(4, 3)], check=_recon_svd),
    # eig: complex in the port always, numpy's real f32 in JAX for a
    # matrix whose eigenvalues are real (ROADMAP Queue 3): values only
    _lin("eig", [spd(3)], check=_recon_eig, dtypes=False),
    _lin("eigh", [spd(3)], check=_recon_eigh),
    _lin("eigvals", [spd(3)], check=lambda out, x: (
        np.sort(C_real(out)), np.sort(np.linalg.eigvals(x).real)),
         dtypes=False),
    _lin("eigvalsh", [spd(3)], grad=True),
    _lin("cov", [f64(3, 6)], grad=True),
    _lin("cov", [f64(6, 3)], rowvar=False, ddof=False, tag="cols"),
    _lin("corrcoef", [f64(3, 6)]),
    _lin("pca_lowrank", [f32(6, 4)], fam="lin32", q=2,
         check=lambda out, x: (_np(out[1]), np.linalg.svd(
             x - x.mean(0), compute_uv=False)[:2])),
    _lin("linalg.lu", [f64(4, 4)]),
    _lin("linalg.lu_unpack", [f64(4, 4)],
         call=lambda L, x: L.linalg.lu_unpack(*L.linalg.lu(x))),
    _lin("linalg.cond", [spd(4)]),
    _lin("linalg.matrix_exp", [lambda r: 0.3 * r.randn(3, 3)], grad=True),
    _lin("linalg.householder_product", [f64(4, 3), f64(3)], grad=True),
    _lin("linalg.cross", [f32(4, 3), f32(4, 3)], fam="f32", grad=True),
    _lin("linalg.dot", [f32(5), f32(5)], fam="f32", grad=True),
]
LINALG_NAMESPACE = ["matmul", "mm", "bmm", "mv", "multi_dot", "norm",
                    "vector_norm", "matrix_norm", "dist", "cholesky",
                    "inverse", "inv", "det", "slogdet", "pinv", "solve",
                    "triangular_solve", "cholesky_solve", "lstsq",
                    "matrix_power", "matrix_rank", "qr", "svd", "eig",
                    "eigh", "eigvals", "eigvalsh", "cov", "corrcoef",
                    "histogram", "bincount", "pca_lowrank"]

# ----------------------------------------------------------------- runner
def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if hasattr(t, "_data"):
        return np.asarray(t._data)
    return np.asarray(t)


def _jdtype(t):
    return str(np.asarray(t._data).dtype) if hasattr(t, "_data") \
        else str(t.dtype)


def _leaves(out):
    if isinstance(out, (list, tuple)) and not (
            len(out) and isinstance(out[0], (int, float, bool))):
        res = []
        for o in out:
            res += _leaves(o)
        return res
    return [out]


def to_jax(P, v, grad=False):
    if isinstance(v, TList):
        return [to_jax(P, a, grad) for a in v]
    if isinstance(v, np.ndarray):
        dt = "float64" if v.dtype == np.float64 else None
        return P.to_tensor(v, dtype=dt, stop_gradient=not (
            grad and v.dtype.kind == "f"))
    return v


def to_torch(v, grad=False):
    if isinstance(v, TList):
        return [to_torch(a, grad) for a in v]
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(np.array(v))
        if grad and v.dtype.kind == "f":
            t.requires_grad_(True)
        return t
    return v


def _resolve(L, op):
    mod, _, name = op.rpartition(".")
    return getattr(getattr(L, mod) if mod else L, name)


def invoke(L, case, args):
    if case.call is not None:
        return case.call(L, *args)
    return _resolve(L, case.op)(*args, **case.kw)


def compare(case, jout, tout, raw_inputs=None):
    """Values, dtypes and shapes of every output of a case."""
    rtol, atol = FAMILIES[case.fam]
    if case.check is not None:
        got, want = case.check(tout if not isinstance(tout, torch.Tensor)
                               else tout, raw_inputs[0])
        got = _np(got) if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, want, rtol=max(rtol, 1e-8),
                                   atol=max(atol, 1e-8), err_msg=case.id)
        got_j, _ = case.check(jout, raw_inputs[0])
        jtol = 1e-5 if not case.dtypes else max(rtol, 1e-8)
        np.testing.assert_allclose(got, _np(got_j), rtol=jtol, atol=jtol,
                                   err_msg=case.id)
        jl, tl = _leaves(jout), _leaves(tout)
        for j, t in zip(jl, tl):
            if case.dtypes:
                assert _jdtype(j) == str(t.dtype).replace("torch.", ""), \
                    case.id
            assert list(j.shape) == list(t.shape), case.id
        return
    jl, tl = _leaves(jout), _leaves(tout)
    assert len(jl) == len(tl), (case.id, len(jl), len(tl))
    for j, t in zip(jl, tl):
        if isinstance(t, torch.Tensor):
            assert hasattr(j, "_data"), (case.id, type(j))
            assert _jdtype(j) == str(t.dtype).replace("torch.", ""), (
                case.id, _jdtype(j), t.dtype)
            assert list(j.shape) == list(t.shape), (case.id, j.shape,
                                                    t.shape)
            jv, tv = _np(j), _np(t)
            if case.fam in ("int", "bool"):
                np.testing.assert_array_equal(tv, jv, err_msg=case.id)
            else:
                np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol,
                                           err_msg=case.id)
        else:
            assert not hasattr(j, "_data"), (case.id, type(j), type(t))
            assert j == t, (case.id, j, t)


def run_case(P, T, case, seed=0):
    r = np.random.RandomState(seed)
    raw = [m(r) for m in case.make]
    jout = invoke(P, case, [to_jax(P, v) for v in raw])
    tout = invoke(T, case, [to_torch(v) for v in raw])
    compare(case, jout, tout, raw)
    for o in _leaves(tout):
        if isinstance(o, torch.Tensor):
            assert o.device.type == "cpu", case.id
    if case.grad:
        check_grad(P, T, case, raw)


def _float_leaves(outs):
    return [o for o in outs if isinstance(o, torch.Tensor)
            and o.is_floating_point()]


def _flat(args):
    out = []
    for a in args:
        out += list(a) if isinstance(a, list) else [a]
    return out


def check_grad(P, T, case, raw):
    """``grad`` of ``sum(out_i * w_i)`` over the floating outputs, with
    respect to every floating input, in both packages."""
    jargs = [to_jax(P, v, grad=True) for v in raw]
    targs = [to_torch(v, grad=True) for v in raw]
    touts = _float_leaves(_leaves(invoke(T, case, targs)))
    jouts = [j for j in _leaves(invoke(P, case, jargs))
             if hasattr(j, "_data") and np.asarray(j._data).dtype.kind == "f"]
    assert len(touts) == len(jouts) and touts, case.id
    r = np.random.RandomState(99)
    ws = [np.asarray(r.randn(*t.shape)).astype(_np(t).dtype)
          for t in touts]
    jloss = None
    tloss = 0
    for j, t, w in zip(jouts, touts, ws):
        jl = P.sum(P.multiply(j, P.to_tensor(w, dtype=str(w.dtype))))
        jloss = jl if jloss is None else P.add(jloss, jl)
        tloss = tloss + (t * torch.from_numpy(w)).sum()
    jin = [a for a in _flat(jargs) if hasattr(a, "_data")
           and not a.stop_gradient]
    tin = [a for a in _flat(targs) if isinstance(a, torch.Tensor)
           and a.requires_grad]
    jg = P.grad(jloss, jin, allow_unused=True)
    tg = torch.autograd.grad(tloss, tin, allow_unused=True)
    for a, b in zip(jg, tg):
        if a is None:
            assert b is None or not b.abs().sum(), case.id
            continue
        np.testing.assert_allclose(_np(b), _np(a), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=case.id + " grad")


ALL_TABLES = {"unary": UNARY, "binary": BINARY, "reduce": REDUCE,
              "creation": CREATION, "logic": LOGIC, "search": SEARCH,
              "manip": MANIP, "linalg": LINALG}
