"""Static-graph ``Program`` / ``Executor``, after
``paddle_tpu/static/program.py`` (reference: python/paddle/base/
framework.py Program:6174 and program_guard, base/executor.py:1608
Executor.run, static/input.py data).

The JAX package records at its single op dispatch (``_maybe_record``,
``:175-224``, output shapes by ``jax.eval_shape``). The port has no single
dispatch, so a :class:`Variable` records itself: it is a ``torch.Tensor``
subclass over a *fake* tensor (``FakeTensorMode`` with a ``ShapeEnv``),
and its ``__torch_function__`` appends a node (the torch function, its
arguments) to its :class:`Program` and answers with new Variables whose
shapes the function gave on the fake tensors. ``static.data``'s ``None``
(or ``-1``) dimensions are symbolic sizes: every axis-0 one shares the
program's ``batch`` symbol, every other gets one of its own (the rule of
``jit.save``), so a shape computed from them (``x.reshape(*x.shape[:-1],
n)``) is recorded as an expression and evaluated at each run's real
sizes; a Variable's ``shape`` compares equal to JAX's ``[None, 3]``. The
node names are torch's (``addmm``, ``reshape``, ``mean``), not the JAX
dispatch's. The hand kernels enter a program as their ``torch.library``
ops (``ops/kernels/library.py``), which launch the kernels when the
program runs on the card.

``Executor.run`` keeps JAX's semantics (``:256-306``): the startup
program is a no-op (parameters are initialised at creation), evaluation
is eager with the tape live, a recorded ``optimizer.minimize`` replays the
backward and the update, and fetches come back as numpy (bfloat16 as
float32: the card has no ``ml_dtypes``). The feeds go to the device the
program was recorded on (the card unless the CPU was set); an
``Executor`` place of another kind is recorded and, as in the JAX package,
does not move the program.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..device import resolve_device
from ..framework.io import _numpy

__all__ = ["Program", "Variable", "program_guard", "data",
           "default_main_program", "default_startup_program", "Executor",
           "enable_static_mode", "disable_static_mode", "in_static_mode",
           "global_scope", "scope_guard"]

_static_mode = [False]
_HINT = 2   # the example size of a symbolic dimension (torch specialises 0, 1)


def in_static_mode():
    return _static_mode[0]


def enable_static_mode():
    _static_mode[0] = True


def disable_static_mode():
    _static_mode[0] = False


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype or "float32"))


class _Shape(tuple):
    """A Variable's shape: its sizes, symbolic ones among them; compares
    equal to JAX's form, where a symbolic size is ``None``."""

    def __eq__(self, other):
        if not isinstance(other, (list, tuple)) or len(other) != len(self):
            return False
        return all((o is None) if isinstance(s, torch.SymInt) else
                   (o is not None and s == o) for s, o in zip(self, other))

    def __ne__(self, other):
        return not self == other

    __hash__ = tuple.__hash__

    def __repr__(self):
        return repr([None if isinstance(s, torch.SymInt) else s
                     for s in self])


class _Node:
    """One recorded torch call: ``func(*args, **kwargs)``, the Variables
    it produced (its outputs' leaves, in order) and the nodes it needs."""

    __slots__ = ("func", "args", "kwargs", "outs", "deps", "index")

    def __init__(self, func, args, kwargs, deps, index):
        self.func, self.args, self.kwargs = func, args, kwargs
        self.outs, self.deps, self.index = [], deps, index


class Variable(torch.Tensor):
    """A symbolic node of a Program (reference: framework.py Variable):
    a fake tensor's shape and dtype on the program's device, and no data.
    ``shape`` may hold symbolic (``None``) sizes."""

    _pd_recording = True   # ops/kernels/library.py: take the kernel ops

    @staticmethod
    def __new__(cls, program, shape, dtype, name, op=None, ins=None, nout=1,
                out_idx=0, is_feed=False):
        """JAX's constructor: ``shape`` is the sizes (symbolic ones among
        them) or the fake tensor an op gave; ``op`` the recording node
        that made it (None for a feed), output ``out_idx`` of its
        ``nout``, over the inputs ``ins``."""
        if isinstance(shape, torch.Tensor):
            fake = shape
        else:
            _, mode = program._tracer()
            with mode:
                fake = torch.empty(list(shape), dtype=_dtype(dtype),
                                   device=program.device)
        v = torch.Tensor._make_wrapper_subclass(
            cls, fake.shape, dtype=fake.dtype, device=program.device,
            requires_grad=False)
        v._fake, v._program, v._vname = fake, program, name
        v._node, v._is_feed, v._writers = op, is_feed, []
        v._ins, v._nout, v._out_idx = ins or [], nout, out_idx
        v.stop_gradient, v.persistable = True, False
        return v

    @property
    def name(self):
        return self._vname

    @property
    def shape(self):
        return _Shape(self._fake.shape)

    def __repr__(self):
        return (f"Variable(name={self._vname}, shape={self.shape!r}, "
                f"dtype={self.dtype})")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        vars_in = [a for a in leaves if isinstance(a, Variable)]
        prog = vars_in[0]._program
        fake_of = {id(v._fake): v for v in vars_in}

        def fake(a):
            if isinstance(a, Variable):
                return a._fake
            if isinstance(a, torch.Tensor):   # a parameter, a constant
                return prog._mode.from_tensor(a, static_shapes=True)
            return a

        with torch._C.DisableTorchFunctionSubclass(), prog._mode, \
                torch.no_grad():
            out = func(*tree_map(fake, args), **tree_map(fake, kwargs))
        out_leaves, spec = tree_flatten(out)
        name = getattr(func, "__name__", str(func))
        mutates = name == "__setitem__" or (name.endswith("_")
                                            and not name.endswith("__"))
        if not mutates and not any(isinstance(o, torch.Tensor)
                                   for o in out_leaves):
            if name in ("size", "__get__") and isinstance(out, torch.Size):
                return _Shape(out)
            return out   # a query: a size, a dtype, a flag
        deps = {n for v in vars_in for n in [v._node] + v._writers
                if n is not None}
        node = _Node(func, args, kwargs, deps, len(prog._nodes))
        prog._nodes.append(node)
        outs = []
        for o in out_leaves:
            if not isinstance(o, torch.Tensor):
                outs.append(o)
            elif id(o) in fake_of:   # in place: the same Variable, written
                v = fake_of[id(o)]
                v._writers.append(node)
                outs.append(v)
            else:
                v = Variable(prog, o, o.dtype, prog._new_name(name), node,
                             vars_in, len(out_leaves), len(outs))
                prog.vars.append(v)
                outs.append(v)
        if mutates:
            for v in vars_in[:1]:
                if node not in v._writers:
                    v._writers.append(node)
        node.outs = outs
        return tree_unflatten(outs, spec)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(
            f"a static Variable reached {func} below torch's function "
            "layer, which records nothing; run it in dygraph mode")


class Program:
    """Reference: base/framework.py Program — the recorded nodes, the
    data Variables and the optimizer steps to replay."""

    _counter = [0]

    def __init__(self):
        Program._counter[0] += 1
        self.id = Program._counter[0]
        self.feeds: dict = {}          # name -> Variable
        self.vars: list = []
        self.minimize_ops: list = []   # (optimizer, loss Variable)
        self.random_seed = None
        self._nodes: list = []
        self._symbols: dict = {}       # sympy symbol -> (feed Variable, axis)
        self._batch = None
        self._env = self._mode = None
        self._device = None

    @property
    def device(self):
        if self._device is None:
            self._device = resolve_device()
        return self._device

    def _tracer(self):
        if self._mode is None:
            from torch._subclasses.fake_tensor import FakeTensorMode
            from torch.fx.experimental.symbolic_shapes import ShapeEnv
            self._env = ShapeEnv()
            self._mode = FakeTensorMode(shape_env=self._env,
                                        allow_non_fake_inputs=True)
        return self._env, self._mode

    def _symbol(self, label):
        from torch._dynamo.source import ConstantSource
        from torch.fx.experimental.symbolic_shapes import DimDynamic
        env, _ = self._tracer()
        src = ConstantSource(f"{label}_{self.id}_{len(self._symbols)}")
        sym = env.create_symbol(_HINT, source=src,
                                dynamic_dim=DimDynamic.DYNAMIC)
        return sym, env.create_symintnode(sym, hint=_HINT, source=src)

    def _new_name(self, base):
        return f"{base}_{self.id}_{len(self.vars)}"

    def global_block(self):
        return self

    def all_parameters(self):
        """The tensors that need a gradient which the program's nodes
        read, in the order first read."""
        seen, out = set(), []
        for node in self._nodes:
            for a in tree_flatten((node.args, node.kwargs))[0]:
                if isinstance(a, torch.Tensor) and not isinstance(
                        a, Variable) and a.requires_grad \
                        and id(a) not in seen:
                    seen.add(id(a))
                    out.append(a)
        return out

    def clone(self, for_test=False):
        import copy
        p = copy.copy(self)
        if for_test:
            p.minimize_ops = []
        return p

    def __repr__(self):
        return (f"Program(id={self.id}, vars={len(self.vars)}, "
                f"feeds={sorted(self.feeds)})")


_default_main = Program()
_default_startup = Program()


def default_main_program():
    """Reference: paddle.static.default_main_program."""
    return _default_main


def default_startup_program():
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Reference: paddle.static.program_guard."""
    global _default_main, _default_startup
    prev_m, prev_s = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    try:
        yield
    finally:
        _default_main, _default_startup = prev_m, prev_s


def data(name, shape, dtype="float32", lod_level=0):
    """Reference: paddle.static.data (static/input.py): a fed Variable of
    ``shape``, whose ``None`` / ``-1`` sizes are symbolic."""
    prog = _default_main
    sizes = []
    for ax, d in enumerate(shape):
        if d is not None and int(d) >= 0:
            sizes.append(int(d))
            continue
        if ax == 0:
            if prog._batch is None:
                prog._batch = prog._symbol("batch")
            sym, size = prog._batch
        else:
            sym, size = prog._symbol("dyn")
        sizes.append(size)
    v = Variable(prog, sizes, dtype, name, is_feed=True)
    for ax, s in enumerate(sizes):
        if isinstance(s, torch.SymInt):
            prog._symbols.setdefault(s.node.expr, (v, ax))
    prog.feeds[name] = v
    prog.vars.append(v)
    return v


class _Scope:
    def __init__(self):
        self._vars = {}

    def var(self, name):
        return self._vars.setdefault(name, None)

    def find_var(self, name):
        return self._vars.get(name)


_scope = _Scope()


def global_scope():
    return _scope


@contextlib.contextmanager
def scope_guard(scope):
    global _scope
    prev = _scope
    _scope = scope
    try:
        yield
    finally:
        _scope = prev


def _feed_tensor(arr, var, device):
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    return t.to(device=device, dtype=var.dtype)


class Executor:
    """Reference: base/executor.py:1608. ``run`` binds the feeds,
    evaluates the program with the autograd tape live, replays recorded
    minimize ops (backward and the update) and returns the fetches as
    numpy arrays."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        prog = program if program is not None else _default_main
        if prog is _default_startup or (isinstance(prog, Program)
                                        and not prog.vars
                                        and not prog.minimize_ops):
            return []   # startup: parameters are initialised at creation
        run = _Run(prog)
        for name, arr in (feed or {}).items():
            if name not in prog.feeds:
                raise KeyError(f"feed '{name}' is not a data() var of "
                               f"{prog}")
            run.bind(prog.feeds[name], _feed_tensor(arr, prog.feeds[name],
                                                    prog.device))
        was_static = in_static_mode()
        disable_static_mode()   # evaluation itself runs eagerly
        try:
            for opt, loss in prog.minimize_ops:
                if not opt._parameter_list:
                    # reference: the parameters default to the program's
                    # trainable ones; extended in place, as the groups
                    # alias the list
                    opt._parameter_list.extend(prog.all_parameters())
                run.value(loss).backward()
                opt.step()
                opt.clear_grad()
            results = []
            for f in fetch_list or []:
                t = run.value(f) if isinstance(f, Variable) else f
                results.append(_numpy(t) if return_numpy else t)
            return results
        finally:
            if was_static:
                enable_static_mode()

    def close(self):
        return None


class _Run:
    """One evaluation of a program: the fed values, the values of the
    symbolic sizes, and every node's outputs once computed."""

    def __init__(self, prog, subs=None):
        self.prog = prog
        self.env: dict = {}     # id(Variable) -> value
        self.sizes: dict = {}   # sympy symbol -> size
        self.subs = subs or {}  # id(tensor) -> the tensor to read instead
        self.done: set = set()

    def bind(self, var, value):
        self.env[id(var)] = value
        for sym, (v, ax) in self.prog._symbols.items():
            if v is var:
                self.sizes[sym] = value.shape[ax]

    def _arg(self, a):
        if isinstance(a, Variable):
            if id(a) not in self.env:
                raise RuntimeError(
                    f"data variable '{a.name}' was not fed (feed={{...}})")
            return self.env[id(a)]
        if isinstance(a, torch.SymInt):
            return _size(a.node.expr, self.sizes)
        if isinstance(a, torch.Tensor):
            return self.subs.get(id(a), a)
        return a

    def value(self, var):
        """The value of ``var``: its producer and the nodes that wrote it,
        with everything they need, run in recorded order."""
        if var._is_feed or var._node is None:
            return self._arg(var)
        need, stack = set(), [var._node] + var._writers
        while stack:
            n = stack.pop()
            if n.index not in need and n.index not in self.done:
                need.add(n.index)
                stack.extend(n.deps)
        for i in sorted(need):
            self._exec(self.prog._nodes[i])
        return self.env[id(var)]

    def _exec(self, node):
        out = node.func(*tree_map(self._arg, node.args),
                        **tree_map(self._arg, node.kwargs))
        for v, o in zip(node.outs, tree_flatten(out)[0]):
            if isinstance(v, Variable):
                self.env[id(v)] = o
        self.done.add(node.index)


def _size(expr, sizes):
    """A recorded symbolic size at this run's sizes."""
    import sympy
    if expr.is_Integer:
        return int(expr)
    if expr.is_Symbol:
        return sizes[expr]
    args = [_size(a, sizes) for a in expr.args]
    kind = type(expr).__name__
    if isinstance(expr, sympy.Add):
        out = args[0]
        for a in args[1:]:
            out = out + a
        return out
    if isinstance(expr, sympy.Mul):
        out = args[0]
        for a in args[1:]:
            out = out * a
        return out
    if isinstance(expr, sympy.Pow) and expr.exp.is_Integer:
        return args[0] ** int(expr.exp)
    if kind in ("FloorDiv", "CleanDiv"):
        return args[0] // args[1]
    if kind in ("Mod", "PythonMod"):
        return args[0] % args[1]
    raise NotImplementedError(f"symbolic size {expr} ({kind})")
