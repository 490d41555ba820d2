"""Dy2static: Python ``if`` / ``while`` / ``for range`` over tensors ->
``cond`` / ``while_loop``, after ``paddle_tpu/jit/dy2static.py``
(reference: python/paddle/jit/dy2static/program_translator.py:773,
ifelse_transformer.py, loop_transformer.py, convert_operators.py).

The AST pass is the JAX module's: each ``if`` whose test is not a literal
becomes two branch functions and a ``convert_ifelse`` call over the names
the branches assign; each ``while`` (and ``for <name> in range(...)``)
becomes a condition function, a body function and a ``convert_while``
call over the names the body assigns and the condition reads; ``and`` /
``or`` / ``not`` in a converted test become lazy converters; a block
holding ``return`` / ``break`` / ``continue`` stays Python, its test
guarded so that a staged tensor predicate breaks the graph
(:class:`~.api.GraphBreak`) instead of tracing one branch. Nested
functions and comprehensions keep their Python.

The runtime converters call ``jit/control_flow.py``: a tensor predicate
while a program is staged (``control_flow.staged``) goes to ``cond`` /
``while_loop``; anything else is plain Python with the eager semantics.
A staged ``cond`` runs both branches and can select only the names they
assign, so an ``if`` whose branches do anything else (a bare call such as
``opt.step()``, an in-place method such as ``buf.add_(1)``, a store to an
attribute or a subscript, any statement but an assignment to names), or
that assigns no tensor, reads its predicate on the host instead
(``control_flow.read_staged``): a graph break where a program is traced
or captured, so the call runs eagerly as it did before conversion. A call
with effects hidden in an assignment's value (``ok = opt.step()``) is not
seen.

Where the port differs from the JAX pass (both kept as deviations):

* a branch function takes the names it assigns as arguments, so a
  branch may read a name before it assigns it (``loss = loss + z``). The
  JAX pass makes such a name local to the branch function, which raises
  ``UnboundLocalError`` there;
* a name that one branch leaves unbound is unbound after a staged
  ``cond`` (JAX raises on the structures' mismatch);
* a loop whose predicate is a Python bool (``for i in range(3)``) stays a
  Python loop while staged, so it unrolls into the graph; JAX takes it to
  ``lax.while_loop`` as soon as a loop variable is a traced tensor;
* the converted function keeps the original's closure cells and module
  globals (JAX copies both into a new globals dict) and its source lines.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import types

import torch

from .api import GraphBreak, _tree_flatten
from .control_flow import cond as _cond
from .control_flow import read_staged, staged
from .control_flow import while_loop as _while_loop

__all__ = ["convert_to_static", "convert_ifelse", "convert_while",
           "unsupported_in_converted_block", "GraphBreak"]


class _Missing:
    def __repr__(self):
        return "<unbound>"


_MISSING = _Missing()  # a name unbound on a branch or loop path


def _is_traced_bool(x):
    return isinstance(x, torch.Tensor) and staged()


def convert_ifelse(pred, true_fn, false_fn):
    """Runtime dispatch of a rewritten ``if`` (reference:
    convert_operators.py convert_ifelse)."""
    if _is_traced_bool(pred):
        return _cond(pred, true_fn, false_fn)
    taken = bool(pred.reshape(()).item()) if isinstance(pred, torch.Tensor) \
        else bool(pred)
    return true_fn() if taken else false_fn()


def _convert_ifelse_rt(pred, true_fn, false_fn, names, values, effect):
    """The call the pass emits: branch functions over the assigned names'
    current values (``_MISSING`` where unbound); ``effect`` is what the
    branches do besides assigning names (None if nothing)."""
    if not _is_traced_bool(pred):
        return convert_ifelse(pred, lambda: true_fn(*values),
                              lambda: false_fn(*values))
    if effect is not None or not names:
        why = (f"an if over a staged tensor whose branches hold "
               f"{effect or 'no assignment'} cannot run both branches and "
               "select")
        return true_fn(*values) if read_staged(pred, why) \
            else false_fn(*values)
    t_out, f_out = true_fn(*values), false_fn(*values)
    keep = [i for i, (a, b) in enumerate(zip(t_out, f_out))
            if a is not _MISSING and b is not _MISSING]
    tensors: list = []
    _tree_flatten([t_out[i] for i in keep], tensors)
    if not tensors:
        why = ("an if over a staged tensor whose branches assign no "
               "tensor has nothing to select")
        return t_out if read_staged(pred, why) else f_out
    picked = _cond(pred, lambda: tuple(t_out[i] for i in keep),
                   lambda: tuple(f_out[i] for i in keep))
    out = [_MISSING] * len(names)
    for i, v in zip(keep, picked):
        out[i] = v
    return tuple(out)


def _as_tensor_like(v, like):
    if isinstance(v, bool) or v is _MISSING or not isinstance(
            v, (int, float)):
        return v
    dtype = torch.int32 if isinstance(v, int) else torch.float32
    return torch.full((), v, dtype=dtype, device=like.device)


def convert_while(cond_fn, body_fn, loop_vars):
    """Runtime dispatch of a rewritten ``while`` (reference:
    convert_operators.py convert_while_loop)."""
    probe = cond_fn(*loop_vars)
    if _is_traced_bool(probe):
        # loop-carried Python numbers become device tensors: a staged loop
        # cannot change Python values across its iterations
        return _while_loop(cond_fn, body_fn,
                           [_as_tensor_like(v, probe) for v in loop_vars])
    vars_now = list(loop_vars)
    while bool(probe.reshape(()).item()) if isinstance(probe, torch.Tensor) \
            else bool(probe):
        vars_now = list(body_fn(*vars_now))
        probe = cond_fn(*vars_now)
    return vars_now


def unsupported_in_converted_block(kind):
    raise GraphBreak(
        f"'{kind}' inside a tensor-dependent if/while cannot be staged by "
        "the dy2static converter (reference break_continue_transformer "
        "capability); to_static falls back to eager for this call "
        "(full_graph=True turns this into a hard error)")


def assert_concrete_pred(pred, kind):
    """The guard of an unconverted block (it holds return / break /
    continue): fine as Python while the predicate is concrete; a staged
    tensor predicate breaks the graph."""
    if _is_traced_bool(pred):
        unsupported_in_converted_block(kind)
    return pred


class _AssignedNames(ast.NodeVisitor):
    """Names bound by a statement list (reference: ifelse_transformer's
    get_name_ids)."""

    def __init__(self):
        self.names: set = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name):
            self.names.add(node.target.id)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # nested defs bind their own scope
        self.names.add(node.name)

    def visit_Lambda(self, node):
        pass


class _ReadNames(ast.NodeVisitor):
    def __init__(self):
        self.names: set = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.names.add(node.id)


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


def _read(nodes):
    v = _ReadNames()
    for n in nodes if isinstance(nodes, list) else [nodes]:
        v.visit(n)
    return v.names


_ESCAPES = (ast.Return, ast.Break, ast.Continue, ast.Yield, ast.YieldFrom,
            ast.Await, ast.Global, ast.Nonlocal)


def _contains_flow_escape(stmts):
    """The first statement kind that cannot move into a branch or loop
    function: ``return`` / ``break`` / ``continue`` (JAX's three), and a
    ``yield``, ``await``, ``global``, ``nonlocal`` or zero-argument
    ``super()``."""
    for s in stmts:
        for node in ast.walk(s):
            if isinstance(node, _ESCAPES):
                return type(node).__name__.lower()
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id == "super" \
                    and not node.args:
                return "super()"   # it reads the enclosing method's self
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                break  # nested scopes own their control flow
    return None


def _names_only(target):
    if isinstance(target, ast.Name):
        return True
    if isinstance(target, (ast.Tuple, ast.List)):
        return all(_names_only(e) for e in target.elts)
    return isinstance(target, ast.Starred) and _names_only(target.value)


def _effect(stmts):
    """What ``stmts`` do besides assigning names, as words, or None: a
    statement other than an assignment to names (or a nested ``if`` /
    ``for`` / ``while`` of such), an in-place method call (a name ending
    in ``_``) or an ``out=`` argument."""
    for s in stmts:
        if isinstance(s, (ast.If, ast.While, ast.For)):
            inner = _effect(s.body) or _effect(s.orelse)
            if inner:
                return inner
            targets = [s.target] if isinstance(s, ast.For) else []
            exprs = [s.iter] if isinstance(s, ast.For) else [s.test]
        elif isinstance(s, ast.Assign):
            targets, exprs = s.targets, [s.value]
        elif isinstance(s, (ast.AugAssign, ast.AnnAssign)):
            targets, exprs = [s.target], [s.value]
        elif isinstance(s, ast.Pass):
            continue
        elif isinstance(s, ast.Expr):
            return "a bare expression (a call such as opt.step())"
        else:
            return f"a {type(s).__name__.lower()} statement"
        if not all(_names_only(t) for t in targets):
            return "a store to an attribute or a subscript"
        for node in (n for e in exprs if e is not None
                     for n in ast.walk(e)):
            if not isinstance(node, ast.Call):
                continue
            attr = getattr(node.func, "attr", "")
            if attr.endswith("_") and not attr.endswith("__"):
                return f"an in-place call ({attr})"
            if any(k.arg == "out" for k in node.keywords):
                return "a call with out="
    return None


def _name(id_, ctx):
    return ast.Name(id=id_, ctx=ctx)


def _args(names):
    return ast.arguments(posonlyargs=[], args=[ast.arg(arg=n) for n in names],
                         kwonlyargs=[], kw_defaults=[], defaults=[])


def _maybe_tensor_pred(test):
    """Every ``if`` whose test is not a literal is rewritten; the runtime
    keeps Python's semantics for a concrete predicate."""
    return not isinstance(test, ast.Constant)


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites If / While / For(range) into ``convert_ifelse`` /
    ``convert_while`` calls. Only the function's own control flow is
    rewritten (nested defs and comprehensions keep Python)."""

    def __init__(self):
        self.counter = 0

    def _fresh(self, base):
        self.counter += 1
        return f"__pd_{base}_{self.counter}"

    def visit_FunctionDef(self, node):
        new_body = []
        for s in node.body:
            r = self.visit(s)
            if isinstance(r, list):
                new_body.extend(r)
            elif r is not None:
                new_body.append(r)
        node.body = new_body
        return node

    def _guard(self, node, esc):
        """The block stays Python; its test is guarded so a staged tensor
        predicate breaks the graph instead of tracing one branch."""
        self.counter += 1
        node.test = ast.Call(
            func=_name("__pd_assert_concrete", ast.Load()),
            args=[node.test, ast.Constant(value=esc)], keywords=[])
        return node

    def _guard_unbound(self, names):
        """Names a converted block assigns may be unbound before it
        (reference: UndefinedVar): bind them to the sentinel."""
        stmts = []
        for n in names:
            src = (f"try:\n    {n}\nexcept (NameError, "
                   f"UnboundLocalError):\n    {n} = __pd_MISSING")
            stmts.append(ast.parse(src).body[0])
        return stmts

    def _fn(self, fn_name, params, body, out_names):
        ret = ast.Return(value=ast.Tuple(
            elts=[_name(n, ast.Load()) for n in out_names], ctx=ast.Load()))
        return ast.FunctionDef(name=fn_name, args=_args(params),
                               body=list(body) + [ret], decorator_list=[],
                               returns=None, type_params=[])

    def visit_If(self, node):
        effect = _effect(node.body) or _effect(node.orelse)
        node = self.generic_visit(node)
        if not _maybe_tensor_pred(node.test):
            return node
        esc = _contains_flow_escape(node.body) or \
            _contains_flow_escape(node.orelse)
        if esc:
            return self._guard(node, esc)
        node.test = _LogicalTransformer().visit(node.test)
        out_names = sorted(
            n for n in (_assigned(node.body) | _assigned(node.orelse))
            if n != "_" and not n.startswith("__pd_"))
        true_name = self._fresh("true")
        false_name = self._fresh("false")
        stmts = self._guard_unbound(out_names) + [
            self._fn(true_name, out_names, node.body, out_names),
            self._fn(false_name, out_names, node.orelse or [ast.Pass()],
                     out_names),
        ]
        call = ast.Call(
            func=_name("__pd_convert_ifelse", ast.Load()),
            args=[node.test, _name(true_name, ast.Load()),
                  _name(false_name, ast.Load()),
                  ast.Tuple(elts=[ast.Constant(value=n) for n in out_names],
                            ctx=ast.Load()),
                  ast.Tuple(elts=[_name(n, ast.Load()) for n in out_names],
                            ctx=ast.Load()),
                  ast.Constant(value=effect)],
            keywords=[])
        if out_names:
            target = ast.Tuple(elts=[_name(n, ast.Store())
                                     for n in out_names], ctx=ast.Store())
            stmts.append(ast.Assign(targets=[target], value=call))
        else:
            stmts.append(ast.Expr(value=call))
        return stmts

    def _rewrite_loop(self, node, cond_expr, pre_stmts, body):
        loop_names = sorted(n for n in _assigned(body)
                            if n != "_" and not n.startswith("__pd_"))
        # names the condition reads ride along too (loop-invariant tensors
        # the staged condition needs)
        cond_reads = sorted(n for n in _read(cond_expr) - set(loop_names)
                            if not n.startswith("__pd_"))
        all_names = loop_names + cond_reads
        cond_name = self._fresh("loopcond")
        body_name = self._fresh("loopbody")
        cond_fn = ast.FunctionDef(
            name=cond_name, args=_args(all_names),
            body=[ast.Return(value=cond_expr)], decorator_list=[],
            returns=None, type_params=[])
        body_fn = self._fn(body_name, all_names, body, all_names)
        call = ast.Call(
            func=_name("__pd_convert_while", ast.Load()),
            args=[_name(cond_name, ast.Load()), _name(body_name, ast.Load()),
                  ast.List(elts=[_name(n, ast.Load()) for n in all_names],
                           ctx=ast.Load())],
            keywords=[])
        target = ast.List(elts=[_name(n, ast.Store()) for n in all_names],
                          ctx=ast.Store())
        return pre_stmts + self._guard_unbound(loop_names) + \
            [cond_fn, body_fn, ast.Assign(targets=[target], value=call)]

    def visit_While(self, node):
        node = self.generic_visit(node)
        if node.orelse or not _maybe_tensor_pred(node.test):
            return node  # while/else stays Python
        esc = _contains_flow_escape(node.body)
        if esc:
            return self._guard(node, esc)
        return self._rewrite_loop(node, _LogicalTransformer().visit(
            node.test), [], node.body)

    def visit_For(self, node):
        node = self.generic_visit(node)
        # only `for <name> in range(<expr>[, <expr>])` is rewritten
        if (node.orelse or not isinstance(node.target, ast.Name)
                or not isinstance(node.iter, ast.Call)
                or not isinstance(node.iter.func, ast.Name)
                or node.iter.func.id != "range"
                or len(node.iter.args) not in (1, 2)
                or _contains_flow_escape(node.body)):
            return node
        ivar = node.target.id
        if len(node.iter.args) == 1:
            start, stop = ast.Constant(value=0), node.iter.args[0]
        else:
            start, stop = node.iter.args
        stop_name = self._fresh("stop")
        pre = [
            ast.Assign(targets=[_name(ivar, ast.Store())],
                       value=ast.Call(func=_name("__pd_loop_index",
                                                 ast.Load()),
                                      args=[start], keywords=[])),
            ast.Assign(targets=[_name(stop_name, ast.Store())], value=stop),
        ]
        test = ast.Compare(left=_name(ivar, ast.Load()), ops=[ast.Lt()],
                           comparators=[_name(stop_name, ast.Load())])
        inc = ast.Assign(
            targets=[_name(ivar, ast.Store())],
            value=ast.BinOp(left=_name(ivar, ast.Load()), op=ast.Add(),
                            right=ast.Call(
                                func=_name("__pd_loop_index", ast.Load()),
                                args=[ast.Constant(value=1)], keywords=[])))
        return self._rewrite_loop(node, test, pre, list(node.body) + [inc])


def _loop_index(v):
    """Loop counters stay Python ints (a concrete loop unrolls); tensors
    pass through for tensor bounds."""
    return v


def convert_logical_and(l_fn, r_fn):
    """Reference: convert_operators.py convert_logical_and — lazy
    operands keep Python's short-circuit for concrete values; tensors
    combine by ``logical_and``."""
    lhs = l_fn()
    if isinstance(lhs, torch.Tensor):
        return torch.logical_and(lhs, _as_bool_tensor(r_fn(), lhs))
    if not lhs:
        return lhs
    return r_fn()


def convert_logical_or(l_fn, r_fn):
    lhs = l_fn()
    if isinstance(lhs, torch.Tensor):
        return torch.logical_or(lhs, _as_bool_tensor(r_fn(), lhs))
    if lhs:
        return lhs
    return r_fn()


def convert_logical_not(v):
    if isinstance(v, torch.Tensor):
        return torch.logical_not(v)
    return not v


def _as_bool_tensor(v, like):
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), bool(v), dtype=torch.bool, device=like.device)


class _LogicalTransformer(ast.NodeTransformer):
    """and / or / not inside converted tests -> the lazy converters
    (reference: dy2static/transformers/logical_transformer.py)."""

    def visit_BoolOp(self, node):
        node = self.generic_visit(node)
        fn = "__pd_logical_and" if isinstance(node.op, ast.And) \
            else "__pd_logical_or"
        out = node.values[0]
        for rhs in node.values[1:]:
            out = ast.Call(func=_name(fn, ast.Load()),
                           args=[ast.Lambda(args=_args([]), body=out),
                                 ast.Lambda(args=_args([]), body=rhs)],
                           keywords=[])
        return out

    def visit_UnaryOp(self, node):
        node = self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_name("__pd_logical_not", ast.Load()),
                            args=[node.operand], keywords=[])
        return node


_HELPERS = {"__pd_convert_ifelse": _convert_ifelse_rt,
            "__pd_convert_while": convert_while,
            "__pd_unsupported": unsupported_in_converted_block,
            "__pd_assert_concrete": assert_concrete_pred,
            "__pd_loop_index": _loop_index,
            "__pd_logical_and": convert_logical_and,
            "__pd_logical_or": convert_logical_or,
            "__pd_logical_not": convert_logical_not,
            "__pd_MISSING": _MISSING}


def convert_to_static(fn):
    """AST-rewrite ``fn`` so tensor-dependent if / while / for(range) go
    through ``cond`` / ``while_loop`` while staged. Returns ``fn`` itself
    when its source is unavailable (builtins, lambdas, C extensions), when
    it is a decorator's wrapper (``__wrapped__``: its source is another
    function's), a generator or a coroutine, or when it has no control
    flow to rewrite."""
    if getattr(fn, "_not_to_static", False) or \
            getattr(fn, "__pd_converted__", False) or \
            not isinstance(fn, types.FunctionType) or \
            hasattr(fn, "__wrapped__") or \
            fn.__code__.co_flags & (inspect.CO_GENERATOR
                                    | inspect.CO_COROUTINE):
        return fn
    try:
        lines, first = inspect.getsourcelines(fn)
        tree = ast.parse(textwrap.dedent("".join(lines)))
    except (OSError, TypeError, SyntaxError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return fn
    fdef.decorator_list = []  # run undecorated (to_static wraps it)
    tr = _ControlFlowTransformer()
    tr.visit(fdef)
    if not tr.counter:
        return fn
    # compile the function inside a factory whose parameters are the
    # original's free variables and the helpers, then bind its code to the
    # original's own cells: closures stay live, zero-argument super()
    # keeps its __class__ cell, and the module's globals are the live ones
    free = list(fn.__code__.co_freevars)
    factory = ast.FunctionDef(
        name="__pd_factory", args=_args(free + list(_HELPERS)),
        body=[fdef, ast.Return(value=_name(fdef.name, ast.Load()))],
        decorator_list=[], returns=None, type_params=[])
    module = ast.Module(body=[factory], type_ignores=[])
    ast.fix_missing_locations(module)
    ast.increment_lineno(module, first - 1)
    code = compile(module, inspect.getsourcefile(fn) or "<dy2static>",
                   "exec")
    factory_code = next(c for c in code.co_consts
                        if isinstance(c, types.CodeType))
    inner = next(c for c in factory_code.co_consts
                 if isinstance(c, types.CodeType) and c.co_name == fdef.name)
    cells = dict(zip(free, fn.__closure__ or ()))
    cells[fdef.name] = own = cells.get(fdef.name, types.CellType())
    closure = tuple(cells[n] if n in cells else types.CellType(_HELPERS[n])
                    for n in inner.co_freevars)
    converted = types.FunctionType(inner, fn.__globals__, fn.__name__,
                                   fn.__defaults__, closure)
    if own is not fn.__closure__ and fdef.name not in free:
        own.cell_contents = converted   # a recursive call: itself
    converted.__kwdefaults__ = fn.__kwdefaults__
    converted = functools.wraps(fn)(converted)
    converted.__pd_converted__ = True
    return converted
