"""jit.to_static — a function staged as CUDA graphs, after
``paddle_tpu/jit/api.py`` (reference: python/paddle/jit/api.py:171).

The JAX package re-runs the function under ``jax.jit``: one XLA program
per static key, parameters, buffers and optimizer state lifted to its
inputs. Here a static key's program is a CUDA graph of the function's
kernels, the hand kernels of ``ops/kernels`` among them, captured by
``serving/compiled.py``'s :func:`~..serving.compiled.capture` on its
capture stream, in one memory pool per :class:`StaticFunction`. Two modes,
as in JAX:

* **whole-step staging** (``capture=(model, optimizer, ...)``,
  ``api.py:469-632``): the function may call ``backward()`` and
  ``optimizer.step()``; forward, backward, clip and update are one graph.
  On the card a key's first call is one eager step on the capture stream
  (a real step: it builds and loads the kernels, compiles the Triton ones,
  creates the optimizer's static scalars and sets up cuBLAS for the
  stream), its second call captures the step into a graph and replays it,
  and every later call copies its arguments into the static inputs, lets
  each optimizer advance its host counters and rewrite the step's static
  device scalars (the lr tensors and the AdamW launch table, from
  ``get_lr()``: a scheduler's new lr reaches the graph, as the JAX step
  takes ``lrs`` as an input), replays, and returns clones of the static
  outputs. The framework generator (``paddle.seed``'s, which the random
  ops draw from) and the explicit CUDA generators of the captured layers
  (the models' dropout generators) are registered with the graph, so
  every replay draws a fresh mask, as JAX derives a fresh key per call
  (``api.py:528-531``); the default generator is the graph's own. As in
  JAX, the parameters' ``.grad`` are None after a staged step.
* **forward staging** (``to_static(layer)`` or ``to_static(fn)``,
  ``api.py:373-449``): without autograd (eval, ``no_grad``) one forward
  graph; with autograd a graphed autograd function, a forward graph and a
  backward graph as ``torch.cuda.make_graphed_callables`` builds them, on
  the eager tape, so ``loss.backward()`` outside still works (each
  call's backward runs before the next call of the same key, as with
  ``make_graphed_callables``: the graph's saved activations are reused;
  an out-of-order backward raises). BatchNorm's running statistics are
  updated in place inside the forward graph.

The **static key** is the arguments' skeleton (non-tensor arguments are
part of it), every tensor's shape, dtype and device, the layers'
``training`` flags, the AMP state (``amp.auto_cast.amp_key``) and the
mode. The walk of the captured state is cached and guarded by a
structural version (``nn.layer.layers.STRUCT_VERSION``) that torch's
global registration hooks bump whenever any module gains a parameter,
buffer or submodule, and ``Layer.__delattr__`` whenever a layer loses
one (:meth:`invalidate` for edits neither can see), and steady
whole-step calls dispatch through a memo on the arguments' signature
(``api.py:451-467``).

**Graph breaks** (``api.py:81-121``, ``:326-371``): a host sync — an
``.item()``, ``bool()`` / ``float()`` / ``int()`` of a tensor, a copy
between the CPU and the card, ``nonzero`` or another data-dependent
shape — cannot be staged. A ``TorchDispatchMode`` active while a function
is staged raises :class:`GraphBreak` at the op, before CUDA sees it, so
the capture ends cleanly and is thrown away, and the host state the
capture's Python touched (``.grad``, the optimizers' counters and
accumulator entries) is put back; on the card a capture executes
nothing, so the tensors are untouched. With ``full_graph=False`` the
break warns once in the JAX package's words and the key runs eagerly from
then on (the same hand kernels, launched one by one); with
``full_graph=True`` it raises. A ``GradScaler`` step breaks at
``unscale_``'s ``bool()``, as JAX's does at its concretization, so it runs
eagerly. ``stats()`` counts the breaks and the eager calls. A failure
that is not a graph break raises.

**On the CPU** there are no graphs. A key's first call is its staging
call, run under the same dispatch mode, so the CPU sees the breaks the
card sees: it really executes, and params, buffers, ``.grad``, optimizer
slots and host counters are snapshotted before it and restored when it
breaks, as JAX's trace restores them in its ``finally``
(``api.py:611-631``). Later calls run the function.

**Control flow** (``api.py:197-210``, ``:239``): unless
``convert_control_flow=False``, the function's own ``if`` / ``while`` /
``for range`` are rewritten by ``jit/dy2static.py``, so a tensor-valued
``if`` stages through ``jit/control_flow.py``'s ``cond`` (both branches,
selected on the device) instead of breaking the graph at its host read.
An ``if`` whose branches do more than assign tensors to names (a call
such as ``opt.step()``, an in-place method, a store), and an unbounded
``while``, still read their predicate on the host: a break where the
call is staged or captured, and a plain read in the card's warm-up call,
which really runs.
``build_strategy``, ``backend`` and ``donate_state`` are accepted, as in
JAX, and do nothing here. Not ported: ``aot_compile`` and
``compiled_text`` (XLA's).
Whole-step staging keeps its optimizers' step counters and bias
corrections advancing once per replay; a scheduler stepped inside the
staged function steps only when the function's Python runs, as in JAX:
step it outside.
"""
from __future__ import annotations

import inspect
import threading
import time
import types
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["to_static", "not_to_static", "InputSpec", "StaticFunction",
           "ignore_module", "GraphBreak"]


class GraphBreak(RuntimeError):
    """A staged function did what cannot be staged: a host sync."""


class _EagerFallback(Exception):
    """Internal: this input signature graph-broke before — skip staging."""


# ---------------------------------------------------- structural version
# moved by torch's global registration hooks and by ``Layer.__delattr__``
from ..nn.layer.layers import STRUCT_VERSION as _STRUCT_VERSION  # noqa: E402


# ------------------------------------------------------------- breaks
# aten ops that read a tensor's value on the host, or whose output shape
# depends on its values
_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive"})


class _SyncDetector(TorchDispatchMode):
    """Raises :class:`GraphBreak` at a host sync while it is active."""

    def __enter__(self):
        _tls.detecting = getattr(_tls, "detecting", 0) + 1
        return super().__enter__()

    def __exit__(self, *exc):
        _tls.detecting -= 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _SYNC_OPS:
            raise GraphBreak(f"aten.{name} reads a tensor on the host (an "
                             f".item(), bool(), float() or int() of a "
                             f"tensor, or a data-dependent shape)")
        if name in ("_to_copy", "copy_") and args:
            if name == "copy_":
                src, dst = args[1].device, args[0].device
            else:
                src = args[0].device
                dst = torch.device(kwargs.get("device") or src)
            if src.type != dst.type and "cpu" in (src.type, dst.type):
                raise GraphBreak(f"aten.{name} copies between {src} and "
                                 f"{dst}")
        return func(*args, **kwargs)


def _is_graph_break(e):
    """True when ``e`` (or an exception it was raised from) means "this
    cannot be staged", not "the program is wrong"."""
    seen = 0
    while e is not None and seen < 10:
        if isinstance(e, GraphBreak):
            return True
        e = e.__cause__
        seen += 1
    return False


class _break_key_scope:
    """Tags an exception escaping a staging region with the key it broke
    under, so ``__call__`` blacklists the right signature."""

    def __init__(self, key):
        self._key = key

    def __enter__(self):
        return self

    def __exit__(self, etype, e, tb):
        if e is not None and not isinstance(e, _EagerFallback) \
                and not hasattr(e, "_pd_break_key"):
            try:
                e._pd_break_key = self._key
            except AttributeError:
                pass
        return False


_tls = threading.local()


def is_staging():
    """True while this thread stages a function (its warm-up, staging or
    capture call): host reads there would break the graph."""
    return getattr(_tls, "depth", 0) > 0


def host_reads_break():
    """True while this thread stages or captures under the sync detector
    (a CPU staging call, a capture): a host read there is a graph break.
    False in a warm-up call on the card, which really runs."""
    return getattr(_tls, "detecting", 0) > 0


class _staging:
    """Marks the thread as staging: a StaticFunction called inside runs
    its function inline (nested ``jax.jit`` inlines too)."""

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1

    def __exit__(self, *exc):
        _tls.depth -= 1
        return False


# ------------------------------------------------------------ key parts
class InputSpec:
    """Reference: paddle.static.InputSpec: a shape (``None`` or ``-1``
    for a dynamic size) and a dtype. ``jit.save`` exports by it; a staged
    function keys on the tensors it is called with."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = [None if d is None or int(d) < 0 else int(d)
                      for d in shape]
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _tree_flatten(obj, tensors):
    """Nested args -> a skeleton; the tensors are appended to ``tensors``."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("T", len(tensors) - 1)
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,
                tuple(_tree_flatten(o, tensors) for o in obj))
    if isinstance(obj, dict):
        # sorted keys: two dicts with equal keys flatten alike
        return ("dict", tuple((k, _tree_flatten(obj[k], tensors))
                              for k in sorted(obj)))
    return ("C", obj)  # a static constant: part of the key


def _tree_rebuild(skel, tensors):
    kind = skel[0]
    if kind == "T":
        return tensors[skel[1]]
    if kind in ("list", "tuple"):
        seq = [_tree_rebuild(s, tensors) for s in skel[1]]
        return seq if kind == "list" else tuple(seq)
    if kind == "dict":
        return {k: _tree_rebuild(v, tensors) for k, v in skel[1]}
    return skel[1]


def _hashable(s):
    kind = s[0]
    if kind == "C":
        try:
            hash(s[1])
            return s
        except TypeError:
            return ("C", repr(s[1]))
    if kind in ("list", "tuple"):
        return (kind, tuple(_hashable(x) for x in s[1]))
    if kind == "dict":
        return (kind, tuple((k, _hashable(v)) for k, v in s[1]))
    return s


def _static_key(skel, tensors, extra):
    shapes = tuple((tuple(t.shape), t.dtype, t.device.type) for t in tensors)
    return (_hashable(skel), shapes, extra)


def _amp_key():
    from ..amp.auto_cast import amp_key
    return amp_key()


def _generators(layers, dev):
    """The explicit CUDA generators a capture on ``dev`` registers: the
    framework generator of ``dev`` (``paddle.rand``, ``bernoulli``, ...
    draw from it) and those the layers' modules hold (dropout's
    ``generator``, attention's ``dropout_generator``)."""
    from ..core import random as prandom
    g = prandom.generator(dev)
    out = {id(g): g}
    for layer in layers:
        for m in layer.modules():
            for v in vars(m).values():
                if isinstance(v, torch.Generator) and v.device.type == "cuda":
                    out[id(v)] = v
    return list(out.values())


def _on_cuda(tensors):
    return any(t.is_cuda for t in tensors)


def _cuda_device(tensors):
    return next(t.device for t in tensors if t.is_cuda)


def _run_on(stream, fn):
    """``fn()`` on ``stream``, after the current stream's work so far and
    before its later work -> fn's result."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    return out


def _detached(outs):
    return [t.detach() for t in outs]


# -------------------------------------------------------------- entries
class _Entry:
    """One static key's program: its warm-up, its graph(s) and what they
    keep."""

    def __init__(self):
        self.ready = False      # first call done (CPU staging / warm-up)
        self.skel = None        # the arguments' skeleton (whole step)
        self.captured = None    # Captured (whole step, no-grad forward)
        self.graphed = None     # _Graphed (forward on the tape)
        self.static_in = None   # the graph's argument tensors
        self.out_skel = None
        self.stores = {}        # optimizer -> its store of this step
        self.keep = []          # pool tensors the graph writes after


class _Graphed:
    """A forward graph and a backward graph of one function
    (``make_graphed_callables``'s pair)."""

    def __init__(self, fwd, bwd, n_args, surface, rg, static_grads):
        self.fwd, self.bwd = fwd, bwd
        self.n_args = n_args          # user tensors lead the surface
        self.surface = surface        # static args, then the params
        self.rg = rg                  # outputs that require grad
        self.static_grads = static_grads
        self.replays = 0              # forward replays so far


class _GraphedFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphed, *inputs):
        for s, x in zip(graphed.surface[:graphed.n_args], inputs):
            if s.data_ptr() != x.data_ptr():
                s.copy_(x)
        outs = [o.clone() for o in graphed.fwd.replay()]
        graphed.replays += 1
        ctx.graphed, ctx.replay = graphed, graphed.replays
        ctx.mark_non_differentiable(*[o for o, rg in zip(outs, graphed.rg)
                                      if not rg])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.graphed
        if ctx.replay != g.replays:
            raise RuntimeError(
                "to_static: this staged forward ran again before the "
                "backward of an earlier call, whose saved activations the "
                "graph has overwritten; run each call's backward before "
                "the next call (as with torch.cuda.make_graphed_callables)")
        for s, gr in zip(g.static_grads, [gr for gr, rg in zip(grads, g.rg)
                                          if rg]):
            if gr is None:
                s.zero_()
            else:
                s.copy_(gr)
        gin = iter(g.bwd.replay())
        out = [next(gin) if x.requires_grad else None for x in g.surface]
        return (None,) + tuple(None if t is None else t.detach()
                               for t in out)


# ---------------------------------------------------------------- staged
class StaticFunction:
    """The callable ``to_static`` returns (reference: jit/dy2static/
    program_translator.py ASTStaticFunction)."""

    def __init__(self, function, input_spec=None, capture=None,
                 build_strategy=None, backend=None, full_graph=False,
                 donate_state=True, convert_control_flow=True):
        self._raw_fn = function
        self._input_spec = input_spec
        self._capture = list(capture) if capture is not None else None
        self._full_graph = full_graph
        self._broken_keys = set()   # input signatures that graph-broke
        self._cache = {}
        self._state_cache = None    # cached _state() walk
        self._state_version = None
        self._fast_step = {}        # steady-state whole-step memo
        self._materialized = False
        self._pool = None
        self._stats = {"warmups": 0, "staged": 0, "graphs": 0,
                       "replays": 0, "graph_breaks": 0, "eager_calls": 0,
                       "capture_s": 0.0}
        self._layer = None
        if isinstance(function, torch.nn.Module):
            self._layer = function
            self._fn = function.forward
        else:
            self._fn = function
            owner = getattr(function, "__self__", None)
            if isinstance(owner, torch.nn.Module):
                self._layer = owner
        if convert_control_flow:
            self._fn = _convert_fn(self._fn)

    # -- state discovery --
    def invalidate(self):
        """Drop the cached state walk and the dispatch memo: after a
        structural change the registration hooks cannot see (a direct
        ``_parameters`` edit), or after re-materializing optimizer state."""
        self._state_cache = None
        self._fast_step = {}

    def _state_cached(self):
        if self._state_cache is not None \
                and _STRUCT_VERSION[0] != self._state_version:
            self.invalidate()
        if self._state_cache is None:
            self._state_cache = self._state()
            self._state_version = _STRUCT_VERSION[0]
        return self._state_cache

    def _state(self):
        """(params, buffers, optimizer slots, layers, optimizers): every
        tensor the staged function can read or write."""
        from ..optimizer import Optimizer
        layers, opts = [], []
        if self._layer is not None:
            layers.append(self._layer)
        for item in self._capture or []:
            if isinstance(item, torch.nn.Module):
                layers.append(item)
            elif isinstance(item, Optimizer):
                opts.append(item)
            elif isinstance(getattr(item, "_inner", None), Optimizer):
                opts.append(item._inner)
            elif isinstance(getattr(item, "_inner_opt", None), Optimizer):
                opts.append(item._inner_opt)
            else:
                raise TypeError(
                    f"capture item {type(item).__name__} is neither a Layer "
                    "nor an Optimizer (or optimizer wrapper); its state "
                    "cannot be staged")
        params, buffers, seen = [], [], set()
        for layer in layers:
            for p in layer.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
            for b in layer.buffers():
                if id(b) not in seen:
                    seen.add(id(b))
                    buffers.append(b)
        slots = [s for opt in opts for s in opt._state_slots()]
        return params, buffers, slots, layers, opts

    def stats(self):
        """Counts of this function's staging: ``entries`` (static keys
        seen), ``warmups`` (first eager calls on the card), ``staged``
        (CPU staging calls), ``graphs`` captured, ``replays``,
        ``graph_breaks`` and ``eager_calls`` (the fallback's), and
        ``capture_s``."""
        return dict(self._stats, entries=len(self._cache),
                    broken_keys=len(self._broken_keys))

    # -- dispatch --
    def __call__(self, *args, **kwargs):
        if getattr(_tls, "depth", 0):
            return self._fn(*args, **kwargs)
        try:
            if self._capture is not None:
                return self._call_whole_step(args, kwargs)
            return self._call_forward(args, kwargs)
        except _EagerFallback:
            pass
        except Exception as e:
            if self._full_graph or not _is_graph_break(e):
                raise
            first_line = (str(e).splitlines() or [""])[0]
            warnings.warn(
                f"to_static: falling back to eager for "
                f"{getattr(self._raw_fn, '__name__', self._raw_fn)} — "
                f"{type(e).__name__}: {first_line[:200]} "
                "(graph-break fallback; pass full_graph=True to make this "
                "an error)", stacklevel=2)
            self._stats["graph_breaks"] += 1
            key = getattr(e, "_pd_break_key", None)
            if key is not None:
                self._broken_keys.add(key)
                self._cache.pop(key, None)  # never ran as a program
        # the region that refused to stage runs eagerly (the same hand
        # kernels, launched one by one), outside the handler: the break's
        # traceback, and the aborted capture's tensors it holds, are gone
        self._stats["eager_calls"] += 1
        return self._fn(*args, **kwargs)

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _entry(self, key):
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Entry()
        return entry

    # -- mode 1: a staged forward on the eager tape --
    def _call_forward(self, args, kwargs):
        params, buffers, _, layers, _ = self._state_cached()
        arg_tensors: list = []
        skel = _tree_flatten((args, tuple(sorted(kwargs.items()))),
                             arg_tensors)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in params + arg_tensors)
        key = _static_key(skel, params + buffers + arg_tensors, (
            "fwd", len(params), len(buffers),
            tuple(layer.training for layer in layers), _amp_key(), grad))
        if key in self._broken_keys:
            raise _EagerFallback
        with _break_key_scope(key):
            entry = self._entry(key)
            if not _on_cuda(params + buffers + arg_tensors):
                return self._forward_cpu(entry, skel, arg_tensors, buffers)
            if not entry.ready:
                # the first call: eager, and real (the warm-up); without
                # autograd on the stream the capture will take
                entry.ready = True
                self._stats["warmups"] += 1
                if grad:
                    return self._fn(*args, **kwargs)
                from ..serving.compiled import capture_stream
                stream = capture_stream(_cuda_device(
                    params + buffers + arg_tensors))
                with _staging():
                    return _run_on(stream, lambda: self._fn(*args, **kwargs))
            if entry.captured is None and entry.graphed is None:
                self._capture_forward(entry, skel, arg_tensors, params,
                                      buffers, layers, grad)
            if entry.graphed is not None:
                outs = _GraphedFunction.apply(entry.graphed, *arg_tensors,
                                              *params)
            else:
                for s, x in zip(entry.static_in, arg_tensors):
                    if s.data_ptr() != x.data_ptr():
                        s.copy_(x)
                outs = [o.clone() for o in entry.captured.replay()]
            self._stats["replays"] += 1
            return _tree_rebuild(entry.out_skel, list(outs))

    def _run_flat(self, skel, tensors, entry):
        """Call the function on ``tensors`` laid out as ``skel`` -> its
        output tensors (the skeleton goes to ``entry.out_skel``)."""
        rebuilt_args, kw_items = _tree_rebuild(skel, tensors)
        out = self._fn(*rebuilt_args, **dict(kw_items))
        outs: list = []
        entry.out_skel = _tree_flatten(out, outs)
        return outs

    def _forward_cpu(self, entry, skel, arg_tensors, buffers):
        if entry.ready:
            return _tree_rebuild(entry.out_skel, self._run_flat(
                skel, arg_tensors, entry))
        saved = [b.detach().clone() for b in buffers]
        try:
            with _staging(), _SyncDetector():
                outs = self._run_flat(skel, arg_tensors, entry)
        except BaseException:
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)
            raise
        entry.ready = True
        self._stats["staged"] += 1
        return _tree_rebuild(entry.out_skel, outs)

    def _capture_forward(self, entry, skel, arg_tensors, params, buffers,
                         layers, grad):
        from ..serving.compiled import capture, capture_stream
        t0 = time.perf_counter()
        dev = _cuda_device(params + buffers + arg_tensors)
        stream, pool = capture_stream(dev), self._graph_pool()
        gens = _generators(layers, dev)
        static = [a.detach().clone().requires_grad_(a.requires_grad)
                  for a in arg_tensors]
        if grad:
            # a pool of its own: its forward's saved activations, freed
            # after the backward's capture, are read by every backward
            # replay, so no other entry's graph may reuse them
            entry.graphed = self._graphed(entry, skel, static, params,
                                          buffers, gens, stream,
                                          torch.cuda.graph_pool_handle())
        if entry.graphed is None:
            with _staging(), _SyncDetector():
                entry.captured = capture(
                    lambda: _detached(self._run_flat(skel, static, entry)),
                    pool, stream, warm_up=False, generators=gens)
            entry.static_in = static
        self._stats["graphs"] += 1
        self._stats["capture_s"] += time.perf_counter() - t0

    def _graphed(self, entry, skel, static, params, buffers, gens, stream,
                 pool):
        """The forward and backward graphs of the function on the static
        arguments and the parameters (``make_graphed_callables``): one
        warm-up of both on the capture stream (the buffers it updates are
        put back), then the two captures -> :class:`_Graphed`, or None
        when no output needs a gradient (a forward graph alone then)."""
        from ..serving.compiled import capture
        surface = static + list(params)
        inputs = [t for t in surface if t.requires_grad]
        saved = [b.detach().clone() for b in buffers]

        def warm_up():
            outs = self._run_flat(skel, static, entry)
            rg = [o for o in outs if o.requires_grad]
            if rg:
                torch.autograd.grad(rg, inputs, [torch.zeros_like(o)
                                                 for o in rg],
                                    allow_unused=True)
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)
            return bool(rg)

        with _staging():
            if not _run_on(stream, warm_up):
                return None
        holder = {}

        def forward():
            outs = self._run_flat(skel, static, entry)
            holder["outs"] = outs
            return _detached(outs)

        with _staging(), _SyncDetector():
            fwd = capture(forward, pool, stream, warm_up=False, grad=True,
                          generators=gens)
            outs = holder.pop("outs")
            rg = [o.requires_grad for o in outs]
            static_grads = [torch.empty_like(o) for o in outs
                            if o.requires_grad]
            bwd = capture(lambda: torch.autograd.grad(
                [o for o in outs if o.requires_grad], inputs, static_grads,
                allow_unused=True), pool, stream, warm_up=False, grad=True)
        return _Graphed(fwd, bwd, len(static), surface, rg, static_grads)

    # -- mode 2: the whole train step as one graph --
    def _fast_sig(self, args, kwargs, layers):
        """A cheap dispatch signature for the steady re-call: only for
        bare tensor positionals and no kwargs."""
        if kwargs:
            return None
        sig = []
        for a in args:
            if not isinstance(a, torch.Tensor):
                return None
            sig.append((a.shape, a.dtype, a.device))
        return (tuple(sig), tuple(layer.training for layer in layers),
                _amp_key())

    def _call_whole_step(self, args, kwargs):
        fast, st = self._fast_step, self._state_cache
        if fast and st is not None:
            if _STRUCT_VERSION[0] != self._state_version:
                self.invalidate()
            else:
                sig = self._fast_sig(args, kwargs, st[3])
                hit = fast.get(sig) if sig is not None else None
                if hit is not None:
                    return self._exec_step(hit, list(args), st)
        state = self._state_cached()
        if not self._materialized:
            # create the accumulators up front, so the step stages with
            # all of its state
            for opt in state[4]:
                if not opt._state_slots():
                    opt.materialize()
            self._materialized = True
            self._state_cache = None
            state = self._state_cached()
        params, buffers, slots, layers, _ = state
        arg_tensors: list = []
        skel = _tree_flatten((args, tuple(sorted(kwargs.items()))),
                             arg_tensors)
        key = _static_key(skel, params + buffers + arg_tensors, (
            "step", len(params), len(buffers), len(slots),
            tuple(layer.training for layer in layers), _amp_key()))
        if key in self._broken_keys:
            raise _EagerFallback
        entry = self._entry(key)
        entry.skel = skel
        with _break_key_scope(key):
            out = self._exec_step(entry, arg_tensors, state)
        # memoize only after a staged call went through, so a signature
        # that broke never lands in the memo
        sig = self._fast_sig(args, kwargs, layers)
        if sig is not None and (entry.captured is not None
                                or not _on_cuda(params + arg_tensors)):
            self._fast_step[sig] = entry
        return out

    def _exec_step(self, entry, arg_tensors, state):
        params, buffers, slots, layers, opts = state
        if not _on_cuda(params + buffers + arg_tensors):
            outs = self._step_cpu(entry, arg_tensors, state)
        elif not entry.ready:
            outs = self._warm_up_step(entry, arg_tensors, state)
        else:
            if entry.captured is None:
                self._capture_step(entry, arg_tensors, state)
            for s, x in zip(entry.static_in, arg_tensors):
                if s.data_ptr() != x.data_ptr():
                    s.copy_(x)
            for opt in opts:
                opt._replay_step(entry.stores[opt])
            outs = [o.clone() for o in entry.captured.replay()]
            self._stats["replays"] += 1
        for p in params:
            p.grad = None
        return _tree_rebuild(entry.out_skel, outs)

    def _staged_opts(self, entry, opts):
        """Hand each optimizer its store of this step, its counters of one
        staged run reset."""
        for opt in opts:
            store = entry.stores.setdefault(opt, {})
            store["calls"] = store["steps"] = 0
            opt._staged = store

    def _step_cpu(self, entry, arg_tensors, state):
        params, buffers, _, _, opts = state
        self._staged_opts(entry, opts)
        try:
            if entry.ready:
                return _detached(self._run_flat(entry.skel, arg_tensors,
                                                entry))
            snap = _snapshot(params, buffers, opts)
            try:
                with _staging(), _SyncDetector():
                    outs = self._run_flat(entry.skel, arg_tensors, entry)
            except BaseException:
                _restore(snap, params, buffers, opts)
                raise
            entry.ready = True
            self._stats["staged"] += 1
            return _detached(outs)
        finally:
            for opt in opts:
                opt._staged = None

    def _warm_up_step(self, entry, arg_tensors, state):
        """The key's first call on the card: one real eager step on the
        capture stream."""
        from ..serving.compiled import capture_stream
        params, buffers, _, _, opts = state
        stream = capture_stream(_cuda_device(params + buffers + arg_tensors))
        self._staged_opts(entry, opts)
        try:
            with _staging():
                outs = _run_on(stream, lambda: _detached(self._run_flat(
                    entry.skel, arg_tensors, entry)))
        finally:
            for opt in opts:
                opt._staged = None
        entry.ready = True
        self._stats["warmups"] += 1
        return outs

    def _capture_step(self, entry, arg_tensors, state):
        """Capture the step on static copies of the arguments. The capture
        runs the step's Python but executes nothing on the card, so only
        the host state it touched is put back: ``.grad``, the optimizers'
        counters and accumulator entries."""
        from ..serving.compiled import capture, capture_stream
        params, buffers, _, layers, opts = state
        t0 = time.perf_counter()
        dev = _cuda_device(params + buffers + arg_tensors)
        static = [a.detach().clone() for a in arg_tensors]
        grads = [p.grad for p in params]
        host = [opt._host_state() for opt in opts]
        self._staged_opts(entry, opts)
        keep, made = [], set()

        def step():
            outs = self._run_flat(entry.skel, static, entry)
            # what the step leaves in .grad lives in the pool and is
            # written by every replay: keep it referenced
            keep.extend(p.grad for p in params if p.grad is not None)
            return _detached(outs)

        try:
            with _staging(), _SyncDetector():
                captured = capture(step, self._graph_pool(),
                                   capture_stream(dev), warm_up=False,
                                   grad=torch.is_grad_enabled(),
                                   generators=_generators(layers, dev))
        finally:
            for p, g in zip(params, grads):
                p.grad = g
            for opt, h in zip(opts, host):
                made |= _new_entries(opt, h)
                opt._set_host_state(h)
                opt._staged = None
        if made:
            raise RuntimeError(
                f"optimizer state was created while the step was captured "
                f"and cannot be staged: {sorted(made)}. Implement "
                f"_materialize_param on the optimizer so its accumulators "
                f"exist before the capture.")
        entry.static_in, entry.captured, entry.keep = static, captured, keep
        self._stats["graphs"] += 1
        self._stats["capture_s"] += time.perf_counter() - t0


def _new_entries(opt, host):
    """Accumulator and master entries ``opt`` has now that its
    :meth:`_host_state` snapshot ``host`` lacks -> {(type, name)}."""
    _, accs, masters = host
    made = {(type(opt).__name__, name)
            for name, per in opt._accumulators.items()
            for p in per if p not in accs.get(name, {})}
    if any(p not in masters for p in opt._master_weights):
        made.add((type(opt).__name__, "master_weights"))
    return made


def _snapshot(params, buffers, opts):
    """What a CPU staging call can change: parameter and buffer values,
    ``.grad``, every optimizer tensor's value and the host state."""
    def val(t):
        return None if t is None else t.detach().clone()

    return ([val(p) for p in params], [val(p.grad) for p in params],
            [val(b) for b in buffers],
            [(opt._host_state(), [(c, k, val(c[k]) if torch.is_tensor(c[k])
                                   else c[k]) for c, k in opt._state_slots()])
             for opt in opts])


def _restore(snap, params, buffers, opts):
    pvals, gvals, bvals, ostate = snap
    with torch.no_grad():
        for p, v, g in zip(params, pvals, gvals):
            p.copy_(v)
            p.grad = g
        for b, v in zip(buffers, bvals):
            b.copy_(v)
        for opt, (host, slots) in zip(opts, ostate):
            opt._set_host_state(host)
            for c, k, v in slots:
                if torch.is_tensor(v):
                    c[k].copy_(v)
                else:
                    c[k] = v


def _convert_fn(fn):
    """The dy2static pass (``jit/dy2static.py``): a tensor-valued ``if`` /
    ``while`` / ``for range`` of the function stages through
    ``jit/control_flow.py``; a bound method is converted on its
    ``__func__`` and bound again (``api.py:197-210``)."""
    from .dy2static import convert_to_static
    if inspect.ismethod(fn):
        conv = convert_to_static(fn.__func__)
        return fn if conv is fn.__func__ else types.MethodType(
            conv, fn.__self__)
    return convert_to_static(fn)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, capture=None, **kwargs):
    """Reference: python/paddle/jit/api.py:171 (paddle.jit.to_static).

    ``full_graph=False`` (the default) falls back to eager with a warning
    where staging meets what cannot be staged; ``full_graph=True`` makes
    that an error. ``capture=(model, optimizer, ...)`` stages the whole
    train step (see the module's notes). A layer is staged in place: its
    ``forward`` becomes the :class:`StaticFunction`."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn, input_spec, capture,
                                        full_graph=full_graph)
            return fn
        return StaticFunction(fn, input_spec, capture, full_graph=full_graph)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    return None
