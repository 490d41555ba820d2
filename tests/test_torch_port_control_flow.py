"""The port's tensor control flow (``jit/control_flow.py``) and dy2static
(``jit/dy2static.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_control_flow.py`` (its ``generate`` case aside,
whose program has its own port), each in both packages on the same
numpy inputs (and carried weights where a layer trains): eager ``cond``,
its gradient and ``while_loop``; ``cond`` staged by ``to_static`` (both
branches, the selected branch's gradient in a whole step, nesting, the
structure error); ``while_loop`` staged (without a bound a graph break
that runs eagerly with JAX's values, and JAX's refusal to differentiate
it; with ``max_steps`` the masked unroll's values and gradients at trip
counts 0, 3 and 8, a data-dependent stop, the bound in eager mode, under
``no_grad``); ``scan_loop``'s gradient; ``case`` / ``switch_case``; and a
staged training step with ``cond``. Then dy2static: a Python ``if`` on a
tensor, ``for range``, ``and`` / ``not``, ``return`` under a tensor
``if`` (a graph break), and the port's repair of a branch that reads the
name it assigns (``loss = loss + z``), where the JAX pass raises
``UnboundLocalError``. On the CPU a key's first call is its staging call,
so each staged case runs twice: staged, then as Python. Tolerances: f32
``rtol 1e-4 / atol 1e-5`` (1e-6 against a hand unroll, as JAX's test)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import cond as jcond
from paddle_tpu.jit import scan_loop as jscan
from paddle_tpu.jit import to_static as jstatic
from paddle_tpu.jit import while_loop as jwhile
from paddle_tpu.static.nn import case as jcase
from paddle_tpu.static.nn import switch_case as jswitch

import paddle_tpu_torch as pt
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.jit import GraphBreak, cond, scan_loop, to_static, \
    while_loop
from paddle_tpu_torch.static.nn import case, switch_case

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _port_device():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def j(x, **kw):
    return paddle.to_tensor(np.asarray(x, dtype="float32"), **kw)


def t(x, grad=False):
    return torch.tensor(np.asarray(x, dtype="float32"), requires_grad=grad)


def _np(v):
    return np.asarray(v._data, np.float32) if isinstance(v, Tensor) else \
        v.detach().float().numpy()


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ eager
@pytest.mark.parametrize("flag", [True, False])
def test_cond_eager_picks_branch(flag):
    _close(cond(torch.tensor(flag), lambda: t([1., 2.]) * 2,
                lambda: t([1., 2.]) * 3),
           jcond(paddle.to_tensor(flag), lambda: j([1., 2.]) * 2,
                 lambda: j([1., 2.]) * 3))


def test_cond_eager_grads():
    x = t([1.0, 2.0], grad=True)
    cond(t(1.0) > t(0.0), lambda: (x * x).sum(), lambda: x.sum()).backward()
    xj = j([1.0, 2.0], stop_gradient=False)
    jcond(j(1.0) > j(0.0), lambda: (xj * xj).sum(),
          lambda: xj.sum()).backward()
    _close(x.grad, xj.grad)


def test_while_loop_eager():
    i, s = while_loop(lambda i, s: i < 5, lambda i, s: [i + 1, s + 2.0],
                      [torch.tensor(0, dtype=torch.int32), t(0.0)])
    ji, js = jwhile(lambda i, s: i < paddle.to_tensor(np.int32(5)),
                    lambda i, s: [i + paddle.to_tensor(np.int32(1)),
                                  s + 2.0],
                    [paddle.to_tensor(np.int32(0)), j(0.0)])
    assert int(i) == int(ji.numpy()) == 5
    _close(s, js)


# ----------------------------------------------------------------- staged
def test_cond_staged_runs_both_branches_and_selects():
    def f(x, flag):
        return cond(flag > 0, lambda: x * 2, lambda: x * 3)

    def g(x, flag):
        return jcond(flag > 0, lambda: x * 2, lambda: x * 3)

    sf, sg = to_static(f, full_graph=True), jstatic(g)
    for v in (1.0, -1.0, 1.0, -1.0):
        _close(sf(t([1., 2.]), t(v)), sg(j([1., 2.]), j(v)))
    assert sf.stats()["staged"] == 1 and sf.stats()["graph_breaks"] == 0


def test_cond_staged_grads_through_selected_branch():
    w0 = np.array([[2.0], [3.0]], "float32")
    jl = jnn.Linear(2, 1, bias_attr=False)
    jl.weight.set_value(w0)
    tl = pt.nn.Linear(2, 1, bias_attr=False)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w0))

    def make(lin, cnd):
        def step_fn(x, flag):
            wv = lin.weight
            loss = cnd(flag > 0, lambda: (x.matmul(wv * wv)).sum(),
                       lambda: (x.matmul(wv)).sum())
            loss.backward()
            return loss, lin.weight.grad * 1.0
        return step_fn

    tstep = to_static(make(tl, cond), capture=(tl,), full_graph=True)
    jstep = jstatic(make(jl, jcond), capture=(jl,))
    for v, want in ((1.0, [4.0, 6.0]), (-1.0, [1.0, 1.0]), (1.0, [4., 6.])):
        _, g = tstep(t([[1.0, 1.0]]), t(v))
        _, jg = jstep(j([[1.0, 1.0]]), j(v))
        np.testing.assert_allclose(_np(g).ravel(), want)
        _close(g, jg)


def test_cond_nested_staged():
    def f(x, a, b):
        return cond(a > 0, lambda: cond(b > 0, lambda: x + 1.0,
                                        lambda: x + 2.0),
                    lambda: x * 10.0)

    sf = to_static(f, full_graph=True)
    for a, b, want in ((1., 1., 2.), (1., -1., 3.), (-1., 1., 10.),
                       (1., -1., 3.)):
        np.testing.assert_allclose(_np(sf(t([1.0]), t(a), t(b))), [want])


def test_cond_structure_and_branch_errors_as_jax():
    def f(x, flag):
        return cond(flag > 0, lambda: x, lambda: x[:1])

    def g(x, flag):
        return jcond(flag > 0, lambda: x, lambda: x[:1])

    with pytest.raises(ValueError, match="same structure"):
        to_static(f)(t([1.0, 2.0]), t(1.0))
    with pytest.raises(ValueError, match="same structure"):
        jstatic(g)(j([1.0, 2.0]), j(1.0))
    with pytest.raises(ValueError, match="both true_fn and false_fn"):
        to_static(lambda x: cond(x > 0, lambda: x))(t(1.0))
    with pytest.raises(ValueError, match="at least one Tensor"):
        to_static(lambda x: cond(x > 0, lambda: None, lambda: None))(t(1.))


def test_while_loop_staged_without_bound_breaks_and_runs_eagerly():
    """Deviation (ROADMAP Queue 3): JAX stages ``lax.while_loop``; the
    port breaks the graph and runs the call eagerly, with JAX's values."""
    def f(x, n):
        i = torch.zeros((), dtype=torch.int32)
        i, x = while_loop(lambda i, x: i < n, lambda i, x: [i + 1, x * 2.0],
                          [i, x])
        return x

    def g(x, n):
        i = paddle.zeros([], "int32")
        i, x = jwhile(lambda i, x: i < n,
                      lambda i, x: [i + paddle.ones([], "int32"), x * 2.0],
                      [i, x])
        return x

    sf, sg = to_static(f), jstatic(g)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for n in (3, 5):
            _close(sf(t([1.0]), torch.tensor(n, dtype=torch.int32)),
                   sg(j([1.0]), paddle.to_tensor(np.int32(n))))
    assert any("GraphBreak" in str(m.message) for m in w)
    assert sf.stats()["graph_breaks"] == 1
    with pytest.raises(GraphBreak):
        to_static(f, full_graph=True)(t([1.0]), torch.tensor(3))


def test_while_loop_staged_refuses_a_gradient_as_jax():
    w = t([1.0], grad=True)
    wj = j([1.0], stop_gradient=False)

    def f(n):
        return while_loop(lambda i, y: i < n, lambda i, y: [i + 1, y * 2.0],
                          [torch.zeros((), dtype=torch.int32), w * 1.0])[1]

    def g(n):
        return jwhile(lambda i, y: i < n,
                      lambda i, y: [i + paddle.ones([], "int32"), y * 2.0],
                      [paddle.zeros([], "int32"), wj * 1.0])[1]

    with pytest.raises(RuntimeError, match="forward-only"):
        to_static(f)(torch.tensor(3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="forward-only"):
        jstatic(g)(paddle.to_tensor(np.int32(3)))


def test_scan_loop_differentiable():
    w = t([1.5], grad=True)
    y = scan_loop(lambda i, y: y * w, t([2.0]), n_steps=3).sum()
    y.backward()
    wj = j([1.5], stop_gradient=False)
    yj = jscan(lambda i, y: y * wj, j([2.0]), n_steps=3).sum()
    yj.backward()
    _close(y, yj)
    _close(w.grad, wj.grad, rtol=1e-6)
    ys = to_static(lambda a: scan_loop(lambda i, y: y * a + i, a, 4),
                   full_graph=True)(t([0.5]))
    yjs = jscan(lambda i, y: y * j([0.5]) + i.astype("float32"), j([0.5]),
                n_steps=4)
    _close(ys, yjs)


def test_case_and_switch_case():
    x, xj = t([1.0]), j([1.0])

    def f(idx):
        return switch_case(idx, {0: lambda: x * 1.0, 1: lambda: x * 2.0,
                                 2: lambda: x * 3.0})

    def g(idx):
        return jswitch(idx, {0: lambda: xj * 1.0, 1: lambda: xj * 2.0,
                             2: lambda: xj * 3.0})

    sf, sg = to_static(f, full_graph=True), jstatic(g)
    for i in (0, 1, 2, 1):
        _close(sf(torch.tensor(i)), sg(paddle.to_tensor(np.int64(i))))
        _close(f(i), sg(paddle.to_tensor(np.int64(i))))
    _close(case([(t(0.0) > t(1.0), lambda: x * 5.0)],
                default=lambda: x * 7.0),
           jcase([(j(0.0) > j(1.0), lambda: xj * 5.0)],
                 default=lambda: xj * 7.0))


def test_cond_in_whole_step_training_matches_jax():
    paddle.seed(0)
    jm = jnn.Linear(4, 1)
    tm = pt.params_from_paddle_tpu(
        {n: np.asarray(v._data) for n, v in jm.state_dict().items()},
        pt.nn.Linear(4, 1))
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    topt = pt.SGD(learning_rate=0.1, parameters=tm.parameters())

    def make(model, opt, cnd, mse):
        def train_step(xb, yb, flag):
            pred = model(xb)
            loss = cnd(flag > 0, lambda: mse(pred, yb),
                       lambda: (pred - yb).abs().mean())
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return train_step

    tstep = to_static(make(tm, topt, cond, pt.nn.functional.mse_loss),
                      capture=(tm, topt), full_graph=True)
    jstep = jstatic(make(jm, jopt, jcond, JF.mse_loss), capture=(jm, jopt))
    rng = np.random.RandomState(0)
    xb, yb = rng.randn(8, 4).astype("f4"), rng.randn(8, 1).astype("f4")
    losses = []
    for v in (1.0, 1.0, -1.0, 1.0):
        lt = tstep(t(xb), t(yb), t(v))
        lj = jstep(j(xb), j(yb), j(v))
        _close(lt, lj)
        losses.append(float(lt))
    assert losses[1] < losses[0]
    _close(tm.weight, jm.weight)


# ------------------------------------------------------ while max_steps
def _unrolled(W0, h0, n, port):
    if port:
        W, h = t(W0, grad=True), t(h0, grad=True)
        hh = h * 1.0
        for _ in range(n):
            hh = torch.tanh(hh.matmul(W))
        loss = hh.sum()
        loss.backward()
        return loss, W.grad, h.grad
    W, h = j(W0, stop_gradient=False), j(h0, stop_gradient=False)
    hh = h * 1.0
    for _ in range(n):
        hh = paddle.tanh(hh.matmul(W))
    loss = hh.sum()
    loss.backward()
    return loss, W.grad, h.grad


@pytest.mark.parametrize("n", [0, 3, 8])
def test_while_loop_max_steps_differentiable(n):
    """The masked unroll's loss and gradients equal a hand unroll's and
    JAX's ``_while_loop_grad``'s at trip counts 0, 3 and 8 (the bound)."""
    rng = np.random.RandomState(0)
    W0 = rng.randn(4, 4).astype("float32") * 0.3
    h0 = rng.randn(1, 4).astype("float32")
    W, h = t(W0, grad=True), t(h0, grad=True)

    def f(n, W, h):
        _, hf = while_loop(lambda i, hh: i < n,
                           lambda i, hh: [i + 1, torch.tanh(hh.matmul(W))],
                           [torch.zeros((), dtype=torch.int32), h * 1.0],
                           max_steps=8)
        return hf.sum()

    loss = to_static(f, full_graph=True)(
        torch.tensor(n, dtype=torch.int32), W, h)
    loss.backward()
    lu, gwu, ghu = _unrolled(W0, h0, n, port=True)
    _close(loss, lu, rtol=1e-5)
    _close(W.grad if W.grad is not None else torch.zeros(4, 4), gwu
           if gwu is not None else torch.zeros(4, 4), rtol=1e-4, atol=1e-6)
    _close(h.grad, ghu, rtol=1e-4, atol=1e-6)
    lj, gwj, _ = _unrolled(W0, h0, n, port=False)
    _close(loss, lj)


def test_while_loop_max_steps_data_dependent_stop():
    def f(x):
        _, y = while_loop(lambda i, y: y.sum() < 100.0,
                          lambda i, y: [i + 1, y * 2.0],
                          [torch.zeros((), dtype=torch.int32), x],
                          max_steps=16)
        return y.sum()

    x = t([3.0], grad=True)
    loss = to_static(f, full_graph=True)(x)
    np.testing.assert_allclose(loss.item(), 192.0)
    loss.backward()
    np.testing.assert_allclose(_np(x.grad), [64.0])


@pytest.mark.parametrize("mode", ["eager", "staged", "no_grad"])
def test_while_loop_max_steps_bounds_every_mode(mode):
    def f(x):
        _, y = while_loop(lambda i, y: y.sum() < 1e9,
                          lambda i, y: [i + 1, y * 2.0],
                          [torch.zeros((), dtype=torch.int32), x],
                          max_steps=4)
        return y

    def g(x):
        with torch.no_grad():
            return f(x)

    fn = {"eager": f, "staged": to_static(f, full_graph=True),
          "no_grad": to_static(g, full_graph=True)}[mode]
    np.testing.assert_allclose(_np(fn(t([1.0]))), [16.0])


# -------------------------------------------------------------- dy2static
def _zloss(x, w):
    loss = x.sum()
    if w > 0:
        loss = loss + w * (x * x).sum()
    return loss


def test_dy2static_if_on_a_tensor_stages_and_repairs_jaxs_branch():
    """A Python ``if`` on a tensor stages through ``cond`` (1 staging call,
    no break). Its branch reads ``loss`` before assigning it: the port's
    branch functions take the names they assign (ROADMAP Queue 3); the
    JAX pass makes ``loss`` local there and raises."""
    sf = to_static(_zloss, full_graph=True)
    x = t([1.0, 2.0, 3.0])
    for w in (2.0, -2.0, 0.5, -1.0):
        np.testing.assert_allclose(_np(sf(x, t(w))), _np(_zloss(x, t(w))),
                                   rtol=0, atol=0)
    assert sf.stats()["staged"] == 1 and sf.stats()["graph_breaks"] == 0
    with pytest.raises(Exception, match="loss"):
        jstatic(_zloss)(j([1.0, 2.0, 3.0]), j(2.0))


def test_dy2static_matches_jax_on_if_else_and_logic():
    def f(x, a, b):
        if a > 0 and not (b > 0):
            y = x * 2.0
        elif b > 0:
            y = x + 1.0
        else:
            y = x - 1.0
        for _ in range(3):
            y = y * 1.5
        return y

    sf, sg = to_static(f, full_graph=True), jstatic(f)
    for a, b in ((1., -1.), (1., 1.), (-1., -1.), (-1., 1.), (1., -1.)):
        _close(sf(t([1.0, 2.0]), t(a), t(b)),
               sg(j([1.0, 2.0]), j(a), j(b)))


def test_dy2static_return_under_a_tensor_if_breaks_the_graph():
    def f(x, a):
        if a > 0:
            return x * 2.0
        return x * 3.0

    sf = to_static(f)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        for a in (1.0, -1.0):
            _close(sf(t([1.0]), t(a)), f(t([1.0]), t(a)))
    assert sf.stats()["graph_breaks"] == 1
    with pytest.raises(GraphBreak, match="return"):
        to_static(f, full_graph=True)(t([1.0]), t(1.0))


def test_dy2static_keeps_closures_live_and_methods_bound():
    scale = [2.0]

    def f(x, a):
        if a > 0:
            x = x * scale[0]
        return x

    sf = to_static(f, full_graph=True)
    scale[0] = 5.0
    np.testing.assert_allclose(_np(sf(t([1.0]), t(1.0))), [5.0])

    class M(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = pt.nn.Linear(2, 2)

        def forward(self, x, a):
            if a > 0:
                x = self.lin(x)
            return super().__call__ is not None and x

    m = M()
    want = m(t([[1.0, 2.0]]), t(1.0))
    to_static(m)
    np.testing.assert_allclose(_np(m(t([[1.0, 2.0]]), t(1.0))), _np(want),
                               rtol=0, atol=0)
    assert m.forward.stats()["graph_breaks"] == 0


def test_dy2static_leaves_a_decorated_wrapper_alone():
    """A decorator's wrapper (``torch.no_grad()`` here) is not rewritten:
    its source is the wrapped function's, and dropping the decorator
    would change what the call does."""
    @torch.no_grad()
    def f(x, a):
        if a > 0:
            x = x * 2.0
        return x

    sf = to_static(f)
    out = sf(t([1.0], grad=True), t(1.0))
    assert not out.requires_grad
    np.testing.assert_allclose(_np(out), [2.0])


def _effect_step(model, opt, kind):
    """A staged step whose tensor ``if`` has effects beyond assigning
    names: they must happen only when the predicate holds."""
    buf = torch.zeros(())

    def step(xb, flag):
        loss = model(xb).square().mean()
        loss.backward()
        if kind == "call":
            if flag > 0:
                opt.step()
        elif kind == "nested":
            if flag > 0:
                if kind:
                    opt.step()
        else:
            if flag > 0:
                buf.add_(1.0)
                opt.step()
        opt.clear_grad()
        return loss

    return step, buf


@pytest.mark.parametrize("kind", ["call", "nested", "inplace"])
def test_dy2static_if_with_effects_runs_only_the_taken_branch(kind):
    """An ``if`` over a staged tensor whose branch calls ``opt.step()``
    (or an in-place method) cannot run both branches and select: it
    breaks the graph and runs eagerly, so a false predicate leaves the
    parameters unchanged and a true one takes exactly one step."""
    torch.manual_seed(0)
    tm = pt.nn.Linear(4, 1)
    topt = pt.SGD(learning_rate=0.1, parameters=tm.parameters())
    step, buf = _effect_step(tm, topt, kind)
    staged = to_static(step, capture=(tm, topt))
    xb = t(np.random.RandomState(0).randn(8, 4))
    w0 = tm.weight.detach().clone()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            staged(xb, t(-1.0))
        assert torch.equal(tm.weight, w0) and float(buf) == 0.0
        staged(xb, t(1.0))
    assert any("cannot run both branches" in str(m.message) for m in w)
    assert not torch.equal(tm.weight, w0)
    assert float(buf) == (1.0 if kind == "inplace" else 0.0)
    with pytest.raises(GraphBreak, match="cannot run both branches"):
        to_static(step, capture=(tm, topt), full_graph=True)(xb, t(-1.0))


def test_dy2static_if_assigning_no_tensor_reads_its_predicate():
    """A pure ``if`` that assigns only Python values has no tensor for
    ``cond`` to select: it breaks the graph (JAX's cond refuses such
    branches) and the eager call picks the branch."""
    def f(x, a):
        if a > 0:
            k = 2
        else:
            k = 3
        return x * k

    sf = to_static(f)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        for a in (1.0, -1.0):
            _close(sf(t([1.0]), t(a)), f(t([1.0]), t(a)))
    assert sf.stats()["graph_breaks"] == 1
    with pytest.raises(GraphBreak, match="no tensor"):
        to_static(f, full_graph=True)(t([1.0]), t(1.0))


def test_unbounded_while_loop_runs_in_a_warm_up_call():
    """Where a staged call really runs (``to_static``'s warm-up on the
    card: staging without the sync detector) an unbounded ``while_loop``
    reads its predicate as Python does, with JAX's values; only a traced
    or captured call breaks the graph."""
    from paddle_tpu_torch.jit.api import _staging

    def f(x, n):
        i = torch.zeros((), dtype=torch.int32)
        return while_loop(lambda i, y: i < n, lambda i, y: [i + 1, y * 2.0],
                          [i, x])[1]

    with _staging():
        got = f(t([1.0]), torch.tensor(3, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), [8.0])
