"""The port's ``jit.to_static`` against the JAX package's, on the CPU.

The cases of ``tests/test_jit.py:21-188`` (save/load aside), each run in
both packages on the same weights (carried by ``params_from_paddle_tpu``)
and the same numpy inputs, ``dropout=0`` where a model has dropout:
forward and backward parity, the decorator form, BatchNorm's buffer
updates, the training flag's second cache entry, the whole step against
eager and against JAX's whole step, the LR scheduler's decayed lr inside
the staged step, output structure per cache entry, a graph break's one
warning and eager results, ``full_graph=True``, the ``GradScaler``
fallback, ``invalidate`` after a new parameter, a ``gpt_tiny`` O2 step
and LeNet with Adam. On the CPU a key's first call is its staging call
(under the same break detector the card's captures run under); no CUDA
graph exists here, so the card's replays are held in
``tests/test_torch_port_card.py``.

Tolerances: f32 ``rtol 1e-4 / atol 1e-5`` against JAX, with Adam's
``epsilon`` 1e-6 (a near-zero second moment would magnify f32 rounding,
as ``tests/test_torch_port_train.py`` says); the port's staged run against
its own eager run is bit-equal here (the same ops in the same order);
the O2 case holds the losses at bf16 precision (``rtol 1e-2``) and the
masters within ``2 * steps * lr``, as ``tests/test_torch_port_train_o2.py``
does.
"""
import copy
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import to_static as jax_to_static
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import LeNet as JaxLeNet
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import GraphBreak, InputSpec, to_static
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch import device as port_device

RTOL, ATOL, EPS = 1e-4, 1e-5, 1e-6



@pytest.fixture(autouse=True)
def _port_device():
    """Layers built without a device go to the CPU (the port's default is
    the card); the device is put back after each test."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before


def _np(t):
    return np.asarray(t._data, np.float32) if isinstance(t, Tensor) else \
        t.detach().float().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _j(a):
    return Tensor(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(jm, tm):
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    return pt.params_from_paddle_tpu(arrays, tm)


def _mse(a, b):
    return ((a - b) ** 2).mean()


def _mlp_pair(seed=11, act="relu"):
    """``tests/test_jit.py``'s MLP in both packages, on JAX's weights."""
    paddle.seed(seed)
    jact, tact = ((jnn.ReLU(), pt.nn.ReLU()) if act == "relu"
                  else (jnn.Tanh(), pt.nn.Tanh()))
    jm = jnn.Sequential(jnn.Linear(6, 16), jact, jnn.Linear(16, 3))
    tm = pt.nn.Sequential(pt.nn.Linear(6, 16, device="cpu"), tact,
                          pt.nn.Linear(16, 3, device="cpu"))
    return jm, _carry(jm, tm)


def _assert_params(tm, jm, rtol=RTOL, atol=ATOL):
    want = {n: np.asarray(p._data, np.float32)
            for n, p in jm.named_parameters()}
    got = pt.params_to_numpy(tm)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _caught(fn):
    """-> (fn's result, the to_static fallback warnings it raised)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w
                 if "to_static: falling back to eager" in str(x.message)]


# ------------------------------------------------------- forward staging
def test_forward_parity_and_cache_hit():
    jm, tm = _mlp_pair()
    x = _x(1, 4, 6)
    eager = tm(_t(x)).detach().clone()
    sj = jax_to_static(copy.deepcopy(jm))
    st = to_static(copy.deepcopy(tm))
    for _ in range(2):              # the second call hits the cache
        out = st(_t(x))
        torch.testing.assert_close(out, eager, rtol=0, atol=0)
        _close(out, sj(_j(x)))
    assert len(st.forward._cache) == len(sj.forward._cache) == 1
    assert st.forward.stats()["staged"] == 1


def test_backward_parity():
    jm, tm = _mlp_pair()
    x, y = _x(2, 4, 6), _x(3, 4, 3)
    jax_to_static(jm)
    to_static(tm)
    jl = JF.mse_loss(jm(Tensor(jnp.asarray(x))), _j(y))
    jl.backward()
    tl = _mse(tm(_t(x)), _t(y))
    tl.backward()
    _close(tl, jl)
    for (n, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        _close(tp.grad, jp.grad, atol=1e-5)


def test_function_decorator():
    @to_static
    def f(a, b):
        return torch.matmul(a, b) + 1.0

    @jax_to_static
    def g(a, b):
        return paddle.matmul(a, b) + 1.0

    a, b = _x(4, 2, 3), _x(5, 3, 2)
    _close(f(_t(a), _t(b)), g(_j(a), _j(b)))
    np.testing.assert_allclose(_np(f(_t(a), _t(b))), a @ b + 1, rtol=1e-5)


def test_batchnorm_buffer_updates():
    paddle.seed(6)
    jm = jnn.Sequential(jnn.Linear(4, 4), jnn.BatchNorm1D(4))
    tm = _carry(jm, pt.nn.Sequential(pt.nn.Linear(4, 4, device="cpu"),
                                     pt.nn.BatchNorm1D(4)))
    jax_to_static(jm)
    to_static(tm)
    before = tm[1]._mean.clone()
    for i in range(2):
        x = _x(7 + i, 16, 4) + 3
        _close(tm(_t(x)), jm(_j(x)))
    assert not torch.allclose(before, tm[1]._mean), "BN mean must update"
    _close(tm[1]._mean, jm[1]._mean)
    _close(tm[1]._variance, jm[1]._variance)


def test_training_flag_makes_a_second_entry():
    paddle.seed(8)
    jm = jnn.Sequential(jnn.Linear(4, 4), jnn.Dropout(0.5))
    tm = _carry(jm, pt.nn.Sequential(pt.nn.Linear(4, 4, device="cpu"),
                                     pt.nn.Dropout(0.5)))
    with torch.no_grad():
        tm[0].bias.fill_(1.0)   # every output positive before dropout
    jm[0].bias._data = jnp.ones(4, jnp.float32)
    jax_to_static(jm)
    to_static(tm)
    x = np.ones((8, 4), np.float32)
    for m, arg in ((jm, _j(x)), (tm, _t(x))):
        m.train()
        out_train = _np(m(arg))
        m.eval()
        out_eval = _np(m(arg))
        assert (out_train == 0).any()      # dropout in train
        assert not (out_eval == 0).any()   # none in eval
    assert len(tm.forward._cache) == len(jm.forward._cache) == 2
    _close(tm(_t(x)), jm(_j(x)))            # eval: no randomness


def test_output_structure_per_cache_entry():
    @to_static
    def f(a, return_aux=False):
        if return_aux:
            return a * 2, a + 1
        return a * 2

    x = torch.ones(3)
    assert not isinstance(f(x, return_aux=False), tuple)
    pair = f(x, return_aux=True)
    assert isinstance(pair, tuple) and len(pair) == 2
    again = f(x, return_aux=False)
    assert not isinstance(again, tuple)
    np.testing.assert_allclose(again.numpy(), [2, 2, 2])
    np.testing.assert_allclose(f(x, return_aux=True)[1].numpy(), [2, 2, 2])
    assert len(f._cache) == 2


def test_auto_cast_state_makes_a_second_entry():
    """The AMP settings are part of the key in both packages: a staged
    Linear called plainly and under ``auto_cast`` O1 bf16 keeps two
    entries, and the second computes in bf16 as the JAX one does."""
    paddle.seed(26)
    jl = jnn.Linear(8, 2)
    tl = _carry(jl, pt.nn.Linear(8, 2, device="cpu"))
    f = to_static(lambda x: tl(x))
    g = jax_to_static(lambda x: jl(x))
    a = _x(27, 4, 8)
    plain = f(_t(a))
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        cast = f(_t(a))
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jcast = g(_j(a))
    g(_j(a))
    assert plain.dtype == torch.float32 and cast.dtype == torch.bfloat16
    assert len(f._cache) == len(g._cache) == 2
    _close(cast, jcast, rtol=2e-2, atol=2e-2)


def test_forward_host_sync_breaks_in_both_packages():
    """A forward that reads ``float()`` of a tensor cannot be staged in
    either package: one warning each, eager results, and the key stays
    eager (no second warning)."""
    def body(pkg):
        def f(a):
            scale = float(pkg.sum(a))
            return a * scale
        return f

    f = to_static(body(torch))
    g = jax_to_static(body(paddle))
    x = _x(25, 3, 4)
    outs, tw = _caught(lambda: [f(_t(x)) for _ in range(2)])
    jouts, jw = _caught(lambda: [g(_j(x)) for _ in range(2)])
    assert len(tw) == len(jw) == 1
    for o, jo in zip(outs, jouts):
        _close(o, jo)
        np.testing.assert_allclose(_np(o), x * x.sum(), rtol=1e-5)
    assert f.stats()["eager_calls"] == 2 and len(f._broken_keys) == 1


# ------------------------------------------------------ whole-step staging
def _mlp_runs(staged, steps=8):
    """Adam on the Tanh MLP, in both packages, ``steps`` steps on one
    batch -> (port losses, JAX losses, port model, JAX model, port step)."""
    jm, tm = _mlp_pair(9, act="tanh")
    jopt = paddle.optimizer.Adam(learning_rate=0.01, epsilon=EPS,
                                 parameters=jm.parameters())
    topt = pt.Adam(learning_rate=0.01, epsilon=EPS,
                   parameters=tm.parameters())
    X, Y = _x(10, 32, 6), _x(11, 32, 3)

    def jstep(xb, yb):
        loss = JF.mse_loss(jm(xb), yb)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    def tstep(xb, yb):
        loss = _mse(tm(xb), yb)
        loss.backward()
        topt.step()
        topt.clear_grad()
        return loss

    if staged:
        jstep = jax_to_static(jstep, capture=(jm, jopt))
        tstep = to_static(tstep, capture=(tm, topt))
    jl = [float(_np(jstep(_j(X), _j(Y)))) for _ in range(steps)]
    tl = [float(tstep(_t(X), _t(Y))) for _ in range(steps)]
    return tl, jl, tm, jm, tstep, topt


def test_whole_step_matches_eager_and_jax():
    tl, jl, tm, jm, step, topt = _mlp_runs(True)
    el, _, em, _, _, eopt = _mlp_runs(False)
    assert tl == el                              # bit-equal on the CPU
    for a, b in zip(tm.parameters(), em.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    _assert_params(tm, jm)
    assert all(p.grad is None for p in tm.parameters())
    assert topt._global_step == eopt._global_step == 8
    st = step.stats()
    assert st["staged"] == 1 and st["entries"] == 1
    assert st["graph_breaks"] == st["eager_calls"] == 0
    assert step._fast_step                        # steady calls memoized


def test_whole_step_sees_the_lr_scheduler():
    """``test_whole_step_with_lr_scheduler``: the decayed lr reaches the
    staged step, and the weights equal JAX's."""
    paddle.seed(12)
    jm = jnn.Linear(4, 1)
    tm = _carry(jm, pt.nn.Linear(4, 1, device="cpu"))
    jsched = paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.1)
    tsched = pt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.1)
    jopt = paddle.optimizer.SGD(learning_rate=jsched,
                                parameters=jm.parameters())
    topt = pt.SGD(learning_rate=tsched, parameters=tm.parameters())

    def make(m, opt, mse):
        def train_step(xb, yb):
            loss = mse(m(xb), yb)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return train_step

    jstep = jax_to_static(make(jm, jopt, JF.mse_loss), capture=(jm, jopt))
    tstep = to_static(make(tm, topt, _mse), capture=(tm, topt))
    x, y = np.ones((4, 4), np.float32), np.zeros((4, 1), np.float32)
    w0 = tm.weight.detach().clone()
    jstep(_j(x), _j(y))
    tstep(_t(x), _t(y))
    w1 = tm.weight.detach().clone()
    for s in (jsched, tsched):
        s.step()
        s.step()                 # lr 0.1 -> 0.01
    jstep(_j(x), _j(y))
    tstep(_t(x), _t(y))
    d1 = float((w1 - w0).abs().mean())
    d2 = float((tm.weight.detach() - w1).abs().mean())
    assert d2 < d1 * 0.5, "the staged step must see the decayed lr"
    _assert_params(tm, jm)


def _break_runs(staged, full_graph=False):
    """Two SGD steps whose step reads ``float(loss)`` (a host sync)."""
    jm, tm = _mlp_pair(13)
    jopt = paddle.optimizer.SGD(0.1, parameters=jm.parameters())
    topt = pt.SGD(0.1, parameters=tm.parameters())
    seen = {"jax": [], "port": []}

    def make(m, opt, mse, tag, conv):
        def train_step(xb, yb):
            loss = mse(m(xb), yb)
            loss.backward()
            opt.step()
            opt.clear_grad()
            seen[tag].append(float(conv(loss)))
            return loss
        return train_step

    jstep = make(jm, jopt, JF.mse_loss, "jax", lambda t: t._data)
    tstep = make(tm, topt, _mse, "port", lambda t: t)
    if staged:
        jstep = jax_to_static(jstep, capture=(jm, jopt),
                              full_graph=full_graph)
        tstep = to_static(tstep, capture=(tm, topt), full_graph=full_graph)
    x, y = _x(14, 4, 6), _x(15, 4, 3)
    return jm, tm, jstep, tstep, topt, seen, x, y


def test_host_sync_breaks_once_and_runs_eagerly():
    jm, tm, jstep, tstep, topt, seen, x, y = _break_runs(True)
    _, jw = _caught(lambda: [jstep(_j(x), _j(y)) for _ in range(2)])
    _, tw = _caught(lambda: [tstep(_t(x), _t(y)) for _ in range(2)])
    assert len(jw) == len(tw) == 1          # one warning each, no restage
    assert tw[0].startswith("to_static: falling back to eager for "
                            "train_step — GraphBreak")
    assert tw[0].endswith("(graph-break fallback; pass full_graph=True to "
                          "make this an error)")
    assert len(tstep._broken_keys) == len(jstep._broken_keys) == 1
    st = tstep.stats()
    assert st["graph_breaks"] == 1 and st["eager_calls"] == 2
    assert st["staged"] == 0
    # the broken staging call was undone: two real steps, as eagerly
    _, em, _, estep, eopt, eseen, _, _ = _break_runs(False)
    for _ in range(2):
        estep(_t(x), _t(y))
    assert seen["port"] == eseen["port"]
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(tm.parameters(), em.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _assert_params(tm, jm)
    assert topt._global_step == eopt._global_step == 2


def test_full_graph_raises_in_both_packages():
    jm, tm, jstep, tstep, topt, _, x, y = _break_runs(True, full_graph=True)
    w = tm[0].weight.detach().clone()
    with pytest.raises(Exception):
        jstep(_j(x), _j(y))
    with pytest.raises(GraphBreak):
        tstep(_t(x), _t(y))
    # the staging call's work is undone
    torch.testing.assert_close(tm[0].weight.detach(), w, rtol=0, atol=0)
    assert all(p.grad is None for p in tm.parameters())
    assert topt._global_step == 0


def test_grad_scaler_step_falls_back_in_both_packages():
    """``GradScaler.unscale_`` reads its inf flag on the host, so the
    staged step breaks there and runs eagerly in both packages, with the
    eager step's results."""
    def runs(staged):
        jm, tm = _mlp_pair(16)
        jopt = paddle.optimizer.SGD(0.05, parameters=jm.parameters())
        topt = pt.SGD(0.05, parameters=tm.parameters())
        jsc = paddle.amp.GradScaler(init_loss_scaling=1024.0)
        tsc = pt.amp.GradScaler(init_loss_scaling=1024.0)

        def make(m, opt, sc, mse):
            def train_step(xb, yb):
                loss = mse(m(xb), yb)
                sc.scale(loss).backward()
                sc.step(opt)
                sc.update()
                opt.clear_grad()
                return loss
            return train_step

        jstep = make(jm, jopt, jsc, JF.mse_loss)
        tstep = make(tm, topt, tsc, _mse)
        if staged:
            jstep = jax_to_static(jstep, capture=(jm, jopt))
            tstep = to_static(tstep, capture=(tm, topt))
        x, y = _x(17, 4, 6), _x(18, 4, 3)
        jl, jw = _caught(lambda: [float(_np(jstep(_j(x), _j(y))))
                                  for _ in range(3)])
        tl, tw = _caught(lambda: [float(tstep(_t(x), _t(y)))
                                  for _ in range(3)])
        return jm, tm, jl, tl, jw, tw

    jm, tm, jl, tl, jw, tw = runs(True)
    _, em, _, el, _, ew = runs(False)
    assert len(jw) == len(tw) == 1 and not ew
    assert tl == el
    for a, b in zip(tm.parameters(), em.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    _assert_params(tm, jm)


class _Scaled(torch.nn.Module):
    """A Linear whose output a parameter may scale, once one is added."""

    def __init__(self):
        super().__init__()
        self.lin = pt.nn.Linear(3, 2, device="cpu")

    def forward(self, x):
        y = self.lin(x)
        scale = getattr(self, "scale", None)
        return y * scale if scale is not None else y


def test_invalidate_after_a_new_parameter():
    """A parameter registered after the first staged call is found (the
    registration hooks bump the structural version), gets its gradient
    and its update; :meth:`invalidate` re-walks on demand too."""
    m = _Scaled()
    with torch.no_grad():
        m.lin.weight.copy_(torch.from_numpy(_x(19, 3, 2)))
        m.lin.bias.zero_()
    opt = pt.SGD(0.1, parameters=m.parameters())

    def train_step(xb):
        loss = (m(xb) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = to_static(train_step, capture=(m, opt))
    x = _t(_x(20, 5, 3))
    step(x)
    assert len(step._state_cached()[0]) == 2
    m.scale = torch.nn.Parameter(torch.full((2,), 2.0))
    opt._parameter_list.append(m.scale)
    opt._param_groups[0]["params"].append(m.scale)
    step(x)
    assert len(step._state_cached()[0]) == 3
    assert not torch.equal(m.scale.detach(), torch.full((2,), 2.0))
    assert step.stats()["entries"] == 2       # a new key, staged anew
    step.invalidate()
    assert step._state_cache is None and not step._fast_step
    step(x)
    assert step.stats()["entries"] == 2


# ------------------------------------------------------------- the models
def test_gpt_tiny_o2_step_matches_jax():
    """``gpt_tiny`` O2: ``decorate`` with f32 masters, ``AdamW(
    multi_precision)``, ``ClipGradByGlobalNorm`` and ``LinearWarmup(
    CosineAnnealingDecay)`` stepped outside the staged step, 4 steps in
    both packages; the port's staged run bit-equal to its eager run."""
    lr, steps, B, S = 1e-3, 4, 2, 24

    def port_run(staged, arrays, cfg, batches):
        tm = pt.params_from_paddle_tpu(arrays, cfg, device="cpu").train()
        tl = pt.optimizer.lr
        sched = tl.LinearWarmup(tl.CosineAnnealingDecay(lr, T_max=4), 2,
                                0.0, lr)
        opt = pt.AdamW(learning_rate=sched, epsilon=EPS,
                       parameters=tm.parameters(), weight_decay=0.1,
                       multi_precision=True,
                       grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        tm, opt = pt.amp.decorate(tm, opt, level="O2", dtype="bfloat16")
        crit = pt.GPTPretrainingCriterion(cfg)

        def train_step(ids, labels):
            with pt.auto_cast(level="O2", dtype="bfloat16"):
                loss = crit(tm(ids), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = to_static(train_step, capture=(tm, opt)) if staged \
            else train_step
        losses = []
        for ids, labels in batches:
            losses.append(float(step(_t(ids), _t(labels))))
            sched.step()
        return tm, opt, losses

    paddle.seed(21)
    jm = JaxGPT(jax_gpt_tiny())
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    cfg = pt.gpt_tiny()
    rng = np.random.RandomState(22)
    batches = [(rng.randint(0, cfg.vocab_size, (B, S)),
                rng.randint(0, cfg.vocab_size, (B, S)))
               for _ in range(steps)]
    jm.train()
    jl_ = paddle.optimizer.lr
    jsched = jl_.LinearWarmup(jl_.CosineAnnealingDecay(lr, T_max=4), 2, 0.0,
                              lr)
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, epsilon=EPS, parameters=jm.parameters(),
        weight_decay=0.1, multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jm, jopt = paddle.amp.decorate(models=jm, optimizers=jopt, level="O2",
                                   dtype="bfloat16")
    crit = JaxCriterion()

    def jstep(ids, labels):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(jm(ids), labels)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    jstep = jax_to_static(jstep, capture=(jm, jopt))
    jl = []
    for ids, labels in batches:
        jl.append(float(_np(jstep(_j(ids), _j(labels)))))
        jsched.step()
    tm, topt, tl = port_run(True, arrays, cfg, batches)
    em, eopt, el = port_run(False, arrays, cfg, batches)
    assert tl == el
    for a, b in zip(tm.parameters(), em.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    jnames = {id(p): n for n, p in jm.named_parameters()}
    jmw = {jnames[pid]: np.asarray(w) for pid, w in
           jopt._master_weights.items()}
    for p, w in topt._master_weights.items():
        np.testing.assert_allclose(w.numpy(), jmw[p.param_name], rtol=0,
                                   atol=2 * steps * lr, err_msg=p.param_name)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())


def test_lenet_adam_step_matches_jax():
    """``bench.py:379-397``'s LeNet step at B 4, Adam(1e-3), 3 staged steps
    in both packages."""
    paddle.seed(23)
    jm = JaxLeNet()
    tm = _carry(jm, pt.LeNet(device="cpu", seed=None))
    jopt = paddle.optimizer.Adam(learning_rate=1e-3, epsilon=EPS,
                                 parameters=jm.parameters())
    topt = pt.Adam(learning_rate=1e-3, epsilon=EPS,
                   parameters=tm.parameters())

    def make(m, opt, ce):
        def train_step(xb, yb):
            loss = ce(m(xb), yb)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return train_step

    jstep = jax_to_static(make(jm, jopt, JF.cross_entropy),
                          capture=(jm, jopt))
    tstep = to_static(make(tm, topt, F.cross_entropy), capture=(tm, topt))
    rng = np.random.RandomState(24)
    for _ in range(3):
        x = rng.randn(4, 1, 28, 28).astype(np.float32)
        y = rng.randint(0, 10, 4)
        _close(tstep(_t(x), _t(y)), jstep(_j(x), _j(y)))
    _assert_params(tm, jm)


# --------------------------------------------------------------- the port
def test_api_surface():
    spec = InputSpec([4, 6], "float32", name="x")
    assert spec.dtype == torch.float32 and spec.shape == [4, 6]
    assert pt.jit.not_to_static(test_api_surface)._not_to_static
    assert pt.jit.ignore_module([torch]) is None
    st = to_static(lambda a: a + 1, input_spec=[spec])
    assert isinstance(st, pt.jit.StaticFunction)
    with pytest.raises(TypeError, match="neither a Layer"):
        to_static(lambda: None, capture=(object(),))()


def test_nested_static_functions_run_inline():
    """A StaticFunction called while another stages runs its function
    inline (as a nested ``jax.jit`` inlines), keeping no entry of its
    own."""
    inner = to_static(lambda a: a * 3)

    @to_static
    def outer(a):
        return inner(a) + 1

    np.testing.assert_allclose(outer(torch.ones(2)).numpy(), [4, 4])
    assert len(inner._cache) == 0 and len(outer._cache) == 1


def test_optimizer_staging_hooks_advance_once_a_replay():
    """What a replay asks of an optimizer, on the host: SGD's staged lr is
    a 0-d tensor that ``_replay_step`` rewrites from ``get_lr()``, and the
    step counter advances as the staged run's ``step`` calls did;
    ``materialize`` / ``_state_slots`` list Adam's and Momentum's state."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = pt.optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.1)
    opt = pt.SGD(learning_rate=sched, parameters=[p])
    store = {"calls": 0, "steps": 0}
    opt._staged = store
    p.grad = torch.ones(3)
    opt.step()
    opt._staged = None
    torch.testing.assert_close(p.detach(), torch.full((3,), 0.5))
    (group, scale, buf), = store["lr"].values()
    assert float(buf) == 0.5 and store["steps"] == 1 and scale == 1.0
    sched.step()
    opt._replay_step(store)
    assert float(buf) == pytest.approx(0.05) and opt._global_step == 2
    for cls, names in ((pt.Adam, {"moment1", "moment2", "beta_pow"}),
                       (pt.Momentum, {"velocity"})):
        q = torch.nn.Parameter(torch.ones(2, 2))
        o = cls(parameters=[q])
        assert not o._state_slots()
        o.materialize()
        assert {n for n, per in o._accumulators.items() if q in per} == \
            names
        assert len(o._state_slots()) == len(names)


def test_clip_grad_norm_without_gradients_is_on_the_parameters_device():
    p = torch.nn.Parameter(torch.ones(3, device="meta"))
    assert pt.nn.clip_grad_norm_([p], 1.0).device.type == "meta"
    assert pt.nn.clip_grad_norm_([], 1.0).device.type == "cpu"


class _FakeCuda:
    """Stands in for a CUDA query tensor: ``_flash_eligible`` reads only
    its device, rank, head dim and dtype."""

    def __init__(self, dtype, d=64):
        self.device = torch.device("cuda")
        self.dtype = dtype
        self.shape = (2, 8, 4, d)

    def dim(self):
        return 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_takes_float16_as_bfloat16(dtype):
    """The f16 repair: ``_flash_eligible`` admits float16 (the sm90
    kernels' f16 instantiation) as it admits f32 and bf16."""
    from paddle_tpu_torch.nn.functional.common import _flash_eligible
    assert _flash_eligible(_FakeCuda(dtype), None, 0.0, False)
    assert not _flash_eligible(_FakeCuda(dtype, d=24), None, 0.0, False)
    assert not _flash_eligible(_FakeCuda(torch.float64), None, 0.0, False)
