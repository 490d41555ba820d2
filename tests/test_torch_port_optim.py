"""The port's Adagrad, RMSProp, Adadelta, Adamax, Lamb, Rprop and LBFGS
against the JAX package's (``paddle_tpu/optimizer/optimizers.py:201-583``).

The elementwise six run five steps on the same parameters (a two-layer
MLP, weights carried by ``params_from_paddle_tpu``) with the same numpy
gradients a step, set directly on both sides, under an
``ExponentialDecay`` schedule stepped after each step (Rprop takes a
float) and with the ``L2Decay`` / ``L1Decay`` or decay options each class
takes: in f32, and in master mode (``decorate`` O2 bf16 with
``multi_precision``: bf16 parameters, f32 masters and accumulators).
Their ``state_dict`` carries into the other package both ways
(``opt_state_from_paddle_tpu`` / ``opt_state_to_numpy``) and the next
step agrees; ``jit.to_static`` of a whole step on the CPU runs with 0
graph breaks and equals eager bit for bit. LBFGS runs five closure steps
on a least-squares MLP with both ``line_search_fn`` values, and its step
is a graph break under ``to_static``, as JAX's host-driven step is.

Tolerances: ``rtol 1e-4 / atol 1e-5`` on f32 weights and masters; the
bf16 parameters of master mode within one bf16 rounding of each other
(``rtol 1e-2``), and each port parameter exactly its master rounded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import to_static

RTOL, ATOL = 1e-4, 1e-5


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data, np.float32)
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _pair(seed=3):
    """The same two-layer MLP (6 -> 5 -> 3) in both packages."""
    paddle.seed(seed)
    jm = paddle.nn.Sequential(paddle.nn.Linear(6, 5), paddle.nn.ReLU(),
                              paddle.nn.Linear(5, 3))
    tm = pt.nn.Sequential(
        pt.nn.Linear(6, 5, device="cpu", dtype=torch.float32),
        pt.nn.ReLU(), pt.nn.Linear(5, 3, device="cpu", dtype=torch.float32))
    arrays = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    pt.params_from_paddle_tpu(arrays, tm)
    for name, p in tm.named_parameters():
        p.param_name = name
    return jm, tm


def _names(jm):
    return {p.name: n for n, p in jm.named_parameters()}


def _sched(pkg, lr):
    return pkg.optimizer.lr.ExponentialDecay(lr, gamma=0.8)


def _exclude_bias(p):
    return len(p.shape) == 1


# name -> (class name, positional learning rate, kwargs, scheduled,
#          decay kind); decay "l2" / "l1" is passed as weight_decay
_CASES = {
    "adagrad_l2": ("Adagrad", 0.1, dict(epsilon=1e-6), True, "l2"),
    "adagrad_init_l1": ("Adagrad", 0.1, dict(initial_accumulator_value=0.1),
                        True, "l1"),
    "rmsprop_momentum_l2": ("RMSProp", 0.01, dict(rho=0.9, momentum=0.9),
                            True, "l2"),
    "rmsprop_centered_l1": ("RMSProp", 0.01, dict(centered=True,
                                                  momentum=0.5),
                            True, "l1"),
    "adadelta_l2": ("Adadelta", 1.0, dict(rho=0.9, epsilon=1e-5), True,
                    "l2"),
    "adamax_l1": ("Adamax", 0.02, dict(beta1=0.8, beta2=0.99), True, "l1"),
    "lamb": ("Lamb", 0.02, dict(lamb_weight_decay=0.01), True, None),
    "lamb_exclude": ("Lamb", 0.02, dict(
        lamb_weight_decay=0.1, exclude_from_weight_decay_fn=_exclude_bias),
        True, None),
    "rprop": ("Rprop", 0.01, dict(learning_rate_range=(1e-4, 0.05),
                                  etas=(0.5, 1.2)), False, None),
}


def _make(pkg, case, params):
    cls, lr, kw, scheduled, decay = _CASES[case]
    kw = dict(kw)
    if decay is not None:
        kw["weight_decay"] = (pkg.regularizer.L2Decay(1e-2) if decay == "l2"
                              else pkg.regularizer.L1Decay(1e-3))
    sched = _sched(pkg, lr) if scheduled else None
    opt = getattr(pkg.optimizer, cls)(sched if scheduled else lr,
                                      parameters=params, **kw)
    return opt, sched


def _grads(rng, tm):
    return {n: (0.5 * rng.randn(*p.shape)).astype(np.float32)
            for n, p in tm.named_parameters()}


def _set_grads(jm, tm, grads, master):
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        g = grads[name]
        p.grad = torch.from_numpy(g.astype(np.float32)).to(p.dtype)
        jp[name]._grad = jnp.asarray(g.astype(np.float32),
                                     jnp.bfloat16 if master
                                     else jnp.float32)


def _run(case, master, steps=5, seed=7):
    """``steps`` steps in both packages -> (jm, tm, jopt, topt, jsched,
    tsched)."""
    jm, tm = _pair()
    jopt, jsched = _make(paddle, case, jm.parameters())
    topt, tsched = _make(pt, case, tm.parameters())
    if master:
        jm, jopt = paddle.amp.decorate(models=jm, optimizers=jopt,
                                       level="O2", dtype="bfloat16")
        tm, topt = pt.amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        _set_grads(jm, tm, _grads(rng, tm), master)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        if jsched is not None:
            jsched.step()
            tsched.step()
    return jm, tm, jopt, topt, jsched, tsched


def _check_weights(jm, jopt, tm, topt, master):
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        if master:
            want = np.asarray(jopt._master_weights[id(jp[name])])
            got = topt._master_weights[p]
            assert got.dtype == torch.float32
            assert torch.equal(p.detach(), got.to(torch.bfloat16)), name
            np.testing.assert_allclose(_np(p), _np(jp[name]), rtol=1e-2,
                                       atol=1e-2, err_msg=name)
        else:
            want, got = np.asarray(jp[name]._data), p
        np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _jax_state(jopt, jm):
    state = {k: ({n: np.asarray(t._data) for n, t in v.items()}
                 if k == "master_weights" else
                 np.asarray(v._data) if isinstance(v, Tensor) else v)
             for k, v in jopt.state_dict().items()}
    return pt.opt_state_from_paddle_tpu(state, _names(jm))


@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_five_steps_match_jax(case, master):
    """Five steps with a schedule and the class's decay: weights (masters
    in master mode) and every accumulator, by the JAX ``state_dict``'s
    keys, equal within f32 tolerance."""
    jm, tm, jopt, topt, _, _ = _run(case, master)
    _check_weights(jm, jopt, tm, topt, master)
    jstate, tstate = _jax_state(jopt, jm), topt.state_dict()
    assert set(jstate) == set(tstate)
    for key, value in jstate.items():
        if key == "master_weights":
            continue
        if key not in ("global_step", "LR_Scheduler"):
            acc = tstate[key]
            assert torch.is_tensor(acc) or key.endswith("_beta_pow")
            if torch.is_tensor(acc) and acc.dim():
                assert acc.dtype == torch.float32   # f32 and master mode
        np.testing.assert_allclose(_np(tstate[key]) if key != "LR_Scheduler"
                                   else 0, _np(value) if key !=
                                   "LR_Scheduler" else 0, rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_every_jax_accumulator_name_is_kept():
    """The accumulator names the JAX optimizers create are the port's."""
    want = {"Adagrad": {"moment"}, "RMSProp": {"mean_square", "momentum",
                                                "mean_grad"},
            "Adadelta": {"avg_squared_grad", "avg_squared_update"},
            "Adamax": {"moment", "inf_norm", "beta1_pow"},
            "Lamb": {"moment1", "moment2", "beta_pow"},
            "Rprop": {"prev", "learning_rates"}}
    for cls, names in want.items():
        case = next(c for c, v in sorted(_CASES.items()) if v[0] == cls
                    and (cls != "RMSProp" or "centered" in c))
        jm, tm, jopt, topt, _, _ = _run(case, False, steps=1)
        assert set(jopt._accumulators) == names == set(topt._accumulators)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_state_dict_carries_both_ways_in_the_jax_format(case):
    """After three steps: the JAX state loaded into a fresh port optimizer
    (and the port's into a fresh JAX one) takes a fourth step equal to the
    continuing optimizers' within f32 tolerance."""
    jm, tm, jopt, topt, jsched, tsched = _run(case, False, steps=3)
    # JAX -> port
    topt2, tsched2 = _make(pt, case, tm.parameters())
    topt2.set_state_dict(_jax_state(jopt, jm))
    # port -> JAX
    jopt2, _ = _make(paddle, case, jm.parameters())
    back = pt.opt_state_to_numpy(topt.state_dict(), _names(jm))
    jopt2.set_state_dict(back)
    assert topt2._global_step == jopt2._global_step == 3
    if tsched2 is not None:
        assert tsched2.last_epoch == tsched.last_epoch == 3
    grads = _grads(np.random.RandomState(99), tm)
    snap_t = {n: p.detach().clone() for n, p in tm.named_parameters()}
    snap_j = {n: p._data for n, p in jm.named_parameters()}
    results = []
    for jo, to in ((jopt, topt2), (jopt2, topt)):
        for name, p in tm.named_parameters():
            with torch.no_grad():
                p.copy_(snap_t[name])
        for name, p in jm.named_parameters():
            p._data = snap_j[name]
        _set_grads(jm, tm, grads, False)
        jo.step()
        to.step()
        results.append(({n: np.asarray(p._data)
                          for n, p in jm.named_parameters()},
                         pt.params_to_numpy(tm)))
    for jw, tw in results:
        for name in tw:
            np.testing.assert_allclose(tw[name], jw[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def _staged_pair(case, steps=4, seed=21):
    """The same training (a two-layer MLP, an MSE loss on numpy batches)
    eager and through ``to_static(step, capture=(model, opt))`` -> (eager
    losses, staged losses, eager weights, staged weights, stats)."""
    out = []
    for staged in (False, True):
        _, tm = _pair()
        opt, sched = _make(pt, case, tm.parameters())

        def step(x, y, model=tm, opt=opt):
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = to_static(step, capture=(tm, opt), full_graph=True) \
            if staged else step
        rng = np.random.RandomState(seed)
        losses = []
        for _ in range(steps):
            x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
            y = torch.from_numpy(rng.randn(8, 3).astype(np.float32))
            losses.append(float(fn(x, y).detach()))
            if sched is not None:
                sched.step()
        out.append((losses, pt.params_to_numpy(tm),
                    fn.stats() if staged else None))
    (el, ew, _), (sl, sw, stats) = out
    return el, sl, ew, sw, stats


@pytest.mark.parametrize("case", sorted(_CASES))
def test_to_static_equals_eager_with_no_graph_break(case):
    """A whole step staged on the CPU (``full_graph=True``: a host sync
    would raise) equals the eager run bit for bit, with the schedule's lr
    reaching every staged call; ``stats()`` counts no break."""
    el, sl, ew, sw, stats = _staged_pair(case)
    assert stats["graph_breaks"] == 0 and stats["eager_calls"] == 0
    assert sl == el
    for name in ew:
        np.testing.assert_array_equal(sw[name], ew[name], err_msg=name)


def test_staged_lamb_and_adamax_keep_step_counts_on_the_device():
    """Lamb's ``beta_pow`` and Adamax's ``beta1_pow`` are 0-d f32 tensors
    (JAX keeps device arrays), advanced once a step by the step itself."""
    for cls, acc, after in (("Lamb", "beta_pow", 3.0),
                            ("Adamax", "beta1_pow", 0.9 ** 3)):
        _, tm = _pair()
        opt = getattr(pt.optimizer, cls)(0.01, parameters=tm.parameters())
        for _ in range(3):
            for p in tm.parameters():
                p.grad = torch.ones_like(p)
            opt.step()
        for p in tm.parameters():
            t = opt._accumulators[acc][p]
            assert torch.is_tensor(t) and t.dim() == 0
            assert t.dtype == torch.float32
            np.testing.assert_allclose(float(t), after, rtol=1e-6)


def test_rprop_keeps_a_bf16_parameter_in_its_type_without_masters():
    """The reference quirk: JAX's Rprop returns ``w - sign(g) lrs`` with
    f32 ``lrs``, so a bf16 parameter without masters becomes f32 there;
    the port updates it in place in bf16 (its value the f32 update
    rounded)."""
    _, tm = _pair()
    tm.to(torch.bfloat16)
    opt = pt.optimizer.Rprop(0.01, parameters=tm.parameters())
    before = [p.detach().float().clone() for p in tm.parameters()]
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for p, b in zip(tm.parameters(), before):
        assert p.dtype == torch.bfloat16
        assert opt._accumulators["learning_rates"][p].dtype == torch.float32
        np.testing.assert_allclose(_np(p), _np((b - 0.01).bfloat16()))


# ------------------------------------------------------------------ LBFGS
def _lbfgs_pair(line_search, steps=5, seed=31):
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 6).astype(np.float32)
    y = rng.randn(16, 3).astype(np.float32)
    jm, tm = _pair(seed=5)
    kw = dict(learning_rate=1.0, max_iter=4, history_size=5,
              line_search_fn=line_search)
    jopt = paddle.optimizer.LBFGS(parameters=jm.parameters(), **kw)
    topt = pt.optimizer.LBFGS(parameters=tm.parameters(), **kw)
    jx, jy = Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def jclosure():
        jopt.clear_grad()
        d = jm(jx) - jy
        loss = (d * d).mean()
        loss.backward()
        return loss

    def tclosure():
        topt.clear_grad()
        loss = ((tm(tx) - ty) ** 2).mean()
        loss.backward()
        return loss

    jl = [jopt.step(jclosure) for _ in range(steps)]
    tl = [topt.step(tclosure) for _ in range(steps)]
    return jm, tm, jopt, topt, jl, tl, tclosure


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_five_closure_steps_match_jax(line_search):
    """Five ``step(closure)`` calls of at most 4 iterations each: the
    losses each step returns, the closure evaluations and the weights."""
    jm, tm, jopt, topt, jl, tl, _ = _lbfgs_pair(line_search)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tl[-1] < tl[0]
    assert topt._state["n_evals"] == jopt._state["n_evals"]
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for name, a in pt.params_to_numpy(tm).items():
        np.testing.assert_allclose(a, want[name], rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    assert all(p.grad is None for p in tm.parameters())


def test_lbfgs_step_is_a_graph_break_under_to_static():
    """Under ``to_static`` the closure's ``float()`` breaks the staging:
    one break, then the key runs eagerly and still trains."""
    _, tm, _, topt, _, tl, tclosure = _lbfgs_pair(None, steps=1)
    fn = to_static(lambda: topt.step(tclosure), capture=(tm, topt))
    with pytest.warns(UserWarning):
        first = fn()
    second = fn()
    stats = fn.stats()
    assert stats["graph_breaks"] == 1 and stats["eager_calls"] == 2
    assert second <= first <= tl[0]
