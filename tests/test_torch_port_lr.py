"""The port's LR schedulers vs the JAX package's (``paddle_tpu/optimizer/
lr.py``): host code copied in semantics, so every rate over 30 steps must
be equal to the JAX one within float rounding (``rtol 1e-12``), and so
must the rates after a ``state_dict`` round trip — through a fresh port
scheduler and through a fresh JAX one, since the two formats are the same
dict of scalars. ``LinearWarmup`` holding a ``CosineAnnealingDecay`` is
the case a pretraining run uses; its ``state_dict`` keeps only scalars,
as the JAX one does, and the nested scheduler is re-derived from
``last_epoch``."""
import pytest

import paddle_tpu as paddle

import paddle_tpu_torch as pt

STEPS, MORE = 30, 10

# name -> (args, kwargs) for both packages' constructors; "lr" marks where
# each package's own nested scheduler goes
CASES = {
    "NoamDecay": ((64, 10), {"learning_rate": 2.0}),
    "PiecewiseDecay": (([5, 12, 20], [0.1, 0.05, 0.01, 0.001]), {}),
    "NaturalExpDecay": ((0.5, 0.1), {}),
    "InverseTimeDecay": ((0.5, 0.1), {}),
    "PolynomialDecay": ((0.5, 20), {"end_lr": 0.01, "power": 2.0}),
    "PolynomialDecay_cycle": ((0.5, 7), {"end_lr": 0.01, "cycle": True}),
    "LinearWarmup": ((0.5, 5, 0.0, 0.5), {}),
    "LinearWarmup_cosine": (("lr", 6, 0.0, 1e-4), {}),
    "ExponentialDecay": ((0.5, 0.9), {}),
    "MultiStepDecay": ((0.5, [4, 9, 17]), {"gamma": 0.5}),
    "StepDecay": ((0.5, 4), {"gamma": 0.7}),
    "LambdaDecay": ((0.5, lambda e: 0.95 ** e), {}),
    "ReduceOnPlateau": ((0.5,), {"patience": 2, "factor": 0.5,
                                 "cooldown": 1}),
    "CosineAnnealingDecay": ((0.5, 12), {"eta_min": 0.01}),
    "MultiplicativeDecay": ((0.5, lambda e: 0.9), {}),
    "OneCycleLR": ((0.5, 25), {}),
    "CyclicLR": ((0.01, 0.1), {"step_size_up": 4, "step_size_down": 6,
                               "mode": "triangular2"}),
    "LinearLR": ((0.5, 20), {"start_factor": 0.2}),
    "CosineAnnealingWarmRestarts": ((0.5, 5), {"T_mult": 2,
                                               "eta_min": 0.01}),
}


def _make(mod, name):
    args, kw = CASES[name]
    cls = getattr(mod, name.split("_")[0])
    if "lr" in args:
        inner = mod.CosineAnnealingDecay(1e-4, T_max=100)
        args = tuple(inner if a == "lr" else a for a in args)
    return cls(*args, **kw)


def _metric(step):
    # a loss that falls, then stalls (ReduceOnPlateau's input)
    return 1.0 / (1 + step) if step < 8 else 0.12 + 0.001 * (step % 3)


def _step(s, i):
    if isinstance(s, (pt.optimizer.lr.ReduceOnPlateau,
                      paddle.optimizer.lr.ReduceOnPlateau)):
        s.step(_metric(i))
    else:
        s.step()


def _run(s, start, n):
    out = []
    for i in range(start, start + n):
        out.append((s(), s.get_lr(), s.last_epoch))
        _step(s, i)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_matches_jax_with_state_dict_round_trip(name):
    jax_s = _make(paddle.optimizer.lr, name)
    port_s = _make(pt.optimizer.lr, name)
    want, got = _run(jax_s, 0, STEPS), _run(port_s, 0, STEPS)
    assert got == pytest.approx(want, rel=1e-12)
    state = port_s.state_dict()
    assert state == pytest.approx(jax_s.state_dict(), rel=1e-12)
    assert all(isinstance(v, (int, float, bool, str, list, tuple))
               for v in state.values())
    # resume: a fresh port scheduler and a fresh JAX one from the port's
    # state, against the original JAX scheduler going on
    fresh_port = _make(pt.optimizer.lr, name)
    fresh_port.set_state_dict(state)
    fresh_jax = _make(paddle.optimizer.lr, name)
    fresh_jax.set_state_dict(dict(state))
    want = _run(jax_s, STEPS, MORE)
    assert _run(fresh_port, STEPS, MORE) == pytest.approx(want, rel=1e-12)
    assert _run(fresh_jax, STEPS, MORE) == pytest.approx(want, rel=1e-12)


def test_base_scheduler_is_abstract_in_both():
    for mod in (paddle.optimizer.lr, pt.optimizer.lr):
        with pytest.raises(NotImplementedError):
            mod.LRScheduler(0.1)
    assert sorted(pt.optimizer.lr.__all__) == sorted(
        paddle.optimizer.lr.__all__)
