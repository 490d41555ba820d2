"""The port's O2 training path vs the JAX package's, on the same weights.

``paddle_tpu``'s ``gpt_tiny`` (``dropout=0``; biases and norm parameters
perturbed so a mis-mapped weight cannot hide) carries its weights to
``paddle_tpu_torch`` through ``params_from_paddle_tpu``, and both train on
the same numpy batches through the pieces a pretraining run adds to the
step of ``tests/test_torch_port_train.py``: regularizers, the global-norm
clip, a warm-up and cosine schedule, ``amp.decorate`` O2 with f32 master
weights, ``GradScaler``, the optimizer's ``state_dict`` (carried across
the packages by ``convert.opt_state_from_paddle_tpu``) and per-block
``recompute``.

Tolerances:
* f32 runs: the slice-2 tolerance, ``rtol 1e-4 / atol 1e-5``, with Adam's
  ``epsilon`` 1e-6 for the reason that file gives;
* O2 runs: bf16 rounds at other places in the two frameworks (a bias is
  added before or after the product's rounding), so the losses agree to
  bf16 precision (``rtol 1e-2``, as ``test_auto_cast_loss_tracks_jax_in
  _bf16``) and the f32 masters within ``atol 2 * STEPS * LR``: the
  gradients differ at bf16 precision, and Adam's normalised step moves an
  element by at most about ``lr`` a step whatever its gradient;
* an optimizer step on the same gradients: f32 rounding, ``rtol 1e-6``;
  a bf16 parameter within one bf16 rounding of the JAX one.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp.auto_cast import amp_dtype_for as jax_amp_dtype_for
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.amp import amp_lists

amp_mod = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

RTOL, ATOL = 1e-4, 1e-5
LR, EPS, STEPS, B, S = 1e-3, 1e-6, 5, 2, 24


def _jax_model(seed, **kw):
    paddle.seed(seed)
    m = JaxGPT(jax_gpt_tiny(**kw))
    rng = np.random.RandomState(seed)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif ".ln_" in name or "ln_f" in name:
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    return m


def _both(seed, **kw):
    jm = _jax_model(seed, **kw)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    cfg = pt.gpt_tiny(**kw)
    return jm, pt.params_from_paddle_tpu(arrays, cfg, device="cpu"), cfg


def _batches(seed, vocab, n=STEPS):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=(B, S)),
             rng.randint(0, vocab, size=(B, S))) for _ in range(n)]


def _jax_step(jm, jopt, ids, labels, level=None):
    with paddle.amp.auto_cast(enable=level is not None, level=level or "O1",
                              dtype="bfloat16"):
        loss = JaxCriterion()(jm(Tensor(jnp.asarray(ids))),
                              Tensor(jnp.asarray(labels)))
    loss.backward()
    jopt.step()
    jopt.clear_grad()
    return float(np.asarray(loss._data, np.float32))


def _port_step(tm, topt, cfg, ids, labels, level=None):
    with pt.auto_cast(enable=level is not None, level=level or "O1",
                      dtype="bfloat16"):
        loss = pt.GPTPretrainingCriterion(cfg)(tm(torch.from_numpy(ids)),
                                               torch.from_numpy(labels))
    loss.backward()
    topt.step()
    topt.clear_grad()
    return loss.item()


def _schedules():
    jlr, tlr = paddle.optimizer.lr, pt.optimizer.lr
    return (jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=4), 2, 0.0,
                             LR),
            tlr.LinearWarmup(tlr.CosineAnnealingDecay(LR, T_max=4), 2, 0.0,
                             LR))


def _assert_params(tm, jm, rtol, atol):
    got = pt.params_to_numpy(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data, np.float32),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["adam_l2", "adam_l1", "adamw_l2"])
def test_f32_training_with_decay_clip_and_schedule_matches_jax(case):
    """5 f32 steps with a regularizer object, ``ClipGradByGlobalNorm`` (0.5,
    below the gradients' norm, so it scales) and ``LinearWarmup(
    CosineAnnealingDecay)``, stepped after every step."""
    jm, tm, cfg = _both(31)
    jm.train()
    tm.train()
    jsched, tsched = _schedules()
    decay = {"adam_l2": "L2Decay", "adam_l1": "L1Decay",
             "adamw_l2": "L2Decay"}[case]
    cls = "AdamW" if case.startswith("adamw") else "Adam"
    jopt = getattr(paddle.optimizer, cls)(
        learning_rate=jsched, epsilon=EPS, parameters=jm.parameters(),
        weight_decay=getattr(paddle.regularizer, decay)(0.05),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    topt = getattr(pt.optimizer, cls)(
        learning_rate=tsched, epsilon=EPS, parameters=tm.parameters(),
        weight_decay=getattr(pt.regularizer, decay)(0.05),
        grad_clip=pt.nn.ClipGradByGlobalNorm(0.5))
    for step, (ids, labels) in enumerate(_batches(32, cfg.vocab_size)):
        jl = _jax_step(jm, jopt, ids, labels)
        tl = _port_step(tm, topt, cfg, ids, labels)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")
        assert topt.get_lr() == jopt.get_lr()
        jsched.step()
        tsched.step()
    _assert_params(tm, jm, RTOL, ATOL)
    assert topt._global_step == jopt._global_step == STEPS


def _o2_pair(seed, **kw):
    jm, tm, cfg = _both(seed, **kw)
    jm.train()
    tm.train()
    jsched, tsched = _schedules()
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, epsilon=EPS, parameters=jm.parameters(),
        weight_decay=0.1, multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = pt.AdamW(learning_rate=tsched, epsilon=EPS,
                    parameters=tm.parameters(), weight_decay=0.1,
                    multi_precision=True,
                    grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    jm, jopt = paddle.amp.decorate(models=jm, optimizers=jopt, level="O2",
                                   dtype="bfloat16")
    tm, topt = pt.amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    return jm, tm, cfg, jopt, topt, jsched, tsched


def _assert_masters(topt, jopt, tm, jm, atol):
    jnames = {id(p): n for n, p in jm.named_parameters()}
    jmw = {jnames[pid]: np.asarray(w) for pid, w in
           jopt._master_weights.items()}
    tmw = {p.param_name: w.numpy() for p, w in topt._master_weights.items()}
    assert set(tmw) == set(jmw) == {n for n, _ in tm.named_parameters()}
    for name in jmw:
        np.testing.assert_allclose(tmw[name], jmw[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_o2_training_with_master_weights_tracks_jax():
    """``decorate`` O2 + ``AdamW(multi_precision=True)`` with clip and
    schedule, 5 steps: bf16 parameters and gradients, f32 masters and
    moments, in both packages."""
    jm, tm, cfg, jopt, topt, jsched, tsched = _o2_pair(33)
    for step, (ids, labels) in enumerate(_batches(34, cfg.vocab_size)):
        jl = _jax_step(jm, jopt, ids, labels, level="O2")
        tl = _port_step(tm, topt, cfg, ids, labels, level="O2")
        np.testing.assert_allclose(tl, jl, rtol=1e-2, err_msg=f"step {step}")
        jsched.step()
        tsched.step()
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(str(p._data.dtype) == "bfloat16" for p in jm.parameters())
    for p in tm.parameters():
        acc = topt._accumulators
        assert acc["moment1"][p].dtype == acc["moment2"][p].dtype \
            == torch.float32
        # the parameter is its master rounded to bf16
        assert torch.equal(p.detach(), topt._master_weights[p].bfloat16())
    _assert_masters(topt, jopt, tm, jm, atol=2 * STEPS * LR)


def test_o2_op_dtypes_follow_jax_amp_dtype_for(monkeypatch):
    """Every op name the port casts, under O1 and O2 and with custom lists,
    gets the dtype JAX's ``amp_dtype_for`` gives it; the tied head's logits
    are bf16 under O2 and f32 under O1 in both packages."""
    names = amp_lists.WHITE_LIST | amp_lists.BLACK_LIST | {
        "gelu", "lm_head_tied", "embedding", "add", "getitem", "cast"}
    for kw in ({"level": "O1"}, {"level": "O2"},
               {"level": "O2", "custom_black_list": ["gelu"]},
               {"level": "O1", "custom_white_list": ["lm_head_tied"]}):
        for name in names:
            with paddle.amp.auto_cast(dtype="bfloat16", **kw):
                want = jax_amp_dtype_for(name)
            with pt.auto_cast(dtype="bfloat16", **kw):
                got = amp_mod.amp_dtype_for(name)
            assert (None if want is None else str(jnp.dtype(want))) == (
                None if got is None else str(got).replace("torch.", "")), \
                (kw, name)
    jm, tm, cfg = _both(35)
    ids, _ = _batches(36, cfg.vocab_size)[0]
    tm.train()
    # the casts each op makes in a decorated O2 forward
    layer_mod = importlib.import_module("paddle_tpu_torch.nn.layer")
    func_mod = importlib.import_module("paddle_tpu_torch.nn.functional")
    gpt_mod = importlib.import_module("paddle_tpu_torch.models.gpt")
    seen = []

    def spy(op_name, *tensors):
        out = amp_mod.amp_cast(op_name, *tensors)
        seen.append((op_name, {t.dtype for t in out if t is not None}))
        return out

    for mod in (layer_mod, func_mod, gpt_mod):
        monkeypatch.setattr(mod, "amp_cast", spy)
    pt.amp.decorate(tm, level="O2")
    paddle.amp.decorate(models=jm, level="O2", dtype="bfloat16")
    for level, dtype in (("O1", torch.float32), ("O2", torch.bfloat16)):
        seen.clear()
        with pt.auto_cast(level=level, dtype="bfloat16"):
            logits = tm(torch.from_numpy(ids))
        with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
            jlogits = jm(Tensor(jnp.asarray(ids)))
        if level == "O2":
            assert logits.dtype == torch.bfloat16
            assert str(jlogits._data.dtype) == "bfloat16"
            L = cfg.num_layers
            want = {"embedding": torch.bfloat16, "add": torch.bfloat16,
                    "layer_norm": torch.float32, "linear": torch.bfloat16,
                    "gelu": torch.bfloat16,
                    "scaled_dot_product_attention": torch.bfloat16,
                    "lm_head_tied": torch.bfloat16}
            for op, dtypes in seen:
                assert dtypes == {want[op]}, (op, dtypes)
            counts = {op: sum(o == op for o, _ in seen) for op in want}
            assert counts == {"embedding": 2, "add": 2 * L + 1,
                              "layer_norm": 2 * L + 1, "linear": 4 * L,
                              "gelu": L, "scaled_dot_product_attention": L,
                              "lm_head_tied": 1}
    # O1 on f32 weights: the tied head stays an f32 product in both
    jm, tm, cfg = _both(35)
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        logits = tm(torch.from_numpy(ids))
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jlogits = jm(Tensor(jnp.asarray(ids)))
    assert logits.dtype == torch.float32
    assert str(jlogits._data.dtype) == "float32"


def test_master_mode_step_matches_jax_on_the_same_gradients():
    """One AdamW step of decorated bf16 parameters on the same bf16
    gradients: the master is made from the parameter's bf16 value, the
    gradient is read in f32, and the parameter is the new master rounded
    to bf16 — within f32 rounding of the JAX step."""
    jm, tm, cfg = _both(37)
    jopt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                  parameters=jm.parameters(),
                                  weight_decay=0.1, multi_precision=True)
    topt = pt.AdamW(learning_rate=LR, epsilon=EPS,
                    parameters=tm.parameters(), weight_decay=0.1,
                    multi_precision=True)
    paddle.amp.decorate(models=jm, optimizers=jopt, level="O2")
    pt.amp.decorate(tm, topt, level="O2")
    rng = np.random.RandomState(38)
    jparams = dict(jm.named_parameters())
    for step in range(2):
        for name, p in tm.named_parameters():
            g = torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                 * 0.01).bfloat16()
            p.grad = g
            jparams[name]._grad = jnp.asarray(g.float().numpy(),
                                              jnp.bfloat16)
        jopt.step()
        topt.step()
    _assert_masters(topt, jopt, tm, jm, atol=1e-6)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(
            p.detach().float().numpy(),
            np.asarray(jparams[name]._data, np.float32), rtol=8e-3,
            atol=1e-6, err_msg=name)


def test_o2_without_master_weights_keeps_bf16_moments():
    """``decorate(master_weight=False)``: no masters, and a bf16
    parameter's moments are bf16 (``optimizer.py:96-102``), updated in f32
    by the kernel's plain version and stored rounded."""
    _, tm, cfg = _both(39)
    topt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    pt.amp.decorate(tm, topt, level="O2", master_weight=False)
    assert not topt._multi_precision
    ids, labels = _batches(40, cfg.vocab_size)[0]
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    _port_step(tm, topt, cfg, ids, labels, level="O2")
    assert not topt._master_weights
    for name, p in tm.named_parameters():
        m, v = (topt._accumulators[a][p] for a in ("moment1", "moment2"))
        assert p.dtype == m.dtype == v.dtype == torch.bfloat16, name
        # the first step: m = (1 - b1) g and v = (1 - b2) g^2, rounded
        g = (m.float() / 0.1).bfloat16().float()
        torch.testing.assert_close(v.float(), (0.001 * g * g).bfloat16()
                                   .float(), rtol=2e-2, atol=1e-12)
    # weights of magnitude ~0.02 move by ~lr, several bf16 ulps
    wte = tm.gpt.wte.weight
    assert (wte.detach() != before["gpt.wte.weight"]).float().mean() > 0.9


def test_decorate_keeps_parameter_objects_and_names():
    """O2 casts in place: the ``Parameter`` objects (so an optimizer built
    before ``decorate`` keys its state by them) and their ``param_name``
    stay; O1 leaves the weights f32; float16 casts them as bf16 does, and
    a dtype that is neither is refused."""
    _, tm, cfg = _both(41)
    before = [(n, p) for n, p in tm.named_parameters()]
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    assert pt.amp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for _, p in before)
    out_m, out_opt = pt.amp.decorate(tm, opt, level="O2")
    assert out_m is tm and out_opt is opt and opt._multi_precision
    for (name, p), (name2, p2) in zip(before, tm.named_parameters()):
        assert p is p2 and name == name2 == p.param_name
        assert p.dtype == torch.bfloat16 and p.requires_grad
    assert opt._parameter_list[0] is before[0][1]
    ids, labels = _batches(42, cfg.vocab_size)[0]
    _port_step(tm, opt, cfg, ids, labels, level="O2")
    assert set(opt._master_weights) == {p for _, p in before}
    models, opts = pt.amp.decorate([tm], [opt], level="O2")
    assert models == [tm] and opts == [opt]
    with pytest.raises(NotImplementedError):
        pt.amp.decorate(tm, level="O2", dtype="float64")
    assert pt.amp.decorate(tm, level="O2", dtype="float16") is tm
    for (name, p), (name2, p2) in zip(before, tm.named_parameters()):
        assert p is p2 and p.dtype == torch.float16


def _name_map(jm):
    return {p.name: n for n, p in jm.named_parameters()}


def _jax_state_to_numpy(state):
    out = {}
    for k, v in state.items():
        if k == "master_weights":
            out[k] = {n: np.asarray(t._data) for n, t in v.items()}
        elif isinstance(v, Tensor):
            out[k] = np.asarray(v._data)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("level", [None, "O2"])
def test_resume_from_a_jax_state_dict_continues_as_jax(level):
    """Train 3 steps in JAX, carry its model and optimizer state (moments,
    step counts, masters, schedule, global step) into a fresh port model
    and optimizer by ``params_from_paddle_tpu`` and
    ``opt_state_from_paddle_tpu``, then continue 2 steps in both: f32 at
    the slice-2 tolerance, O2 at bf16 precision. The port's state then
    goes back through ``opt_state_to_numpy`` under the JAX names."""
    jm = _jax_model(43)
    jm.train()
    jsched, _ = _schedules()
    jopt = paddle.optimizer.AdamW(learning_rate=jsched, epsilon=EPS,
                                  parameters=jm.parameters(),
                                  weight_decay=0.1,
                                  multi_precision=level == "O2")
    if level:
        paddle.amp.decorate(models=jm, optimizers=jopt, level=level)
    batches = _batches(44, 256, n=5)
    for ids, labels in batches[:3]:
        _jax_step(jm, jopt, ids, labels, level=level)
        jsched.step()
    cfg = pt.gpt_tiny()
    arrays = {n: np.asarray(p._data, np.float32)
              for n, p in jm.named_parameters()}
    tm = pt.params_from_paddle_tpu(arrays, cfg, device="cpu").train()
    _, tsched = _schedules()
    topt = pt.AdamW(learning_rate=tsched, epsilon=EPS,
                    parameters=tm.parameters(), weight_decay=0.1)
    if level:
        pt.amp.decorate(tm, topt, level=level)
    state = pt.opt_state_from_paddle_tpu(
        _jax_state_to_numpy(jopt.state_dict()), _name_map(jm))
    topt.set_state_dict(state)
    assert tsched.last_epoch == jsched.last_epoch == 3
    assert topt._global_step == 3
    assert set(topt._accumulators["beta_pow"].values()) == {3.0}
    if level:
        _assert_masters(topt, jopt, tm, jm, atol=0)
    for step, (ids, labels) in enumerate(batches[3:]):
        jl = _jax_step(jm, jopt, ids, labels, level=level)
        tl = _port_step(tm, topt, cfg, ids, labels, level=level)
        np.testing.assert_allclose(tl, jl, rtol=1e-2 if level else RTOL,
                                   atol=0 if level else ATOL,
                                   err_msg=f"step {step}")
        jsched.step()
        tsched.step()
    if level:
        _assert_masters(topt, jopt, tm, jm, atol=2 * 2 * LR)
    else:
        _assert_params(tm, jm, RTOL, ATOL)
    back = pt.opt_state_to_numpy(topt.state_dict(), _name_map(jm))
    jstate = _jax_state_to_numpy(jopt.state_dict())
    assert set(back) == set(jstate)
    assert back["global_step"] == jstate["global_step"] == 5


def test_state_dict_round_trip_resumes_bit_for_bit():
    """Save model and optimizer (with its scheduler) after 2 O2 steps, run
    2 more, restore the saved state into a fresh model and optimizer and
    run the same 2: the weights, masters and moments are equal."""
    cfg = pt.gpt_tiny()
    batches = _batches(45, cfg.vocab_size, n=4)

    def build():
        m = pt.GPTForCausalLM(cfg, device="cpu", seed=5).train()
        sched = pt.optimizer.lr.LinearWarmup(
            pt.optimizer.lr.CosineAnnealingDecay(LR, T_max=4), 2, 0.0, LR)
        opt = pt.AdamW(learning_rate=sched, parameters=m.parameters(),
                       multi_precision=True,
                       grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        pt.amp.decorate(m, opt, level="O2")
        return m, opt, sched

    def run(m, opt, sched, bs):
        for ids, labels in bs:
            _port_step(m, opt, cfg, ids, labels, level="O2")
            sched.step()

    m, opt, sched = build()
    run(m, opt, sched, batches[:2])
    saved_model = {n: p.detach().clone() for n, p in m.named_parameters()}
    saved_opt = opt.state_dict()
    run(m, opt, sched, batches[2:])
    m2, opt2, sched2 = build()
    with torch.no_grad():
        for n, p in m2.named_parameters():
            p.copy_(saved_model[n])
    opt2.set_state_dict(saved_opt)
    assert sched2.last_epoch == 2 and opt2._global_step == 2
    run(m2, opt2, sched2, batches[2:])
    for (n, p), p2 in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(p, p2), n
        assert torch.equal(opt._master_weights[p],
                           opt2._master_weights[p2]), n
        for acc in ("moment1", "moment2", "beta_pow"):
            a, b = opt._accumulators[acc][p], opt2._accumulators[acc][p2]
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), n


def test_state_dict_keys_resolve_by_longest_name():
    """With 11 layers, ``gpt.h.1.*`` and ``gpt.h.10.*`` keys must each load
    into their own parameter."""
    cfg = pt.gpt_tiny()
    cfg.num_layers = 11
    m = pt.GPTForCausalLM(cfg, device="cpu", seed=6)
    opt = pt.AdamW(learning_rate=LR, parameters=m.parameters())
    params = dict(m.named_parameters())
    state = {}
    for i, (name, p) in enumerate(params.items()):
        state[f"{name}_moment1"] = torch.full(p.shape, float(i))
        state[f"{name}_beta_pow"] = float(i)
    opt.set_state_dict(state)
    for i, (name, p) in enumerate(params.items()):
        assert torch.equal(opt._accumulators["moment1"][p],
                           torch.full(p.shape, float(i))), name
        assert opt._accumulators["beta_pow"][p] == float(i), name
    assert "gpt.h.1.mlp.fc1.weight" in params and \
        "gpt.h.10.mlp.fc1.weight" in params


def test_scheduler_learning_rate_refuses_set_lr():
    m = pt.GPTForCausalLM(pt.gpt_tiny(), device="cpu")
    sched = pt.optimizer.lr.StepDecay(0.1, step_size=2)
    opt = pt.AdamW(learning_rate=sched, parameters=m.parameters())
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="scheduler.step"):
        opt.set_lr(0.5)
    sched.step()
    sched.step()
    assert opt.get_lr() == pytest.approx(0.01)
    plain = pt.AdamW(learning_rate=0.1, parameters=m.parameters())
    plain.set_lr_scheduler(sched)
    assert plain.get_lr() == pytest.approx(0.01)
    with pytest.raises(TypeError):
        pt.AdamW(learning_rate="0.1", parameters=m.parameters())


@pytest.mark.parametrize("inject", [False, True])
def test_grad_scaler_matches_jax_and_skips_on_inf(inject):
    """f32 training under ``GradScaler(init_loss_scaling=1024,
    incr_every_n_steps=2)`` in both packages, with an inf put into one
    gradient at step 1 when ``inject``: that step is skipped (weights
    unchanged) and the scale halves; otherwise it doubles every 2 steps."""
    jm, tm, cfg = _both(46)
    jm.train()
    tm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                  parameters=jm.parameters())
    topt = pt.AdamW(learning_rate=LR, epsilon=EPS,
                    parameters=tm.parameters())
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    js, ts = paddle.amp.GradScaler(**kw), pt.amp.GradScaler(**kw)
    jparams = dict(jm.named_parameters())
    scales = []
    for step, (ids, labels) in enumerate(_batches(47, cfg.vocab_size, 4)):
        jl = JaxCriterion()(jm(Tensor(jnp.asarray(ids))),
                            Tensor(jnp.asarray(labels)))
        tl = pt.GPTPretrainingCriterion(cfg)(tm(torch.from_numpy(ids)),
                                             torch.from_numpy(labels))
        js.scale(jl).backward()
        ts.scale(tl).backward()
        if inject and step == 1:
            name = "gpt.h.0.mlp.fc1.weight"
            dict(tm.named_parameters())[name].grad[0, 0] = float("inf")
            jparams[name]._grad = jparams[name]._grad.at[0, 0].set(jnp.inf)
        before = pt.params_to_numpy(tm)
        js.step(jopt)
        ts.step(topt)
        assert ts._found_inf == js._found_inf == (inject and step == 1)
        if ts._found_inf:
            after = pt.params_to_numpy(tm)
            assert all(np.array_equal(after[n], before[n]) for n in before)
        js.update()
        ts.update()
        jopt.clear_grad()
        topt.clear_grad()
        assert ts._scale == js._scale
        scales.append(ts._scale)
        np.testing.assert_allclose(tl.item(), float(np.asarray(jl._data)),
                                   rtol=RTOL, atol=ATOL)
    assert scales == ([1024.0, 512.0, 512.0, 1024.0] if inject
                      else [1024.0, 2048.0, 2048.0, 4096.0])
    _assert_params(tm, jm, RTOL, ATOL)
    assert ts.state_dict() == js.state_dict()
    fresh = pt.amp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh._scale == ts._scale
    with pytest.raises(RuntimeError, match="update"):
        ts.step(topt)
        ts.step(topt)


def test_recompute_matches_jax_and_no_recompute():
    """``GPTConfig(recompute=True)`` at ``dropout=0``: loss and every
    gradient equal the JAX package's recompute run within the slice-2
    tolerance, and the port's own run without recompute exactly."""
    jm, tm, cfg = _both(48, recompute=True)
    jm.train()
    tm.train()
    ids, labels = _batches(49, cfg.vocab_size)[0]
    jl = JaxCriterion()(jm(Tensor(jnp.asarray(ids))),
                        Tensor(jnp.asarray(labels)))
    jl.backward()
    tl = pt.GPTPretrainingCriterion(cfg)(tm(torch.from_numpy(ids)),
                                         torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(np.asarray(jl._data)),
                               rtol=RTOL, atol=ATOL)
    for (name, p), (_, jp) in zip(tm.named_parameters(),
                                  jm.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp._grad),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.config.recompute = False
    for p in tm.parameters():
        p.grad = None
    pt.GPTPretrainingCriterion(cfg)(tm(torch.from_numpy(ids)),
                                    torch.from_numpy(labels)).backward()
    for n, p in tm.named_parameters():
        assert torch.equal(p.grad, grads[n]), n


def _dropout_run(recompute, level, steps=2):
    cfg = pt.gpt_tiny(recompute=recompute)
    cfg.dropout = 0.1
    m = pt.GPTForCausalLM(cfg, device="cpu", seed=7).train()
    opt = pt.AdamW(learning_rate=LR, parameters=m.parameters())
    if level == "O2":
        pt.amp.decorate(m, opt, level="O2")
    out = []
    for ids, labels in _batches(50, cfg.vocab_size, steps):
        with pt.auto_cast(enable=level is not None, level=level or "O1"):
            loss = pt.GPTPretrainingCriterion(cfg)(
                m(torch.from_numpy(ids)), torch.from_numpy(labels))
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in m.parameters()]))
        opt.step()
        opt.clear_grad()
    return out


@pytest.mark.parametrize("level", [None, "O1", "O2"])
def test_recompute_with_dropout_gives_the_same_gradients_bit_for_bit(level):
    """At ``dropout=0.1`` the replay draws the forward's masks from the
    model's own dropout generator, and leaves it where the forward would
    have; it runs under the forward's AMP settings though the backward
    runs outside ``auto_cast``: two training steps give bit-equal losses
    and gradients."""
    for (l1, g1), (l2, g2) in zip(_dropout_run(False, level),
                                  _dropout_run(True, level)):
        assert torch.equal(l1, l2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_recompute_replays_each_block_once_in_backward(monkeypatch):
    """Training with recompute runs every block twice (forward and
    replay); eval, or without the flag, once; ``recompute_sequential``
    replays a sequence of modules in segments."""
    gpt_mod = importlib.import_module("paddle_tpu_torch.models.gpt")
    calls = []
    orig = gpt_mod.GPTBlock.forward

    def counted(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(gpt_mod.GPTBlock, "forward", counted)
    cfg = pt.gpt_tiny(recompute=True)
    m = pt.GPTForCausalLM(cfg, device="cpu").train()
    ids = torch.from_numpy(_batches(51, cfg.vocab_size)[0][0])
    m(ids).float().sum().backward()
    assert len(calls) == 2 * cfg.num_layers
    calls.clear()
    with torch.no_grad():
        m.eval()(ids)
    assert len(calls) == cfg.num_layers
    lin = [torch.nn.Linear(4, 4) for _ in range(4)]
    x = torch.randn(2, 4, requires_grad=True)
    want = torch.autograd.grad(torch.nn.Sequential(*lin)(x).sum(), x)[0]
    out = pt.distributed.fleet.recompute_sequential({"segments": 2}, lin, x)
    got = torch.autograd.grad(out.sum(), x)[0]
    assert torch.equal(got, want)


def test_minimize_and_scaler_minimize_are_backward_then_step():
    """``opt.minimize(loss)`` is ``backward`` then ``step`` (the dygraph
    form, ``optimizer.py:169-179``), and ``GradScaler.minimize`` steps and
    updates; both runs land on the same weights as the explicit loop."""
    cfg = pt.gpt_tiny()
    ids, labels = (torch.from_numpy(a) for a in _batches(52, 256)[0])
    out = []
    for form in ("explicit", "minimize", "scaler"):
        m = pt.GPTForCausalLM(cfg, device="cpu", seed=8).train()
        opt = pt.AdamW(learning_rate=LR, parameters=m.parameters())
        loss = pt.GPTPretrainingCriterion(cfg)(m(ids), labels)
        if form == "explicit":
            opt.backward(loss)
            opt.step()
        elif form == "minimize":
            assert opt.minimize(loss) == (None, None)
        else:
            scaler = pt.amp.GradScaler(init_loss_scaling=1.0,
                                       incr_every_n_steps=1)
            scaler.scale(loss).backward()
            scaler.minimize(opt, loss)
            assert scaler._scale == 2.0
        opt.clear_grad(set_to_zero=True)
        assert all(p.grad is None for p in m.parameters())
        assert opt._global_step == 1
        out.append(pt.params_to_numpy(m))
    for name in out[0]:
        np.testing.assert_array_equal(out[1][name], out[0][name])
        np.testing.assert_array_equal(out[2][name], out[0][name])
