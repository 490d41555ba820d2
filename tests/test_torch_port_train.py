"""The port's GPT training step vs the JAX package's, on the same weights.

``paddle_tpu``'s ``gpt_tiny`` (f32, ``dropout=0``; biases and norm
parameters perturbed so a mis-mapped weight cannot hide) carries its
weights to ``paddle_tpu_torch`` through ``params_from_paddle_tpu``; both
take 5 AdamW steps (``weight_decay`` 0.1, biases and norms exempted by
``apply_decay_param_fun``) on the same numpy batches through model,
``GPTPretrainingCriterion``, ``backward``, ``step`` and ``clear_grad``.
Losses must match at every step and the final parameters within the
precedent of ``tests/test_torch_parity.py``: ``rtol 1e-4 / atol 1e-5``.
Adam's ``epsilon`` is 1e-6 rather than 1e-8: the key bias has an exactly
zero gradient (softmax ignores a constant added to a row's scores), and
with ``epsilon`` 1e-8 Adam's normalisation turns either side's f32
rounding noise in it into full ``lr`` steps of random sign.

On the CPU the port's attention takes its plain chain (the flash kernels
need a CUDA tensor) and every kernel wrapper its plain version; the flash
plain versions themselves are held against JAX's Pallas kernels in
``tests/test_torch_port_kernels.py``.
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
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.nn import layer as port_layer

# the module (the package re-exports the function of the same name)
amp_mod = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

RTOL, ATOL = 1e-4, 1e-5
LR, WD, EPS, STEPS, B, S = 1e-3, 0.1, 1e-6, 5, 2, 24


def _exempt(name):
    return name.endswith("bias") or ".ln_" in name or ".ln_f." in name


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


def _batches(seed, vocab):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=(B, S)),
             rng.randint(0, vocab, size=(B, S))) for _ in range(STEPS)]


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_adamw_training_matches_jax_step_for_step(kv_heads):
    jm, tm, cfg = _both(21 if kv_heads is None else 22,
                        num_kv_heads=kv_heads)
    jm.train()
    tm.train()
    jdecay = {p.name for n, p in jm.named_parameters() if not _exempt(n)}
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, epsilon=EPS, parameters=jm.parameters(),
        weight_decay=WD, apply_decay_param_fun=lambda n: n in jdecay)
    topt = pt.AdamW(learning_rate=LR, epsilon=EPS,
                    parameters=tm.parameters(), weight_decay=WD,
                    apply_decay_param_fun=lambda n: not _exempt(n))
    jcrit, tcrit = JaxCriterion(), pt.GPTPretrainingCriterion(cfg)
    for step, (ids, labels) in enumerate(_batches(5, cfg.vocab_size)):
        jloss = jcrit(jm(Tensor(jnp.asarray(ids))),
                      Tensor(jnp.asarray(labels)))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = tcrit(tm(torch.from_numpy(ids)), torch.from_numpy(labels))
        tloss.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(tloss.item(), float(np.asarray(
            jloss._data)), rtol=RTOL, atol=ATOL, err_msg=f"step {step}")
    assert all(p.grad is None for p in tm.parameters())
    got = pt.params_to_numpy(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # every parameter took STEPS updates: its beta_pow reads STEPS
    assert set(topt._accumulators["beta_pow"].values()) == {float(STEPS)}


def test_weight_decay_follows_apply_decay_param_fun():
    """With zero gradients the only update is the decoupled decay: decayed
    parameters shrink by ``(1 - lr*wd)``, exempted ones stay."""
    _, tm, _ = _both(23)
    before = pt.params_to_numpy(tm)
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    opt = pt.AdamW(learning_rate=0.5, parameters=tm.parameters(),
                   weight_decay=0.2,
                   apply_decay_param_fun=lambda n: not _exempt(n))
    opt.step()
    after = pt.params_to_numpy(tm)
    for name in before:
        scale = 1.0 if _exempt(name) else 1.0 - 0.5 * 0.2
        np.testing.assert_allclose(after[name], before[name] * scale,
                                   rtol=1e-6, err_msg=name)


def test_step_skips_parameters_without_grad_and_groups_scale_lr():
    _, tm, _ = _both(24)
    params = dict(tm.named_parameters())
    w_head = params["gpt.h.0.mlp.fc1.weight"]
    w_other = params["gpt.h.1.mlp.fc1.weight"]
    untouched = params["gpt.wpe.weight"]
    opt = pt.AdamW(learning_rate=1e-2, weight_decay=0.0, parameters=[
        {"params": [w_head, untouched]},
        {"params": [w_other], "learning_rate": 0.5}])
    before = {n: p.detach().clone() for n, p in params.items()}
    w_head.grad = torch.ones_like(w_head)
    w_other.grad = torch.ones_like(w_other)
    opt.step()
    # the first Adam step moves every element by lr (m/sqrt(v) = 1)
    torch.testing.assert_close(before["gpt.h.0.mlp.fc1.weight"] - w_head,
                               torch.full_like(w_head, 1e-2))
    torch.testing.assert_close(before["gpt.h.1.mlp.fc1.weight"] - w_other,
                               torch.full_like(w_other, 5e-3))
    assert torch.equal(untouched, before["gpt.wpe.weight"])
    assert untouched not in opt._accumulators["beta_pow"]
    opt.set_lr(3e-4)
    assert opt.get_lr() == 3e-4


def test_auto_cast_gives_each_op_the_dtype_of_amp_lists(monkeypatch):
    """Under the port's ``auto_cast`` (O1, bf16) every op sees the dtype
    the JAX package's lists give it: the port's casts are spied on and
    each op's inputs compared with ``paddle_tpu``'s ``amp_dtype_for``."""
    for name in amp_lists.WHITE_LIST | amp_lists.BLACK_LIST | {
            "gelu", "lm_head_tied", "embedding"}:
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            want = jax_amp_dtype_for(name)
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            got = amp_mod.amp_dtype_for(name)
        assert (None if want is None else str(jnp.dtype(want))) == (
            None if got is None else str(got).replace("torch.", "")), name
    seen = []

    def spy(op_name, *tensors):
        out = amp_mod.amp_cast(op_name, *tensors)
        seen.append((op_name, {t.dtype for t in out if t is not None}))
        return out

    monkeypatch.setattr(port_layer, "amp_cast", spy)
    monkeypatch.setattr(port_F, "amp_cast", spy)
    jm, tm, cfg = _both(25)
    ids, labels = _batches(6, cfg.vocab_size)[0]
    tm.train()
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        logits = tm(torch.from_numpy(ids))
        loss = pt.GPTPretrainingCriterion(cfg)(logits,
                                               torch.from_numpy(labels))
    loss.backward()
    # embedding and gelu are on neither list: their inputs keep their type
    expect = {"linear": torch.bfloat16, "layer_norm": torch.float32,
              "scaled_dot_product_attention": torch.bfloat16,
              "cross_entropy": torch.float32, "embedding": torch.float32,
              "gelu": torch.bfloat16}
    assert {op for op, _ in seen} == set(expect)
    for op, dtypes in seen:
        assert dtypes == {expect[op]}, (op, dtypes)
    L = cfg.num_layers
    counts = {op: sum(o == op for o, _ in seen) for op in expect}
    assert counts == {"linear": 4 * L, "layer_norm": 2 * L + 1,
                      "scaled_dot_product_attention": L,
                      "cross_entropy": 1, "embedding": 2, "gelu": L}
    # the tied head is on neither list: f32 logits in both packages
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jlogits = jm(Tensor(jnp.asarray(ids)))
    assert logits.dtype == torch.float32
    assert str(jnp.dtype(jlogits._data.dtype)) == "float32"
    # gradients reach the f32 parameters in f32
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters())


def test_auto_cast_nests_and_refuses_what_is_not_ported():
    """O1 and O2 nest and restore; float16 stays refused (the port's
    kernels take bf16 and f32), and so does an unknown level."""
    with pt.auto_cast(level="O1"):
        assert amp_mod.amp_dtype_for("linear") == torch.bfloat16
        assert amp_mod.amp_dtype_for("gelu") is None
        with pt.auto_cast(enable=False):
            assert amp_mod.amp_dtype_for("linear") is None
        with pt.auto_cast(level="O2"):
            assert amp_mod.amp_dtype_for("gelu") == torch.bfloat16
            assert amp_mod.amp_dtype_for("layer_norm") == torch.float32
        assert amp_mod.amp_dtype_for("layer_norm") == torch.float32
        assert amp_mod.amp_dtype_for("gelu") is None
    assert amp_mod.amp_dtype_for("linear") is None
    for level in ("O1", "O2"):
        with pytest.raises(NotImplementedError):
            with pt.auto_cast(level=level, dtype="float16"):
                pass
    with pytest.raises(ValueError):
        with pt.auto_cast(level="O3"):
            pass


def test_auto_cast_loss_tracks_jax_in_bf16():
    """The same O1 forward in both packages: bf16 rounds at other places
    in the two frameworks, so the losses agree to bf16 precision."""
    jm, tm, cfg = _both(26)
    ids, labels = _batches(7, cfg.vocab_size)[0]
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jloss = JaxCriterion()(jm(Tensor(jnp.asarray(ids))),
                               Tensor(jnp.asarray(labels)))
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        tloss = pt.GPTPretrainingCriterion(cfg)(
            tm(torch.from_numpy(ids)), torch.from_numpy(labels))
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(tloss.item(), float(np.asarray(jloss._data)),
                               rtol=1e-2)


@pytest.mark.parametrize("use_mask", [False, True])
def test_criterion_and_cross_entropy_match_jax(use_mask):
    rng = np.random.RandomState(8)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=(2, 5))
    labels[0, 1] = -100                     # ignore_index
    mask = (rng.rand(2, 5) > 0.3).astype(np.float32) if use_mask else None
    jl = JaxCriterion()(Tensor(jnp.asarray(logits)),
                        Tensor(jnp.asarray(labels)),
                        None if mask is None else Tensor(jnp.asarray(mask)))
    tl = pt.GPTPretrainingCriterion()(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(tl.item(), float(np.asarray(jl._data)),
                               rtol=1e-6)
    flat = torch.from_numpy(logits.reshape(10, 11))
    lab = torch.from_numpy(labels.reshape(10))
    ref = torch.nn.functional.cross_entropy(flat, lab, ignore_index=-100)
    np.testing.assert_allclose(port_F.cross_entropy(flat, lab).item(),
                               ref.item(), rtol=1e-6)


def test_dropout_scales_in_training_and_draws_from_its_generator():
    x = torch.ones(4000)
    a = port_F.dropout(x, 0.25, True, torch.Generator().manual_seed(1))
    b = port_F.dropout(x, 0.25, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert port_F.dropout(x, 0.25, False) is x
    layer = pt.nn.Dropout(0.5, torch.Generator().manual_seed(2)).eval()
    assert layer(x) is x


def test_plain_attention_chain_matches_jax_with_dropout_off():
    """The sdpa plain chain (taken on the CPU) against the JAX package's,
    causal and with a boolean mask."""
    from paddle_tpu.nn import functional as jax_F
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(2, 7, 3, 16).astype(np.float32) for _ in range(3))
    mask = rng.rand(2, 3, 7, 7) > 0.3
    mask[..., 0] = True
    for kw in ({"is_causal": True}, {"attn_mask": mask}):
        jkw = {k_: Tensor(jnp.asarray(a)) if k_ == "attn_mask" else a
               for k_, a in kw.items()}
        tkw = {k_: torch.from_numpy(a) if k_ == "attn_mask" else a
               for k_, a in kw.items()}
        want = jax_F.scaled_dot_product_attention(
            *[Tensor(jnp.asarray(a)) for a in (q, k, v)], training=False,
            **jkw)
        got = port_F.scaled_dot_product_attention(
            *[torch.from_numpy(a) for a in (q, k, v)], training=False,
            **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   rtol=1e-5, atol=1e-6)
