"""The port's ``GPTForCausalLM.generate`` against the JAX package's.

``gpt_tiny`` and its GQA variant (``num_kv_heads=2``) with non-zero biases
and norm weights, the port holding the JAX model's weights
(``convert.params_from_paddle_tpu``), f32 on the CPU, prompts from a
numpy seed:

* greedy tokens equal JAX's exactly: eager over the dense cache, eager
  without a cache, and compiled over the static cache (on the CPU its
  step runs eagerly over the same static buffers a graph replays on the
  card); with ``eos_token_id`` too, including the compiled output's zero
  columns after every row finished and the eager loop's shorter output;
* the static cache arm's logits and buffers within ``rtol 1e-4 / atol
  1e-5`` of JAX's, and a 0-d device ``pos_offset`` equal to the int one;
* the ``max_seq_len`` check, the training flag restored;
* sampling, which cannot match ``jax.random`` draw for draw: reproducible
  from one generator seed, only ever among the ``top_k`` largest logits
  of its step (teacher-forced), and greedy as the temperature goes to 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import (GPTForCausalLM, gpt_tiny,
                              params_from_paddle_tpu)

KVH = [None, 2]


def _models(seed, kvh):
    """The JAX ``gpt_tiny`` with non-trivial biases and norm weights, and
    the port's model holding the same weights."""
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(num_kv_heads=kvh))
    jm.eval()
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif ".ln_" in name:
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = params_from_paddle_tpu(arrays, gpt_tiny(num_kv_heads=kvh),
                                device="cpu")
    return jm, tm


def _prompts(seed, B=3, P=7):
    return np.random.RandomState(seed).randint(1, 256, (B, P)).astype(
        np.int64)


def _both(jm, tm, ids, **kw):
    want = jm.generate(paddle.to_tensor(ids), **kw).numpy()
    got = tm.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int64
    return got.numpy(), want


@pytest.mark.parametrize("kvh", KVH)
@pytest.mark.parametrize("mode", [dict(compiled=False),
                                  dict(compiled=False, use_cache=False),
                                  dict(compiled=True), dict()])
def test_greedy_tokens_equal_jax(kvh, mode):
    jm, tm = _models(11, kvh)
    ids = _prompts(1)
    got, want = _both(jm, tm, ids, max_new_tokens=9, temperature=0.0,
                      **mode)
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(got, want)


def _eos_exits_early(out, P, n):
    """A token every row emits before its last step, the one that stops
    them all earliest -> (eos, step after which every row has finished)
    or None."""
    gen = out[:, P:]
    best = None
    for tok in set(gen[0].tolist()):
        hits = [np.flatnonzero(row == tok) for row in gen]
        if all(len(h) for h in hits):
            last = max(int(h[0]) for h in hits)
            if last < n - 2 and (best is None or last < best[1]):
                best = (tok, last)
    return best


@pytest.mark.parametrize("kvh", KVH)
@pytest.mark.parametrize("compiled", [False, True])
def test_eos_rows_and_early_exit_equal_jax(kvh, compiled):
    """A row that emitted eos keeps emitting it while the others go on;
    once every row has finished the eager loop stops (shorter output) and
    the compiled one leaves the columns it never reached at 0."""
    jm, tm = _models(12, kvh)
    P, n = 7, 12
    # prompts under which one token ends every row's greedy run early
    ids = _prompts(8, P=P)
    free = jm.generate(paddle.to_tensor(ids), max_new_tokens=n,
                       temperature=0.0, compiled=False).numpy()
    # one row finishes first: row 0's second token
    eos = int(free[0, P + 1])
    got, want = _both(jm, tm, ids, max_new_tokens=n, temperature=0.0,
                      eos_token_id=eos, compiled=compiled)
    np.testing.assert_array_equal(got, want)
    # after its eos, eos (or, compiled, 0 once every row has finished)
    tail = set(got[0, P + 1:].tolist())
    assert tail == {eos} or (compiled and tail == {eos, 0})
    # every row finishes early
    pick = _eos_exits_early(free, P, n)
    assert pick is not None, "no token stops every row early at this seed"
    eos, last = pick
    got, want = _both(jm, tm, ids, max_new_tokens=n, temperature=0.0,
                      eos_token_id=eos, compiled=compiled)
    np.testing.assert_array_equal(got, want)
    if compiled:
        assert got.shape == (3, P + n)
        assert (got[:, P + last + 1:] == 0).all()
    else:
        assert got.shape == (3, P + last + 1)
        assert (got[:, -1] == eos).all()


@pytest.mark.parametrize("kvh", KVH)
def test_compiled_decoder_reuses_its_buffers(kvh):
    """Two prompts of one shape share one static decoder (the key of its
    graph on the card), each call starting from fresh buffers; another
    length gets its own."""
    jm, tm = _models(13, kvh)
    for seed in (3, 4):
        ids = _prompts(seed)
        got, want = _both(jm, tm, ids, max_new_tokens=5, temperature=0.0)
        np.testing.assert_array_equal(got, want)
    assert len(tm.decode_programs._decoders) == 1
    got, want = _both(jm, tm, _prompts(5, P=4), max_new_tokens=5,
                      temperature=0.0)
    np.testing.assert_array_equal(got, want)
    assert len(tm.decode_programs._decoders) == 2
    assert tm.decode_programs.graphs == 0          # no graphs on the CPU
    tm.decode_programs.clear()
    assert not tm.decode_programs._decoders


@pytest.mark.parametrize("kvh", KVH)
def test_static_cache_arm_matches_jax(kvh):
    """The static arm: a 5-token prefill into [2, 9] buffers, then two
    one-token steps at the device cursor: logits and buffers within rtol
    1e-4 / atol 1e-5, the cursor advanced as JAX advances it."""
    jm, tm = _models(14, kvh)
    cfg = jm.config
    shape = (2, 9, cfg.num_kv_heads, cfg.hidden_size // cfg.num_heads)
    jc = [{"static": True, "k": Tensor(jnp.zeros(shape, jnp.float32)),
           "v": Tensor(jnp.zeros(shape, jnp.float32)),
           "len": Tensor(jnp.asarray(0, jnp.int32))}
          for _ in range(cfg.num_layers)]
    tc = [{"static": True, "k": torch.zeros(shape), "v": torch.zeros(shape),
           "len": torch.tensor(0)} for _ in range(cfg.num_layers)]
    rng = np.random.RandomState(6)
    steps = [rng.randint(1, 256, (2, 5)), rng.randint(1, 256, (2, 1)),
             rng.randint(1, 256, (2, 1))]
    for i, ids in enumerate(steps):
        jkw = tkw = {}
        if i:
            jkw = {"pos_offset": jc[0]["len"]}
            tkw = {"pos_offset": tc[0]["len"]}
        want = np.asarray(jm(Tensor(jnp.asarray(ids)), caches=jc,
                             **jkw)._data)
        with torch.no_grad():
            got = tm(torch.from_numpy(ids), caches=tc, **tkw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        for j, t in zip(jc, tc):
            assert int(t["len"]) == int(np.asarray(j["len"]._data))
            for key in ("k", "v"):
                np.testing.assert_allclose(t[key].numpy(),
                                           np.asarray(j[key]._data),
                                           rtol=1e-4, atol=1e-5)
    assert int(tc[0]["len"]) == 7


def test_zero_d_offset_equals_int_offset():
    """``pos_offset`` as a 0-d device tensor shifts the arange as the int
    does (the compiled step's positions, with no host read)."""
    _, tm = _models(15, None)
    ids = torch.from_numpy(_prompts(7, P=4))
    with torch.no_grad():
        torch.testing.assert_close(tm(ids, pos_offset=torch.tensor(6)),
                                   tm(ids, pos_offset=6), rtol=0, atol=0)


def test_max_seq_len_is_checked_and_training_restored():
    jm, tm = _models(16, None)
    ids = _prompts(8, P=60)
    for m, x in ((jm, paddle.to_tensor(ids)), (tm, torch.from_numpy(ids))):
        with pytest.raises(ValueError, match="max_seq_len"):
            m.generate(x, max_new_tokens=5)
    tm.train()
    tm.generate(torch.from_numpy(ids[:, :8]), max_new_tokens=2,
                temperature=0.0)
    assert tm.training
    tm.generate(torch.from_numpy(ids[:, :8]), max_new_tokens=2,
                temperature=0.7, top_k=3)
    assert tm.training


def _sample(tm, ids, seed, **kw):
    g = torch.Generator().manual_seed(seed)
    return tm.generate(torch.from_numpy(ids), max_new_tokens=10,
                       generator=g, **kw).numpy()


@pytest.mark.parametrize("kvh", KVH)
def test_sampling_is_reproducible_from_its_generator(kvh):
    _, tm = _models(17, kvh)
    ids = _prompts(9)
    a = _sample(tm, ids, 5, temperature=0.9, top_k=20)
    np.testing.assert_array_equal(a, _sample(tm, ids, 5, temperature=0.9,
                                             top_k=20))
    assert not np.array_equal(a, _sample(tm, ids, 6, temperature=0.9,
                                         top_k=20))
    # without generator=, a model's own one, seeded from its seed
    runs = [GPTForCausalLM(gpt_tiny(num_kv_heads=kvh), device="cpu",
                           seed=4).generate(torch.from_numpy(ids),
                                            max_new_tokens=10,
                                            temperature=0.9).numpy()
            for _ in range(2)]
    np.testing.assert_array_equal(*runs)


@pytest.mark.parametrize("kvh", KVH)
@pytest.mark.parametrize("use_cache", [True, False])
def test_top_k_samples_only_among_the_k_largest(kvh, use_cache):
    """Every sampled token is among the ``top_k`` largest logits of its
    step, read back by a no-cache forward over the sampled sequence."""
    _, tm = _models(18, kvh)
    ids = _prompts(10)
    k = 3
    out = _sample(tm, ids, 7, temperature=1.5, top_k=k, use_cache=use_cache)
    with torch.no_grad():
        logits = tm(torch.from_numpy(out[:, :-1])).numpy()
    P = ids.shape[1]
    for t in range(P, out.shape[1]):
        top = np.argsort(-logits[:, t - 1], axis=-1)[:, :k]
        assert all(out[b, t] in top[b] for b in range(out.shape[0])), t


@pytest.mark.parametrize("kvh", KVH)
def test_sampling_at_temperature_near_zero_is_greedy(kvh):
    jm, tm = _models(19, kvh)
    ids = _prompts(11)
    greedy = jm.generate(paddle.to_tensor(ids), max_new_tokens=10,
                         temperature=0.0).numpy()
    np.testing.assert_array_equal(
        _sample(tm, ids, 8, temperature=1e-8), greedy)
