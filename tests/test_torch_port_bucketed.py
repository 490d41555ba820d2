"""The bucketed serving fallback of the port against the JAX package.

* The plain paged decode attention (what the ``paged_attention`` wrapper
  runs on a CPU tensor) against ``paged_attention(interpret=True)``, the
  chunk step's ``paged_prefill_reference`` against the JAX one, and the
  port's ``incubate.paged_attention`` gradients against ``jax.vjp`` of
  ``paged_attention_trainable``. Tolerance: f32 ``atol 1e-5`` (the sides
  sum in different orders); bf16 one bf16 rounding of the output.
* ``pick_bucket``, ``PagedKVCache.write_prefill``/``gather`` and the GPT's
  dense-prefill cache arm against the JAX package's.
* The port's ``ServingEngine(ragged=False)`` against JAX's
  ``ServingEngine(ragged=False, attn_backend="xla")`` on ``gpt_tiny`` with
  carried weights (f32 on the CPU): greedy tokens identical and every
  captured decode step's logits within ``rtol 2e-3 / atol 2e-4``
  (``tests/test_serving_parity.py``) over dense prefill, a prefix-hit
  tail through the chunk step, chunked prefill with mid-page chunk
  boundaries, GQA pools, eviction and ``use_rms_norm=True``; and one
  ragged scenario with ``use_rms_norm=True``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.incubate as port_incubate
from paddle_tpu.inference import pick_bucket as jax_pick_bucket
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import decode as jax_decode
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxKV
from paddle_tpu_torch import ServingEngine, gpt_tiny, params_from_paddle_tpu
from paddle_tpu_torch.inference import pick_bucket
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import (PagedKVCache, paged_decode_attention,
                                      paged_prefill_attention)

jax_paged = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

RTOL, ATOL = 2e-3, 2e-4


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode_inputs(H, KVH, D, seed, page_size=4, num_pages=12, max_pages=5):
    """Five rows: contexts that end mid-page and on a page edge, the full
    ``max_pages * page``, one row with context 0, and tables padded with
    -1 past each context."""
    rng = np.random.RandomState(seed)
    ctx = np.array([7, 8, max_pages * page_size, 0, 1], np.int32)
    bt = np.full((len(ctx), max_pages), -1, np.int32)
    for r, c in enumerate(ctx):
        n = -(-int(c) // page_size)
        bt[r, :n] = rng.choice(np.arange(1, num_pages), size=n,
                               replace=False)
    return dict(
        q=rng.randn(len(ctx), H, D).astype(np.float32),
        k=rng.randn(num_pages, page_size, KVH, D).astype(np.float32),
        v=rng.randn(num_pages, page_size, KVH, D).astype(np.float32),
        bt=bt, ctx=ctx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_paged_attention_plain_matches_pallas_interpret(kvh, dtype):
    x = _decode_inputs(4, kvh, 64, seed=kvh)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_paged.paged_attention(
        jnp.asarray(x["q"], jdt), jnp.asarray(x["k"], jdt),
        jnp.asarray(x["v"], jdt), jnp.asarray(x["bt"]),
        jnp.asarray(x["ctx"]), interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = K.paged_attention.launches
    got = K.paged_attention(_torch(x["q"]).to(tdt), _torch(x["k"]).to(tdt),
                            _torch(x["v"]).to(tdt), _torch(x["bt"]),
                            _torch(x["ctx"]))
    # the CPU wrapper runs the plain version and launches nothing
    assert K.paged_attention.launches == before
    assert got.dtype == tdt
    got = got.float().numpy()
    assert (got[3] == 0).all(), "context 0 must come out exactly zero"
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        # both round one f32 result to bf16: within one bf16 ulp
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("kvh", [4, 2])
def test_paged_prefill_reference_matches_jax(kvh):
    x = _decode_inputs(4, kvh, 64, seed=10 + kvh)
    rng = np.random.RandomState(kvh)
    B, S = 3, 6
    q = rng.randn(B, S, 4, 64).astype(np.float32)
    bt = x["bt"][:B]
    start = np.array([1, 0, 14], np.int32)
    lens = np.array([6, 3, 6], np.int32)
    want = np.asarray(jax_paged.paged_prefill_reference(
        jnp.asarray(q), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(bt), jnp.asarray(start), jnp.asarray(lens)))
    got = K.paged_prefill_reference(_torch(q), _torch(x["k"]),
                                    _torch(x["v"]), _torch(bt),
                                    _torch(start), _torch(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_serving_decode_entry_points_match_jax():
    """``serving.decode``'s decode step and chunk-step attention against
    the JAX module's (its ``xla`` backend, the gather formulations)."""
    x = _decode_inputs(4, 2, 64, seed=30)
    args = [x[n] for n in ("q", "k", "v", "bt", "ctx")]
    want = np.asarray(jax_decode.paged_decode_attention(
        *(jnp.asarray(a) for a in args), backend="xla"))
    got = paged_decode_attention(*(_torch(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    q = np.random.RandomState(30).randn(2, 5, 4, 64).astype(np.float32)
    start, lens = np.array([3, 0], np.int32), np.array([5, 2], np.int32)
    pargs = [q, x["k"], x["v"], x["bt"][:2], start, lens]
    want = np.asarray(jax_decode.paged_prefill_attention(
        *(jnp.asarray(a) for a in pargs)))
    got = paged_prefill_attention(*(_torch(a) for a in pargs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kvh", [4, 2])
def test_incubate_paged_attention_grads_match_jax(kvh):
    x = _decode_inputs(4, kvh, 64, seed=20 + kvh)
    ct = np.random.RandomState(kvh).randn(*x["q"].shape).astype(np.float32)
    bt, ctx = jnp.asarray(x["bt"]), jnp.asarray(x["ctx"])
    out, vjp = jax.vjp(
        lambda q, k, v: jax_paged.paged_attention_trainable(
            q, k, v, bt, ctx, interpret=True),
        *(jnp.asarray(x[n]) for n in ("q", "k", "v")))
    want = vjp(jnp.asarray(ct))
    ins = [_torch(x[n]).requires_grad_(True) for n in ("q", "k", "v")]
    got = port_incubate.paged_attention(*ins, _torch(x["bt"]),
                                        _torch(x["ctx"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    grads = torch.autograd.grad(got, ins, _torch(ct))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("n,strict", [(1, False), (3, False), (4, True),
                                      (9, False), (9, True)])
def test_pick_bucket_matches_jax(n, strict):
    buckets = [1, 2, 4, 8]
    try:
        want = jax_pick_bucket(n, buckets, strict=strict)
    except ValueError:
        with pytest.raises(ValueError, match="largest configured bucket"):
            pick_bucket(n, buckets, strict=strict)
        return
    assert pick_bucket(n, buckets, strict=strict) == want


def test_write_prefill_and_gather_match_jax():
    """A prefill of 6 tokens into two pages of 4, over pages holding old
    values: the same pools and readback, the last page's tail zeroed."""
    rng = np.random.RandomState(0)
    jkv, tkv = JaxKV(2, 8, 4, 2, 8), PagedKVCache(2, 8, 4, 2, 8,
                                                  device="cpu")
    old = rng.randn(8, 4, 2, 8).astype(np.float32)
    jkv.k[1] = jnp.asarray(old)
    tkv.k[1] = _torch(old.copy())
    kn, vn = (rng.randn(7, 2, 8).astype(np.float32) for _ in range(2))
    jkv.write_prefill(1, jnp.asarray(kn), jnp.asarray(vn), [5, 2], 6)
    tkv.write_prefill(1, _torch(kn), _torch(vn), [5, 2], 6)
    for layer in (0, 1):
        np.testing.assert_array_equal(tkv.k[layer].numpy(),
                                      np.asarray(jkv.k[layer]))
        np.testing.assert_array_equal(tkv.v[layer].numpy(),
                                      np.asarray(jkv.v[layer]))
    assert (tkv.k[1][2, 2:] == 0).all()
    for which in ("k", "v"):
        np.testing.assert_array_equal(
            tkv.gather(1, [5, 2], 6, which).numpy(),
            np.asarray(jkv.gather(1, [5, 2], 6, which)))
    with pytest.raises(ValueError, match="page capacity"):
        tkv.write_prefill(0, _torch(kn), _torch(vn), [5], 6)


def _models(seed, **kw):
    """The JAX ``gpt_tiny`` with non-trivial biases and norm weights, and
    the port's model holding the same weights."""
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.eval()
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif ".ln_" in name:
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_paddle_tpu(arrays, gpt_tiny(**kw), device="cpu")


@pytest.mark.parametrize("kvh", [None, 2])
def test_dense_prefill_cache_arm_matches_jax(kvh):
    """The dense-prefill arm (a cache dict whose 'k' is None): the same
    logits, and each layer's cache holds the un-expanded KVH-head K/V.
    Then the dense cache takes one more token, as JAX's does, and refuses
    two."""
    from paddle_tpu.core.tensor import Tensor
    jm, tm = _models(3, num_kv_heads=kvh)
    ids = np.random.RandomState(1).randint(1, 256, size=(2, 9))
    L = jm.config.num_layers
    jc = [{"k": None, "v": None} for _ in range(L)]
    tc = [{"k": None, "v": None} for _ in range(L)]
    want = np.asarray(jm(Tensor(jnp.asarray(ids)), caches=jc)._data)
    with torch.no_grad():
        got = tm(_torch(ids), caches=tc).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for j, t in zip(jc, tc):
        assert t["k"].shape == (2, 9, kvh or 4, 16)
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(),
                                       np.asarray(j[key]._data), atol=1e-5)
    nxt = ids[:, :1]
    want = np.asarray(jm(Tensor(jnp.asarray(nxt)), caches=jc,
                         pos_offset=9)._data)
    with torch.no_grad():
        got = tm(_torch(nxt), caches=tc, pos_offset=9).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for j, t in zip(jc, tc):
        assert t["k"].shape == (2, 10, kvh or 4, 16)
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(),
                                       np.asarray(j[key]._data), atol=1e-5)
    with pytest.raises(NotImplementedError, match="one token at a time"):
        tm(_torch(ids[:, :2]), caches=tc)


def _dense_batches(eng, rng):
    # four misses admitted together: two share the 16-token seq bucket (a
    # batch of 2), one takes the 32 bucket, one the 16 bucket alone later
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (11, 20, 5)]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.step()
    reqs.append(eng.submit(rng.randint(1, 256, size=9).tolist(),
                           max_new_tokens=5))
    return reqs, eng.run_until_idle()


def _prefix_tail(eng, rng):
    # unchunked: the second request shares two full pages of the first,
    # so its 5-token tail runs the chunk step
    prompt = rng.randint(1, 256, size=11).tolist()
    r1 = eng.submit(prompt, max_new_tokens=6)
    eng.run_until_idle()
    r2 = eng.submit(prompt[:8] + rng.randint(1, 256, size=5).tolist(),
                    max_new_tokens=6)
    return [r1, r2], eng.run_until_idle()


def _chunked_prefix(eng, rng):
    # chunk 6 on page 4 (chunk boundaries mid-page), staggered admission
    # so decode steps interleave with chunk launches, then a prefix hit
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (11, 12, 3, 9)]
    reqs = [eng.submit(prompts[0], max_new_tokens=6)]
    eng.step()
    reqs += [eng.submit(p, max_new_tokens=6) for p in prompts[1:]]
    eng.run_until_idle()
    reqs.append(eng.submit(prompts[0], max_new_tokens=6))
    return reqs, eng.run_until_idle()


def _eviction(eng, rng):
    # 5 usable pages of 4: two requests growing to 15-16 tokens cannot
    # coexist, so one is evicted and recomputed on readmission
    r1 = eng.submit(rng.randint(1, 256, size=7).tolist(), max_new_tokens=8)
    r2 = eng.submit(rng.randint(1, 256, size=6).tolist(), max_new_tokens=8)
    return [r1, r2], eng.run_until_idle()


SCENARIOS = {
    "dense_prefill": (_dense_batches, {}, dict(page_size=4, num_pages=64,
                                                max_slots=4)),
    "prefix_hit_tail": (_prefix_tail, {}, dict(page_size=4, num_pages=32,
                                               max_slots=2)),
    "chunked_mid_page_prefix_hit": (
        _chunked_prefix, {},
        dict(page_size=4, num_pages=64, max_slots=4, prefill_chunk=6,
             prefill_token_budget=12)),
    "gqa_dense_and_prefix_tail": (
        _prefix_tail, {"num_kv_heads": 2},
        dict(page_size=4, num_pages=32, max_slots=2)),
    "eviction_readmission": (_eviction, {},
                             dict(page_size=4, num_pages=6, max_slots=2)),
    "rms_norm_dense_and_chunked": (
        _chunked_prefix, {"use_rms_norm": True},
        dict(page_size=4, num_pages=64, max_slots=4, prefill_chunk=6)),
    "rms_norm_unchunked": (_dense_batches, {"use_rms_norm": True},
                           dict(page_size=4, num_pages=64, max_slots=4)),
}


def _run_both(name, model_kw, eng_kw, script, ragged):
    jm, tm = _models(200 + len(name), **model_kw)
    runs = []
    for eng in (JaxEngine(jm, attn_backend="xla", ragged=ragged, **eng_kw),
                ServingEngine(tm, ragged=ragged, **eng_kw)):
        eng.capture_logits = []
        reqs, _ = script(eng, np.random.RandomState(7))
        runs.append((eng, reqs, [r.result(10) for r in reqs]))
    (je, _, jtok), (te, treqs, ttok) = runs
    assert ttok == jtok
    assert all(len(t) == r.max_new_tokens for t, r in zip(ttok, treqs))
    assert len(te.capture_logits) == len(je.capture_logits) > 0
    for (jmap, jl), (tmap, tl) in zip(je.capture_logits, te.capture_logits):
        assert sorted(tmap) == sorted(jmap)
        for slot in tmap:
            np.testing.assert_allclose(tl[slot], jl[slot], rtol=RTOL,
                                       atol=ATOL)
    js, ts = je.stats(), te.stats()
    for key in ("prefix_hits", "prefix_hit_tokens", "evictions",
                "prefill_chunk_tokens", "decode_tokens", "ragged"):
        assert ts[key] == js[key], key
    assert te.kv.allocator.used_pages == 0
    return je, te


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_bucketed_engine_matches_jax_engine(name):
    script, model_kw, eng_kw = SCENARIOS[name]
    je, te = _run_both(name, model_kw, eng_kw, script, ragged=False)
    ts = te.stats()
    # the same launch shapes as the JAX engine's compiled programs
    assert ts["prefill_shapes"] == sorted(je._prefill_fns)
    assert ts["chunk_shapes"] == sorted(je._chunk_fns)
    assert ts["ragged_token_pads"] == []
    launches = ts["bucketed_launches"]
    assert launches["decode"] == len(te.capture_logits)
    if name.startswith("dense") or name == "rms_norm_unchunked":
        assert launches["prefill"] >= 3 and (2, 16) in ts["prefill_shapes"]
    if "prefix" in name:
        assert ts["prefix_hits"] >= 1 and launches["chunk"] >= 1
    if name == "eviction_readmission":
        assert ts["evictions"] >= 1
    if model_kw.get("num_kv_heads"):
        assert te.kv.k[0].shape[2] == model_kw["num_kv_heads"]
    if model_kw.get("use_rms_norm"):
        assert not hasattr(te.model.gpt.ln_f, "bias")


def test_ragged_engine_with_rms_norm_matches_jax_engine():
    _, te = _run_both("ragged_rms", {"use_rms_norm": True},
                      dict(page_size=4, num_pages=64, max_slots=4,
                           prefill_chunk=6, prefill_token_budget=12),
                      _chunked_prefix, ragged=True)
    assert te.stats()["bucketed_launches"] == {"prefill": 0, "chunk": 0,
                                               "decode": 0}
