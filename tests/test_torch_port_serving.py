"""The port's ServingEngine vs the JAX package's, on the same weights.

Both engines serve the same request script (ragged path, f32 on the CPU;
the port's kernel wrappers take their plain versions there). Greedy tokens
must be identical and every round's captured decode logits must agree
within ``rtol 2e-3 / atol 2e-4`` (``tests/test_serving_parity.py``).
The scenarios cover page-boundary crossing, chunked prefill with chunk
boundaries mid-page, a prefix-cache hit, GQA pools and eviction with
recompute-on-readmit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import ServingEngine, gpt_tiny, params_from_paddle_tpu

RTOL, ATOL = 2e-3, 2e-4


def _models(seed, **kw):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.eval()
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_paddle_tpu(arrays, gpt_tiny(**kw), device="cpu")


def _page_boundary(eng, rng):
    # 11-token prompt + 8 new on page 4: crosses three page boundaries
    return [eng.submit(rng.randint(1, 256, size=11).tolist(),
                       max_new_tokens=8)], eng.run_until_idle()


def _chunked_prefix(eng, rng):
    # chunk 6 on page 4 (chunk boundaries mid-page), staggered admission
    # so decodes share launches with chunk segments, then a prefix hit
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (11, 12, 3, 9)]
    reqs = [eng.submit(prompts[0], max_new_tokens=6)]
    eng.step()
    reqs += [eng.submit(p, max_new_tokens=6) for p in prompts[1:]]
    eng.run_until_idle()
    reqs.append(eng.submit(prompts[0], max_new_tokens=6))
    return reqs, eng.run_until_idle()


def _gqa_prefix(eng, rng):
    prompt = rng.randint(1, 256, size=11).tolist()
    r1 = eng.submit(prompt, max_new_tokens=8)
    eng.run_until_idle()
    r2 = eng.submit(prompt, max_new_tokens=8)       # prefix-shared twin
    return [r1, r2], eng.run_until_idle()


def _eviction(eng, rng):
    # 5 usable pages of 4: two requests growing to 15-16 tokens cannot
    # coexist, so one is evicted and recomputed on readmission
    r1 = eng.submit(rng.randint(1, 256, size=7).tolist(), max_new_tokens=8)
    r2 = eng.submit(rng.randint(1, 256, size=6).tolist(), max_new_tokens=8)
    return [r1, r2], eng.run_until_idle()


SCENARIOS = {
    "page_boundary": (_page_boundary, {},
                      dict(page_size=4, num_pages=32, max_slots=2)),
    "chunked_mid_page_prefix_hit": (
        _chunked_prefix, {},
        dict(page_size=4, num_pages=64, max_slots=4, prefill_chunk=6,
             prefill_token_budget=12)),
    "gqa_chunked_prefix_hit": (
        _gqa_prefix, {"num_kv_heads": 2},
        dict(page_size=4, num_pages=32, max_slots=2, prefill_chunk=6)),
    "eviction_readmission": (_eviction, {},
                             dict(page_size=4, num_pages=6, max_slots=2)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_engine_matches_jax_engine(name):
    script, model_kw, eng_kw = SCENARIOS[name]
    jm, tm = _models(100 + len(name), **model_kw)
    runs = []
    for eng in (JaxEngine(jm, attn_backend="xla", **eng_kw),
                ServingEngine(tm, **eng_kw)):
        eng.capture_logits = []
        reqs, _ = script(eng, np.random.RandomState(7))
        runs.append((eng, [r.result(10) for r in reqs]))
    (je, jtok), (te, ttok) = runs
    assert ttok == jtok
    assert all(len(t) == r.max_new_tokens for t, r in zip(ttok, reqs))
    assert len(te.capture_logits) == len(je.capture_logits) > 0
    for (jmap, jl), (tmap, tl) in zip(je.capture_logits, te.capture_logits):
        assert sorted(tmap) == sorted(jmap)
        for slot in tmap:
            np.testing.assert_allclose(tl[slot], jl[slot], rtol=RTOL,
                                       atol=ATOL)
    js, ts = je.stats(), te.stats()
    for key in ("prefix_hits", "prefix_hit_tokens", "evictions",
                "prefill_chunk_tokens", "decode_tokens"):
        assert ts[key] == js[key], key
    if "prefix" in name:
        assert ts["prefix_hits"] >= 1
    if name == "eviction_readmission":
        assert ts["evictions"] >= 1
    if model_kw.get("num_kv_heads"):
        assert te.kv.k[0].shape[2] == model_kw["num_kv_heads"]
    assert te.kv.allocator.used_pages == 0


def test_port_engine_metrics_count_the_run():
    """The port's serving metrics land in a registry handed to the engine:
    tokens, requests, TTFT samples and prefix counters match the run."""
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    _, tm = _models(7)
    reg = MetricsRegistry()
    eng = ServingEngine(tm, page_size=4, num_pages=32, max_slots=2,
                        prefill_chunk=6, registry=reg, engine_id="e0")
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 256, size=9).tolist()
    reqs = [eng.submit(prompt, max_new_tokens=5)]
    eng.run_until_idle()
    reqs.append(eng.submit(prompt, max_new_tokens=5))    # prefix hit
    eng.run_until_idle()
    snap = reg.snapshot()
    c, h = snap["counters"], snap["histograms"]
    assert c["serving_tokens_total{engine=e0}"] == 10
    assert c["serving_requests_total{engine=e0,status=ok}"] == 2
    assert c["serving_prefix_hits_total{engine=e0}"] == 1
    assert c["serving_prefix_misses_total{engine=e0}"] == 1
    assert c["serving_prefill_chunk_tokens_total{engine=e0}"] == 9 + 1
    assert h["serving_ttft_ms{engine=e0}"]["count"] == 2
    assert h["serving_inter_token_ms{engine=e0}"]["count"] == 8
    assert [len(r.result(1)) for r in reqs] == [5, 5]


@pytest.mark.parametrize("interleave", [True, False])
def test_session_prompts_equal_jaxs(interleave):
    """``serving.make_session_prompts`` (the fleet workload) gives JAX's
    prompts and session ids for the same seed."""
    from paddle_tpu.serving import make_session_prompts as jax_sessions
    from paddle_tpu_torch.serving import make_session_prompts
    args = (3, 4, 6, (2, 5), 97)
    for seed in (0, 11):
        got = make_session_prompts(*args, seed=seed, interleave=interleave)
        want = jax_sessions(*args, seed=seed, interleave=interleave)
        assert got == want
    prompts, sids = got
    assert len(prompts) == 12 and sorted(set(sids)) == [0, 1, 2]
    heads = {s: p[:6] for p, s in zip(prompts, sids)}
    assert all(p[:6] == heads[s] for p, s in zip(prompts, sids))
