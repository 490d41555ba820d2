"""The bucketed engine's dense prefill and chunk step as programs.

With ``jit=True`` every bucketed round runs as the program of its shape
key, as in the JAX engine: ``("prefill", nb, sb)``, ``("chunk", nb, sb)``
and ``("decode",)``. On the card each is a CUDA graph; on the CPU, which
these tests run on, the same static-buffer round runs eagerly, over
``gpt_tiny`` with the JAX model's weights carried over:

* program rounds (``jit=True``) equal eager rounds (``jit=False``) bit
  for bit: tokens, every captured logit row and every KV pool, the zero
  tails of last pages included; both give the JAX bucketed engine's
  greedy tokens;
* the programs installed are the JAX engine's keys, and each one ran
  through its own static-buffer program;
* the prefill's device-side page write equals ``write_prefill`` row by
  row, and puts only zeros on the scrap page;
* ``PADDLE_TPU_SERVING_RAGGED`` picks the engine when ``ragged`` is left
  None.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import ServingEngine, gpt_tiny, params_from_paddle_tpu
from paddle_tpu_torch.serving import PagedKVCache


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


def _dense_then_prefix(eng, rng):
    # three misses admitted together (batch buckets 2 and 1 at seq 16, one
    # at 32), a fourth alone, then a prefix hit whose tail takes the chunk
    # step; a 16-token prompt fills its pages exactly, so its extra page
    # is zeroed whole
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (11, 20, 16)]
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.step()
    reqs.append(eng.submit(rng.randint(1, 256, size=9).tolist(),
                           max_new_tokens=4))
    eng.run_until_idle()
    reqs.append(eng.submit(prompts[1][:12] + [3, 4, 5], max_new_tokens=4))
    eng.run_until_idle()
    return reqs


def _chunked(eng, rng):
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (11, 3, 9)]
    reqs = [eng.submit(prompts[0], max_new_tokens=5)]
    eng.step()
    reqs += [eng.submit(p, max_new_tokens=5) for p in prompts[1:]]
    eng.run_until_idle()
    reqs.append(eng.submit(prompts[0], max_new_tokens=3))
    eng.run_until_idle()
    return reqs


SCENARIOS = {
    "dense_and_prefix_tail": ({}, dict(page_size=4, num_pages=64,
                                       max_slots=4), _dense_then_prefix),
    "gqa_dense_and_prefix_tail": ({"num_kv_heads": 2},
                                  dict(page_size=4, num_pages=64,
                                       max_slots=4), _dense_then_prefix),
    "rms_norm_chunked": ({"use_rms_norm": True},
                         dict(page_size=4, num_pages=64, max_slots=4,
                              prefill_chunk=6), _chunked),
    "sampling_dense": ({}, dict(page_size=8, num_pages=48, max_slots=2),
                       None),
}


def _sampling(eng, rng):
    # a sampled request fetches the prefill's logit rows; its draws are
    # seeded from seed + request_id, so both engines' requests get one
    # seed
    reqs = [eng.submit(rng.randint(1, 256, size=13).tolist(),
                       max_new_tokens=4, temperature=0.8, top_k=5),
            eng.submit(rng.randint(1, 256, size=6).tolist(),
                       max_new_tokens=4)]
    reqs[0].seed = 1000 - reqs[0].request_id
    eng.run_until_idle()
    return reqs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_program_rounds_equal_eager_rounds(name):
    model_kw, eng_kw, script = SCENARIOS[name]
    script = script or _sampling
    jm, tm = _models(40 + len(name), **model_kw)
    runs = {}
    for jit in (True, False):
        eng = ServingEngine(tm, ragged=False, jit=jit, **eng_kw)
        eng.capture_logits = []
        reqs = script(eng, np.random.RandomState(3))
        runs[jit] = (eng, [r.result(10) for r in reqs])
    (pe, ptok), (ee, etok) = runs[True], runs[False]
    assert ptok == etok
    assert len(pe.capture_logits) == len(ee.capture_logits) > 0
    for (pmap, pl), (emap, el) in zip(pe.capture_logits, ee.capture_logits):
        assert sorted(pmap) == sorted(emap)       # slots (ids differ)
        np.testing.assert_array_equal(pl, el)
    for layer in range(tm.config.num_layers):
        for a, b in ((pe.kv.k, ee.kv.k), (pe.kv.v, ee.kv.v)):
            assert torch.equal(a[layer], b[layer])
    launched = pe.stats()["bucketed_launches"]
    assert launched == ee.stats()["bucketed_launches"]
    # chunked prefill takes every prompt through the chunk step
    assert launched["chunk" if "prefill_chunk" in eng_kw else "prefill"] >= 1
    # every program key ran through its static-buffer program
    assert set(pe._rounds._progs) == pe._programs
    assert ee._rounds._progs == {}
    if script is _sampling:
        return
    je = JaxEngine(jm, attn_backend="xla", ragged=False, **eng_kw)
    jreqs = script(je, np.random.RandomState(3))
    assert [r.result(10) for r in jreqs] == ptok
    assert pe._programs == je._programs
    assert pe.stats()["distinct_programs"] == je.stats()["distinct_programs"]
    if "prefix" in name:
        assert launched["chunk"] >= 1
        assert any(k[0] == "chunk" for k in pe._programs)


def test_prefill_rows_write_equals_write_prefill():
    """The batched device-side page write against ``write_prefill`` row
    by row, over pools holding old values: a row ending mid-page, one
    filling its pages and owning one more (zeroed whole), a pad row; the
    scrap page receives zeros only."""
    rng = np.random.RandomState(0)
    page, P, S = 4, 3, 8
    rows = [(5, [6, 2]), (8, [3, 7, 1]), (0, [])]
    kn, vn = (torch.from_numpy(rng.randn(3, S, 2, 8).astype(np.float32))
              for _ in range(2))
    want = PagedKVCache(2, 10, page, 2, 8, device="cpu")
    got = PagedKVCache(2, 10, page, 2, 8, device="cpu")
    for kv in (want, got):
        for pools in (kv.k, kv.v):
            pools[1].copy_(torch.from_numpy(
                np.random.RandomState(1).randn(10, page, 2, 8)))
    bt = torch.zeros(3, P, dtype=torch.int32)
    for i, (n, pages) in enumerate(rows):
        bt[i, :len(pages)] = torch.tensor(pages)
        if pages:
            want.write_prefill(1, kn[i], vn[i], pages, n)
    scrap = want.k[1][0].clone()
    got.write_prefill_rows(1, kn, vn, bt, torch.tensor([n for n, _ in rows]))
    for a, b in ((got.k, want.k), (got.v, want.v)):
        assert torch.equal(a[0], b[0])            # layer 0 untouched
        assert torch.equal(a[1][1:], b[1][1:])    # every owned page
        assert (a[1][0] == 0).all()               # scrap: zeros only
    assert not (scrap == 0).all()
    assert (got.k[1][1] == 0).all() and (got.k[1][2, 1:] == 0).all()


@pytest.mark.parametrize("value,ragged", [(None, True), ("1", True),
                                          ("0", False), ("false", False),
                                          ("off", False)])
def test_ragged_switch_reads_the_environment(monkeypatch, value, ragged):
    """``ragged=None`` reads ``PADDLE_TPU_SERVING_RAGGED`` as the JAX
    engine does; an explicit ``ragged`` wins."""
    if value is None:
        monkeypatch.delenv("PADDLE_TPU_SERVING_RAGGED", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_SERVING_RAGGED", value)
    _, tm = _models(50)
    kw = dict(page_size=4, num_pages=16, max_slots=2)
    assert ServingEngine(tm, **kw).ragged is ragged
    assert ServingEngine(tm, ragged=not ragged, **kw).ragged is not ragged
    if ragged is False:
        eng = ServingEngine(tm, **kw)
        eng.generate([5, 6, 7], max_new_tokens=2)
        assert eng.stats()["bucketed_launches"]["prefill"] == 1
