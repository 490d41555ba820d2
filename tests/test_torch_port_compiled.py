"""The port's program-per-shape serving layer against the JAX engine's.

In the JAX engine each round is one compiled program per shape, and every
shape-specialised program is noted once (``serving_compiles_total``,
``serving_distinct_programs``, ``stats()["distinct_programs"]``). The
port's counterpart (``paddle_tpu_torch/serving/compiled.py``) captures a
CUDA graph per shape on the card; on the CPU the same static-buffer round
runs eagerly, which is what these tests drive, on ``gpt_tiny`` with the
JAX model's weights carried over:

* the program accounting equals the JAX engine's on the same scripts,
  on the ragged and the bucketed engine, and a repeat adds nothing;
* a script whose token pads go 8 -> 64 -> 8 -> 32, with a prefix hit and
  an eviction, gives the JAX engine's greedy tokens and decode logits
  within ``rtol 2e-3 / atol 2e-4`` (``tests/test_serving_parity.py``),
  through the static buffers (``jit=True``) and eagerly (``jit=False``);
* the engine's ragged split scratch covers the kernel's launch plan at
  every token pad it can run, and the KV pools keep their addresses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability import metrics as jax_obsm
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, ServingEngine,
                              gpt_tiny, params_from_paddle_tpu)
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.ops.kernels.paged_attention import owned_scratch
from paddle_tpu_torch.ops.kernels.ragged_attention import launch_plan

RTOL, ATOL = 2e-3, 2e-4


def _models(seed):
    """The JAX ``gpt_tiny`` with non-zero biases, and the port's model
    holding the same weights (on the CPU)."""
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_paddle_tpu(arrays, gpt_tiny(), device="cpu")


def _scripts():
    """The two scripts of the JAX package's compile-counter test
    (``tests/test_serving.py``): -> {engine kind: (engine kwargs, list of
    (prompt, max_new_tokens) served one after the other)}."""
    return {
        "ragged": (dict(prefill_chunk=6),
                   [([7] * 11, 4), ([9] * 11, 4)]),
        "bucketed": (dict(ragged=False, prefill_seq_buckets=[8, 16],
                          prefill_batch_buckets=[1, 2]),
                     [([7] * 5, 2), ([7] * 11, 2), ([7] * 5, 2),
                      ([7] * 11, 2)]),
    }


def _compiles(snap):
    return (snap["counters"].get("serving_compiles_total"),
            snap["gauges"].get("serving_distinct_programs"))


@pytest.mark.parametrize("kind", ["ragged", "bucketed"])
def test_program_accounting_matches_jax_engine(kind):
    """``distinct_programs``, ``serving_compiles_total``,
    ``serving_distinct_programs`` and ``ragged_token_pads`` equal the JAX
    engine's after every request of the script; the script's second half
    repeats the first at the same shapes and installs nothing new."""
    eng_kw, script = _scripts()[kind]
    kw = dict(page_size=4, num_pages=32, max_slots=2, **eng_kw)
    jm, tm = _models(31)
    jreg = jax_obsm.enable(out_dir=None, interval_s=0)
    try:
        je = JaxEngine(jm, attn_backend="xla", registry=jreg, **kw)
        treg = MetricsRegistry()
        te = ServingEngine(tm, registry=treg, **kw)
        seen = []
        for prompt, new in script:
            assert te.generate(prompt, max_new_tokens=new) \
                == je.generate(prompt, max_new_tokens=new)
            js, ts = je.stats(), te.stats()
            assert ts["distinct_programs"] == js["distinct_programs"]
            assert ts["ragged_token_pads"] == js["ragged_token_pads"]
            assert _compiles(treg.snapshot()) == _compiles(jreg.snapshot())
            seen.append(ts["distinct_programs"])
    finally:
        jax_obsm.disable()
    half = len(script) // 2
    assert seen[half:] == [seen[half - 1]] * (len(seen) - half)
    ts = te.stats()
    if kind == "ragged":
        assert ts["distinct_programs"] == len(ts["ragged_token_pads"]) >= 1
        assert set(te._programs) == {("ragged", p)
                                     for p in ts["ragged_token_pads"]}
    else:
        # (1, 8) + (1, 16) prefill programs + the decode step
        assert ts["ragged_token_pads"] == [] and ts["distinct_programs"] == 3
        assert ("decode",) in te._programs
    assert _compiles(treg.snapshot()) == (ts["distinct_programs"],) * 2
    assert ts["graphs"] == 0 and ts["jit"]      # no graphs on the CPU


def _pad_script(eng, rng):
    """A 5-token prompt (pad 8), a 40-token prompt beside its decode (pad
    64), decode rounds (pad 8), then a prompt sharing the 40-token one's
    first 16 tokens (a prefix hit) with a 20-token tail (pad 32) beside a
    third request; 14 pages of 4 force evictions and a readmission."""
    a = eng.submit(rng.randint(1, 256, size=5).tolist(), max_new_tokens=12)
    eng.step()
    b_prompt = rng.randint(1, 256, size=40).tolist()
    b = eng.submit(b_prompt, max_new_tokens=6)
    eng.run_until_idle()
    c = eng.submit(b_prompt[:16] + rng.randint(1, 256, size=20).tolist(),
                   max_new_tokens=8)
    d = eng.submit(rng.randint(1, 256, size=6).tolist(), max_new_tokens=8)
    eng.run_until_idle()
    return [a, b, c, d]


@pytest.mark.parametrize("jit", [True, False])
def test_static_buffers_match_jax_engine_across_pads(jit):
    """Each pad's static input is rewritten in full every round: a small
    pad after a large one reads no stale entry, so tokens and logits
    equal the JAX engine's through 8 -> 64 -> 8 -> 32."""
    jm, tm = _models(11)
    kw = dict(page_size=4, num_pages=14, max_slots=2)
    je = JaxEngine(jm, attn_backend="xla", **kw)
    te = ServingEngine(tm, jit=jit, **kw)
    pads, run_round = [], te._ragged_fn

    def recording(*args, **kwargs):
        pads.append(args[0].shape[0])
        return run_round(*args, **kwargs)

    te._ragged_fn = recording
    runs = []
    for eng in (je, te):
        eng.capture_logits = []
        runs.append([r.result(10) for r in _pad_script(
            eng, np.random.RandomState(7))])
    assert runs[1] == runs[0]
    it = iter(pads)
    assert all(p in it for p in (8, 64, 8, 32)), pads
    js, ts = je.stats(), te.stats()
    assert ts["evictions"] == js["evictions"] >= 1
    assert ts["prefix_hits"] == js["prefix_hits"] >= 1
    assert ts["distinct_programs"] == js["distinct_programs"]
    assert len(te.capture_logits) == len(je.capture_logits) > 0
    for (jmap, jl), (tmap, tl) in zip(je.capture_logits, te.capture_logits):
        assert sorted(tmap) == sorted(jmap)
        for slot in tmap:
            np.testing.assert_allclose(tl[slot], jl[slot], rtol=RTOL,
                                       atol=ATOL)
    # one program (static buffers) per pad with jit, none without
    progs = set(te._rounds._progs)
    assert progs == ({("ragged", p) for p in set(pads)} if jit else set())
    assert te.kv.allocator.used_pages == 0


def _wide_model(**kw):
    """One layer, narrow, but 1024 positions: with 16-token pages a row
    spans 64 pages, so the ragged kernel's plan splits its keys."""
    cfg = GPTConfig(vocab_size=64, hidden_size=64, num_layers=1,
                    num_heads=4, max_seq_len=1024, dropout=0.0, **kw)
    return GPTForCausalLM(cfg, device="cpu", seed=0)


@pytest.mark.parametrize("kvh,slots,chunk", [(None, 4, 64), (2, 16, 256),
                                             (1, 3, None)])
def test_ragged_scratch_covers_every_pad(kvh, slots, chunk):
    """The engine's reserved split scratch holds what ``launch_plan``
    asks at every token pad ``warm_ragged`` can list, up to ``max_slots``
    whole ``max_seq_len`` rows (host integers only)."""
    model = _wide_model(num_kv_heads=kvh)
    eng = ServingEngine(model, page_size=16, num_pages=8, max_slots=slots,
                        prefill_chunk=chunk)
    cfg = model.config
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    D = cfg.hidden_size // H
    acc, ml, tickets = eng.ragged_scratch_sizes()
    pads = eng._ragged_pads(slots * cfg.max_seq_len)
    assert pads[0] == 8 and pads[-1] >= slots * cfg.max_seq_len
    split = 0
    for T in pads:
        plan = launch_plan(T, H, KVH, slots, eng.max_pages, 16)
        if plan["n_split"] == 1:
            continue
        split += 1
        assert T * H * plan["n_split"] * D <= acc
        assert T * H * plan["n_split"] * 2 <= ml
        assert plan["n_slots"] * KVH <= tickets
    assert split >= 3
    # the default warm-up list lies inside the covered pads
    assert set(eng.warm_ragged(max_tokens=64)) <= set(pads)


def test_owned_scratch_is_checked_never_replaced():
    need = (10, 4)
    dtypes = (torch.float32, torch.int32)
    ok = [torch.zeros(12), torch.zeros(4, dtype=torch.int32)]
    assert owned_scratch(ok, need, dtypes, torch.device("cpu")) \
        == [t.data_ptr() for t in ok]
    with pytest.raises(ValueError, match="holds 9 elements"):
        owned_scratch([torch.zeros(9), ok[1]], need, dtypes,
                      torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        owned_scratch([ok[0], torch.zeros(4)], need, dtypes,
                      torch.device("cpu"))


@pytest.mark.parametrize("ragged", [True, False])
def test_pools_keep_their_addresses(ragged):
    """Graphs write the KV pools in place: no round, warm-up, prefill or
    eviction rebinds ``kv.k[i]`` / ``kv.v[i]``."""
    _, tm = _models(11)
    eng = ServingEngine(tm, page_size=4, num_pages=14, max_slots=2,
                        ragged=ragged)
    ptrs = [t.data_ptr() for t in eng.kv.k + eng.kv.v]
    eng.warm_ragged()
    reqs = _pad_script(eng, np.random.RandomState(7))
    assert all(len(r.result(10)) == r.max_new_tokens for r in reqs)
    assert eng.stats()["evictions"] >= 1
    assert [t.data_ptr() for t in eng.kv.k + eng.kv.v] == ptrs
