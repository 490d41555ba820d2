"""The port's serving fleet against the JAX package's, on the CPU.

Each test mirrors the non-slow test of ``tests/test_serving_fleet.py``
it names: the same scenario runs once in each package (the JAX engines
eagerly on the ``xla`` backend, the port's on its kernels' plain
versions), both on ``gpt_tiny`` with the same weights (carried by
``params_from_paddle_tpu``, ``dropout=0``) at page 4, 32 pages, 2 slots,
and the JAX test's assertions hold in both. The two runs must then agree
exactly on what the scenario returns: greedy tokens, the router's
counters (dispatched, redispatched, saturated, affinity hits, hedges,
aborts, prefetched pages), the engines' itineraries, registry records
and metric rows. Where KV values are compared across the packages (the
published pages), the tolerance is f32 ``rtol 1e-4 / atol 1e-5``.

Beyond the mirrored cases: a page payload crosses between the packages
byte for byte both ways, and an import writes the pools in place.
"""
import json
import socket
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.serving as jserving
import paddle_tpu.serving.fleet as jfleet
import paddle_tpu_torch.distributed as pdist
import paddle_tpu_torch.serving as pserving
import paddle_tpu_torch.serving.fleet as pfleet
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.distributed import fault as jfault
from paddle_tpu.distributed import keyspace as jkeyspace
from paddle_tpu.distributed import tcp_store as jtcp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import report as jreport
from paddle_tpu_torch import gpt_tiny, params_from_paddle_tpu
from paddle_tpu_torch.distributed import elastic as pelastic
from paddle_tpu_torch.distributed import fault as pfault
from paddle_tpu_torch.distributed import keyspace as pkeyspace
from paddle_tpu_torch.distributed import tcp_store as ptcp
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import report as preport
from paddle_tpu_torch.observability import tracing as ptracing

RTOL, ATOL = 1e-4, 1e-5
ENG = dict(page_size=4, num_pages=32, max_slots=2)
FAULT_ENV = ("PADDLE_TPU_FAULTS", "PADDLE_TPU_FAULT_ENGINE",
             "PADDLE_TPU_FAULT_ENGINE_STALL_S", "PADDLE_TPU_FAULT_LEDGER")


@pytest.fixture(autouse=True)
def _process_state(monkeypatch):
    """Both packages' process-wide planes (metrics, tracing, faults, the
    preemption flag) at their defaults around every test."""
    for var in FAULT_ENV:
        monkeypatch.delenv(var, raising=False)

    def reset():
        pmetrics._reset_state()
        ptracing._reset_state()
        jmetrics.disable()
        for f in (pfault, jfault):
            f.set_fault_spec(None)
            f._preempt_event.clear()
    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    rng = np.random.RandomState(7)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_paddle_tpu(arrays, gpt_tiny(), device="cpu")


def _pkg(which, model):
    """One package's fleet surface, for a scenario written once."""
    if which == "jax":
        return SimpleNamespace(
            name="jax", model=model, serving=jserving, fleet=jfleet,
            dist=jdist, tcp=jtcp, keyspace=jkeyspace, fault=jfault,
            elastic=jelastic, metrics=jmetrics, report=jreport,
            engine_kw=dict(attn_backend="xla", jit=False), kv_kw={})
    return SimpleNamespace(
        name="port", model=model, serving=pserving, fleet=pfleet,
        dist=pdist, tcp=ptcp, keyspace=pkeyspace, fault=pfault,
        elastic=pelastic, metrics=pmetrics, report=preport,
        engine_kw={}, kv_kw=dict(device="cpu"))


def _engine(P, **kw):
    return P.serving.ServingEngine(P.model,
                                   **{**ENG, **P.engine_kw, **kw})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _store(P, port, **kw):
    return P.tcp.TCPStore("127.0.0.1", port, **kw)


def _drive(*engines, until=None, max_steps=200):
    """Step every engine round-robin until ``until()`` (or idle)."""
    for _ in range(max_steps):
        for e in engines:
            if not e._closed:
                e.step()
        if until is not None:
            if until():
                return
        elif not any(e.scheduler.has_work() for e in engines
                     if not e._closed):
            return
    raise AssertionError("fleet did not converge within max_steps")


def _both(models, scenario):
    """``scenario(P)`` in the JAX package, then in the port -> both
    results, which must be equal."""
    jm, tm = models
    got_jax = scenario(_pkg("jax", jm))
    got_port = scenario(_pkg("port", tm))
    assert got_port == got_jax, (got_port, got_jax)
    return got_jax


def _solo(P, prompt, n, **kw):
    solo = _engine(P, **kw)
    out = solo.generate(prompt, max_new_tokens=n)
    solo.close()
    return out


# ---------------------------------------------------------------- workload

def test_make_session_prompts_deterministic_and_interleaved():
    def sc(P):
        p1, s1 = P.serving.make_session_prompts(
            3, 4, head_len=8, tail_len=(2, 5), vocab=100, seed=5)
        p2, s2 = P.serving.make_session_prompts(
            3, 4, head_len=8, tail_len=(2, 5), vocab=100, seed=5)
        assert p1 == p2 and s1 == s2
        assert len(p1) == 12 and s1[:3] == [0, 1, 2]
        heads = {}
        for p, s in zip(p1, s1):
            heads.setdefault(s, p[:8])
            assert p[:8] == heads[s]
        assert len({tuple(h) for h in heads.values()}) == 3
        assert p1[0] != p1[3]
        return p1, s1
    _both((None, None), sc)


def test_summarize_by_engine_breakdown():
    class R:
        def __init__(self, eng, toks, err=None):
            self.error = err
            self.t_done = 1.0 if err is None else None
            self.t_submit = 0.0
            self.generated = toks
            self.queue_wait_s = 0.0
            self.evictions = 0
            self.engine_id = eng
            self.redispatches = 1 if err else 0
            self.migrations = 0

        def ttft_s(self):
            return 0.1

        def inter_token_s(self):
            return [0.01] * max(0, len(self.generated) - 1)

    def sc(P):
        reqs = [R("e0", [1, 2]), R("e0", [3]), R("e1", [4, 5, 6]),
                R("e1", [], err=RuntimeError("x"))]
        out = P.serving.summarize_requests(reqs, 1.0, by_engine=True)
        by = out["by_engine"]
        assert by["e0"]["requests_ok"] == 2 and by["e0"]["tokens"] == 3
        assert by["e1"]["requests_ok"] == 1 and by["e1"]["tokens"] == 3
        assert by["e1"]["requests_failed"] == 1
        assert by["e1"]["redispatches"] == 1
        assert out["requests_failed"] == 1
        return out
    _both((None, None), sc)


def test_poisson_load_drives_a_router_with_shared_prefix(models):
    """``run_poisson_load(shared_prefix=, by_engine=)`` through a started
    router (its ``cfg`` and ``submit``): every request lands with the
    tokens a lone engine gives its prompt (the JAX package's prompts for
    the seed), and the rows split by engine."""
    _, tm = models
    P = _pkg("port", tm)
    a = _engine(P, engine_id="e0", max_queue=16)
    b = _engine(P, engine_id="e1", max_queue=16)
    r = P.fleet.FleetRouter()
    r.add_engine(a, "e0")
    r.add_engine(b, "e1")
    sent = []
    submit = r.submit

    def recording_submit(prompt, **kw):
        sent.append(submit(prompt, **kw))
        return sent[-1]

    r.submit = recording_submit
    r.start()
    try:
        out = P.serving.run_poisson_load(
            r, n_requests=6, qps=200.0, prompt_len=(2, 5),
            max_new_tokens=3, seed=3, timeout=60.0, shared_prefix=8,
            by_engine=True)
    finally:
        r.close()
    assert out["requests_ok"] == 6 and out["tokens"] == 18
    rows = out["by_engine"]
    assert set(rows) <= {"e0", "e1"}
    assert sum(v["requests_ok"] for v in rows.values()) == 6
    prompts = jserving.make_shared_prefix_prompts(6, (2, 5), 256, 8, seed=3)
    assert [f.prompt_ids for f in sent] == prompts
    for f in sent:
        assert f.result(1) == _solo(P, f.prompt_ids, 3)


# ------------------------------------------------------------------ router

def test_router_least_loaded_balancing_and_affinity(models):
    def sc(P):
        a = _engine(P, engine_id="e0")
        b = _engine(P, engine_id="e1")
        r = P.fleet.FleetRouter()
        r.add_engine(a, "e0")
        r.add_engine(b, "e1")
        rng = np.random.RandomState(0)
        reqs = [r.submit(rng.randint(1, 250, 6).tolist(), max_new_tokens=1)
                for _ in range(6)]
        assert {q.engine_id for q in reqs} == {"e0", "e1"}
        _drive(a, b)
        toks = [q.result(10) for q in reqs]
        assert all(len(t) == 1 for t in toks)
        head = rng.randint(1, 250, 5).tolist()
        s = [r.submit(head + [i], max_new_tokens=1) for i in (1, 2, 3)]
        assert s[0].engine_id == s[1].engine_id == s[2].engine_id
        _drive(a, b)
        st = r.stats()
        assert st["affinity_hits"] >= 2
        a.close()
        b.close()
        return ([q.engine_id for q in reqs], toks,
                [q.engine_id for q in s], [q.result(10) for q in s],
                {k: st[k] for k in ("dispatched", "affinity_hits",
                                    "affinity_sessions", "saturated")})
    _both(models, sc)


def test_router_backpressure_fleet_saturated(models):
    def sc(P):
        a = _engine(P, engine_id="e0", max_queue=1)
        b = _engine(P, engine_id="e1", max_queue=1)
        r = P.fleet.FleetRouter()
        r.add_engine(a, "e0")
        r.add_engine(b, "e1")
        frs = [r.submit([1, 2, 3], max_new_tokens=2, block=False)
               for _ in range(2)]
        with pytest.raises(P.fleet.FleetSaturated):
            r.submit([4, 5, 6], max_new_tokens=2, block=False)
        assert issubclass(P.fleet.FleetSaturated, P.serving.QueueFull)
        _drive(a, b)
        a.close()
        b.close()
        return ([f.engine_id for f in frs], [f.result(10) for f in frs],
                r.saturated, r.dispatched)
    _both(models, sc)


def test_router_engine_crash_redispatch_token_identical(models):
    def sc(P):
        prompt = np.random.RandomState(3).randint(1, 250, 9).tolist()
        base = _solo(P, prompt, 6)
        a = _engine(P, engine_id="e0")
        b = _engine(P, engine_id="e1")
        r = P.fleet.FleetRouter()
        r.add_engine(a, "e0")
        r.add_engine(b, "e1")
        fr = r.submit(prompt, max_new_tokens=6, engine="e0")
        a.step()
        a.step()
        assert 0 < len(fr.generated) < 6
        before = list(fr.generated)
        a.close()
        _drive(b, until=fr.done)
        assert fr.result(10) == base
        assert fr.engine_ids == ["e0", "e1"] and fr.redispatches == 1
        b.close()
        return base, before, fr.engine_ids, r.redispatched, r.dispatched
    _both(models, sc)


def test_router_shutdown_drain_redispatches_queued(models):
    def sc(P):
        rng = np.random.RandomState(4)
        prompt = rng.randint(1, 250, 9).tolist()
        base = _solo(P, prompt, 6)
        a = _engine(P, engine_id="e0")
        b = _engine(P, engine_id="e1")
        r = P.fleet.FleetRouter()
        r.add_engine(a, "e0")
        r.add_engine(b, "e1")
        inflight = r.submit(prompt, max_new_tokens=6, engine="e0")
        a.step()
        a.step()
        pre = list(inflight.generated)
        assert pre
        queued = [r.submit(rng.randint(1, 250, 5).tolist(),
                           max_new_tokens=2, engine="e0") for _ in range(3)]
        out = r.remove_engine("e0", migrate=True)
        assert "migrated" in out.values()
        _drive(b)
        assert inflight.result(10) == base
        assert inflight.migrations == 1
        assert inflight.engine_ids == ["e0", "e1"]
        for q in queued:
            assert len(q.result(10)) == 2
            assert q.engine_ids == ["e0", "e1"] and q.redispatches == 1
        assert not a.scheduler.has_work()
        b.close()
        return (base, pre, sorted(out.values()),
                [q.result(10) for q in queued], r.migrations,
                r.redispatched, r.dispatched)
    _both(models, sc)


# --------------------------------------------------------------- migration

def test_migrate_fallback_recompute_when_target_full(models):
    def sc(P):
        rng = np.random.RandomState(8)
        prompt = rng.randint(1, 250, 9).tolist()
        base = _solo(P, prompt, 6)
        src = _engine(P, engine_id="s")
        dst = _engine(P, engine_id="d", max_slots=1)
        blocker = dst.submit(rng.randint(1, 250, 5).tolist(),
                             max_new_tokens=12)
        dst.step()
        req = src.submit(prompt, max_new_tokens=6)
        src.step()
        src.step()
        assert P.fleet.migrate_request(src, dst, req) == "recompute"
        assert req.num_cached == 0 and req.state == "waiting"
        _drive(dst)
        assert req.result(20) == base
        out = blocker.result(10)
        src.close()
        dst.close()
        return base, out
    _both(models, sc)


def test_disagg_roles_migrate_after_prefill(models):
    def sc(P):
        rng = np.random.RandomState(9)
        prompts = [rng.randint(1, 250, n).tolist() for n in (5, 9, 7)]
        solo = _engine(P)
        base = [solo.generate(p, max_new_tokens=5) for p in prompts]
        solo.close()
        pf = _engine(P, engine_id="pf")
        dc = _engine(P, engine_id="dc")
        r = P.fleet.FleetRouter()
        r.add_engine(pf, "pf", role="prefill")
        r.add_engine(dc, "dc", role="decode")
        frs = [r.submit(p, max_new_tokens=5) for p in prompts]
        _drive(pf, dc, until=lambda: all(f.done() for f in frs))
        assert [f.result(10) for f in frs] == base
        assert all(f.migrations == 1 and f.engine_ids == ["pf", "dc"]
                   for f in frs)
        assert pf._decode_tokens == 0 and dc._decode_tokens > 0
        assert r.stats()["migrations"] == 3
        pf.close()
        dc.close()
        return base, dc._decode_tokens, r.stats()["migrations"]
    _both(models, sc)


# -------------------------------------------------- cross-engine page share

def _payload_f32(P, cache, page):
    """A page's payload as f32 numpy, whichever package's pools."""
    raw = cache._page_payload(page)
    kv = cache.kv
    shape = (2, kv.num_layers, kv.page_size, kv.num_heads, kv.head_dim)
    return np.frombuffer(raw, np.float32).reshape(shape).copy()


def test_page_share_remote_hit_skips_prefill_and_parity(models):
    """A head published by engine A is imported by engine B, whose first
    request then decodes token-identically with the head's prefill
    skipped; the published pages' K/V agree across the packages within
    f32 ``rtol 1e-4 / atol 1e-5``."""
    pages = {}

    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        shA = P.fleet.PageShareClient(_store(P, port), "A", job="t1")
        shB = P.fleet.PageShareClient(_store(P, port), "B", job="t1")
        ea = _engine(P, engine_id="A", page_share=shA)
        eb = _engine(P, engine_id="B", page_share=shB)
        head = np.random.RandomState(10).randint(1, 250, 8).tolist()
        ta = ea.generate(head + [7, 8, 9], max_new_tokens=4)
        assert shA.published == 2
        pages[P.name] = [_payload_f32(P, ea.prefix, p)
                         for p in sorted(ea.prefix._published)]
        req = eb.submit(head + [7, 8, 9], max_new_tokens=4)
        eb.step()
        assert req.prefix_hit_tokens == 8
        assert shB.remote_hits == 1 and shB.remote_hit_tokens == 8
        _drive(eb)
        assert req.result(10) == ta
        st = eb.stats()
        assert st["prefix_remote_hits"] == 1
        assert st["prefix_hit_tokens"] == 8
        ea.close()
        eb.close()
        del master
        return (ta, st["prefix_remote_hits"], st["prefix_hit_tokens"],
                st["prefix_published_pages"],
                ea.stats()["prefix_published_pages"])
    _both(models, sc)
    for got, want in zip(pages["port"], pages["jax"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_page_share_reclaim_invalidates_store_index():
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        sh = P.fleet.PageShareClient(_store(P, port), "A", job="t2")
        kv = P.serving.PagedKVCache(1, 6, 4, 2, 4, **P.kv_kw)
        pc = P.fleet.SharedPrefixCache(kv, 4, sh)
        prompt = list(range(100, 108))
        pages = kv.allocator.alloc(2)
        pc.insert(prompt, pages)
        assert sh.published == 2
        h0 = pc._published[pages[0]]
        assert sh.store.check(f"{sh.prefix}/idx/{h0}")
        kv.allocator.free(pages)
        got = kv.allocator.alloc(5)
        assert pc.indexed_pages() == 0
        assert sh.drain_unpublish()
        assert not sh.store.check(f"{sh.prefix}/idx/{h0}")
        assert sh.unpublished == 2
        shB = P.fleet.PageShareClient(_store(P, port), "B", job="t2")
        assert shB.fetch(h0) is None
        kv.allocator.free(got)
        pages = kv.allocator.alloc(1)
        pc.insert(prompt[:4], pages)
        assert sh.published == 3
        pc.clear()
        assert sh.unpublished == 3
        kv.allocator.free(pages)
        del master
        return h0, sh.published, sh.unpublished, shB.stale_misses
    _both((None, None), sc)


# ------------------------------------------------- metrics + registry rows

def test_metrics_engine_label_families(models):
    def sc(P):
        reg = P.metrics.enable(out_dir=None, interval_s=0)
        try:
            a = _engine(P, engine_id="e0", registry=reg)
            b = _engine(P, engine_id="e1", registry=reg)
            a.generate([3, 1, 4, 1], max_new_tokens=3)
            b.generate([3, 1, 4, 1], max_new_tokens=2)
            snap = reg.snapshot()
            c = snap["counters"]
            assert c["serving_tokens_total{engine=e0}"] == 3
            assert c["serving_tokens_total{engine=e1}"] == 2
            assert c["serving_requests_total{engine=e0,status=ok}"] == 1
            assert snap["histograms"]["serving_ttft_ms{engine=e0}"][
                "count"] == 1
            assert "serving_active_slots{engine=e1}" in snap["gauges"]
            u = _engine(P, registry=reg)
            u.generate([9, 9], max_new_tokens=1)
            snap = reg.snapshot()
            assert snap["counters"]["serving_tokens_total"] == 1
            a.close()
            b.close()
            u.close()
            return {k: v for k, v in snap["counters"].items()
                    if k.startswith("serving_")}
        finally:
            P.metrics.disable()
    _both(models, sc)


def test_report_serving_per_engine_section():
    def sc(P):
        reg = P.metrics.MetricsRegistry(rank=0)
        for eng, n in (("e0", 4), ("e1", 2)):
            for i in range(n):
                reg.histogram("serving_ttft_ms", engine=eng).observe(
                    10.0 * (i + 1))
                reg.histogram("serving_inter_token_ms",
                              engine=eng).observe(2.0)
            reg.counter("serving_tokens_total", engine=eng).inc(10 * n)
            reg.counter("serving_requests_total", engine=eng,
                        status="ok").inc(n)
        rep = P.report.build_run_report({0: [reg.snapshot()]})
        srv = rep["serving"]
        assert set(srv) == {"e0", "e1"}
        assert srv["e0"]["tokens"] == 40 and srv["e1"]["tokens"] == 20
        assert srv["e0"]["requests_ok"] == 4
        assert srv["e0"]["ttft_ms_count"] == 4
        assert srv["e0"]["ttft_ms_p99"] is not None
        text = P.report.format_run_report(rep)
        assert "serving engines" in text and "e0" in text
        return srv
    _both((None, None), sc)


def test_engine_registry_liveness_over_store():
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        reg = P.fleet.EngineRegistry(_store(P, port), job="t3", ttl=0.6)
        reg.register("e0", heartbeat=True, extra={"x": 1})
        reg.register("e1", heartbeat=False)
        joined = reg.joined()
        assert joined == ["e0", "e1"]
        live = reg.engines()
        assert set(live) == {"e0", "e1"} and live["e0"]["x"] == 1
        time.sleep(0.9)
        live2 = reg.engines()
        assert "e0" in live2 and "e1" not in live2
        reg.deregister("e0")
        gone = reg.record("e0")
        assert gone["role"] == "gone"
        reg.close()
        del master
        return (joined, sorted(live), sorted(live2),
                {k: v for k, v in live["e0"].items()
                 if k not in ("ts", "pid")}, gone)
    _both((None, None), sc)


# ------------------------------------------- abort + hedging

def test_engine_abort_frees_slot_and_pages(models):
    def sc(P):
        base = _solo(P, [1, 2, 3, 4], 4)
        e = _engine(P)
        alloc = e.kv.allocator
        fired = []
        victim = e.submit([5, 6, 7, 8, 9], max_new_tokens=8,
                          on_done=lambda r: fired.append("victim"))
        keeper = e.submit([1, 2, 3, 4], max_new_tokens=4,
                          on_done=lambda r: fired.append("keeper"))
        e.step()
        e.step()
        assert victim.state == "active" and victim.pages
        pages = list(victim.pages)
        used_before = alloc.used_pages
        assert e.abort_request(victim) is True
        assert victim.state == "aborted"
        assert victim.slot is None and not victim.pages
        assert all(alloc.refcount(p) == 0 for p in pages)
        assert alloc.used_pages < used_before
        assert e.abort_request(victim) is False
        with pytest.raises(TimeoutError):
            victim.result(0.05)
        q = e.submit([7, 7, 7, 7, 7], max_new_tokens=2)
        assert q.state == "waiting"
        assert e.abort_request(q) is True and q.state == "aborted"
        _drive(e, until=keeper.done)
        assert keeper.result(10) == base
        assert e.abort_request(keeper) is False
        assert fired == ["keeper"]
        assert alloc.used_pages == 0 and len(e.scheduler.active) == 0
        e.close()
        return base, list(victim.generated), pages, used_before
    _both(models, sc)


def test_hedged_straggler_first_finisher_wins(models):
    def sc(P):
        prompt = np.random.RandomState(21).randint(1, 250, 9).tolist()
        base = _solo(P, prompt, 6)
        reg = P.metrics.enable(out_dir=None, interval_s=0)
        try:
            a = _engine(P, engine_id="e0")
            b = _engine(P, engine_id="e1")
            r = P.fleet.FleetRouter(hedge_after_s=0.2)
            r.add_engine(a, "e0")
            r.add_engine(b, "e1")
            stream = []
            fr = r.submit(prompt, max_new_tokens=6, engine="e0",
                          on_token=lambda q, tok, fin: stream.append(tok))
            a.step()
            a.step()
            assert 0 < len(fr.generated) < 6
            leg0 = fr._leg
            pages0 = list(leg0.pages)
            assert r.hedge_sweep(now=fr.t_submit + 99.0) == 1
            assert fr._hedge is not None and r.hedges_fired == 1
            assert r.hedge_sweep(now=fr.t_submit + 999.0) == 0
            _drive(b, until=fr.done)
            assert fr.result(10) == base
            assert stream == base
            assert fr.engine_id == "e1" and fr.engine_ids == ["e0", "e1"]
            assert r.hedges_won == 1 and r.aborts == 1
            assert leg0.state == "aborted"
            assert len(a.scheduler.active) == 0
            assert a.kv.allocator.used_pages == 0
            assert all(a.kv.allocator.refcount(p) == 0 for p in pages0)
            st = r.stats()
            assert st["inflight"] == 0
            hs = r.handles()
            assert hs["e0"].pending == 0 and hs["e1"].pending == 0
            c = reg.snapshot()["counters"]
            assert c["serving_hedges_fired_total"] == 1
            assert c["serving_hedges_won_total"] == 1
            assert c["serving_aborts_total"] == 1
            a.close()
            b.close()
            return (base, stream, fr.engine_ids,
                    {k: st[k] for k in ("dispatched", "hedges_fired",
                                        "hedges_won", "aborts",
                                        "redispatched")},
                    {k: v for k, v in c.items() if "hedge" in k
                     or "abort" in k})
        finally:
            P.metrics.disable()
    _both(models, sc)


def test_router_pending_decrements_exactly_once(models):
    def sc(P):
        e = _engine(P)
        r = P.fleet.FleetRouter()
        h = r.add_engine(e, "e0")
        fa = r.submit([1, 2, 3, 4, 5], max_new_tokens=1)
        fb = r.submit([9, 8, 7, 6, 5], max_new_tokens=6)
        assert h.pending == 2
        _drive(e, until=fa.done)
        leg = fa._leg
        assert h.pending == 1
        r._on_leg_done(leg)
        r._on_leg_done(leg)
        assert h.pending == 1
        _drive(e, until=fb.done)
        assert h.pending == 0
        out = fa.result(5), fb.result(5)
        assert len(out[0]) == 1 and len(out[1]) == 6
        e.close()
        return out
    _both(models, sc)


# --------------------------------------------- autoscaling

def test_autoscaler_scale_up_down_hysteresis(models):
    def sc(P):
        e0 = _engine(P, engine_id="e0", max_queue=16)
        r = P.fleet.FleetRouter()
        r.add_engine(e0, "e0")
        spawned = []

        def spawn(eid):
            eng = _engine(P, engine_id=eid)
            spawned.append(eng)
            return eng

        sc_ = P.fleet.EngineAutoscaler(
            r, spawn, min_engines=1, max_engines=2, queue_high=1.0,
            queue_low=0.5, up_ticks=2, down_ticks=2, cooldown_s=0.0,
            warm=False)
        frs = [r.submit([1, 2, 3, 4, 5], max_new_tokens=2)
               for _ in range(4)]
        acts = [sc_.tick(now=1.0), sc_.tick(now=2.0)]
        assert acts == [None, "up"]
        assert set(r.handles()) == {"e0", "a0"} and sc_.epoch == 1
        assert sc_.events[-1]["dir"] == "up"
        assert sc_.events[-1]["engine"] == "a0"
        acts += [sc_.tick(now=3.0), sc_.tick(now=4.0)]
        assert acts[2:] == [None, None] and len(r.handles()) == 2
        _drive(e0, until=lambda: all(f.done() for f in frs))
        toks = [f.result(10) for f in frs]
        assert all(len(t) == 2 for t in toks)
        acts += [sc_.tick(now=5.0), sc_.tick(now=6.0)]
        assert acts[4:] == [None, "down"]
        assert len(r.handles()) == 1 and sc_.events[-1]["dir"] == "down"
        acts.append(sc_.tick(now=7.0))
        assert acts[-1] is None
        sc_.close()
        r.close()
        return (acts, toks, [(e["dir"], e["engine"], e["n_engines"],
                              e["epoch"]) for e in sc_.events],
                sorted(r.handles()))
    _both(models, sc)


def test_autoscaler_quarantine_blocks_readmission(models):
    def sc(P):
        spawned = {}

        def spawn(eid):
            eng = _engine(P, engine_id=eid)
            spawned[eid] = eng
            return eng

        r = P.fleet.FleetRouter()
        r.add_engine(spawn("a0"), "a0")
        sc_ = P.fleet.EngineAutoscaler(r, spawn, min_engines=1,
                                       max_engines=3, id_prefix="a",
                                       warm=False, cooldown_s=0.0)
        spawned["a0"].close()
        assert sc_.tick(now=1.0) == "up"
        assert sc_.quarantine.quarantined() == ["a0"]
        assert set(r.handles()) == {"a1"}
        assert sc_.events[-1]["dir"] == "up"
        assert sc_.events[-1]["engine"] == "a1"
        assert sc_.scale_up(now=2.0) == "a2"
        assert "a0" not in r.handles() and len(r.handles()) == 2
        sc_.close()
        r.close()
        return (sc_.quarantine.quarantined(), sorted(r.handles()),
                [(e["dir"], e["engine"]) for e in sc_.events])
    _both(models, sc)


def test_fleet_membership_survives_store_failover():
    def sc(P):
        p1, p2 = _free_port(), _free_port()
        prim = _store(P, p1, is_master=True, timeout=15)
        standby = _store(P, p2, is_master=True, timeout=15)
        fs = P.dist.FailoverStore(f"127.0.0.1:{p1},127.0.0.1:{p2}",
                                  timeout=15, connect_deadline=2.0)
        sh = P.dist.LogShipper(f"127.0.0.1:{p1}", f"127.0.0.1:{p2}",
                               timeout=15)
        reg = P.fleet.EngineRegistry(fs, job="t6")
        reg.register("e0", heartbeat=False)
        reg.register("e1", heartbeat=False)
        q = P.elastic.QuarantineList(threshold=1)
        assert q.record_failure("e1", now=100.0)
        reg.save_quarantine(q, now=100.0)
        reg.save_autoscale({"epoch": 3, "n_engines": 2})
        assert sh.ship_once() > 0
        prim.stop_server()
        reg2 = P.fleet.EngineRegistry(_store(P, p2, timeout=15), job="t6")
        q2 = P.elastic.QuarantineList(threshold=1)
        assert reg2.load_quarantine(q2, now=200.0)
        assert q2.is_quarantined("e1")
        state = reg2.load_autoscale()
        assert state["epoch"] == 3 and state["n_engines"] == 2
        joined = reg2.joined()
        assert joined == ["e0", "e1"]
        standby.stop_server()
        return q2.quarantined(), state, joined
    _both((None, None), sc)


# ------------------------------------------- serving chaos

def test_engine_fault_kinds_parse_and_target(models, monkeypatch):
    def sc(P):
        with pytest.raises(ValueError):
            P.fault.parse_fault_spec("engine_die@step:1")
        with pytest.raises(ValueError):
            P.fault.parse_fault_spec("engine_stall@ckpt:1")
        a = _engine(P, engine_id="e0")
        b = _engine(P, engine_id="e1")
        monkeypatch.setenv("PADDLE_TPU_FAULT_ENGINE", "e1")
        try:
            P.fault.set_fault_spec("engine_die@serve_loop:1")
            a.start()
            b.start()
            deadline = time.time() + 20
            while b._loop_error is None and time.time() < deadline:
                time.sleep(0.02)
            assert b._loop_error is not None and b._closed
            assert "engine_die" in str(b._loop_error)
            assert a._loop_error is None and not a._closed
            out = a.generate([1, 2, 3], max_new_tokens=2)
            assert len(out) == 2
        finally:
            P.fault.set_fault_spec(None)
            monkeypatch.delenv("PADDLE_TPU_FAULT_ENGINE")
            a.close()
            b.close()
        monkeypatch.setenv("PADDLE_TPU_FAULT_ENGINE_STALL_S", "0.05")
        c = _engine(P, engine_id="e2")
        try:
            P.fault.set_fault_spec("engine_stall@serve_loop:1")
            c.start()
            out2 = c.generate([4, 5, 6], max_new_tokens=2, timeout=30)
            assert len(out2) == 2 and c._loop_error is None
        finally:
            P.fault.set_fault_spec(None)
            monkeypatch.delenv("PADDLE_TPU_FAULT_ENGINE_STALL_S")
            c.close()
        return out, out2, type(b._loop_error).__name__
    _both(models, sc)


# ------------------------------- prefetch + streaming RPC

def test_router_prefetch_on_affinity_spill(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        reg = P.metrics.enable(out_dir=None, interval_s=0)
        try:
            shA = P.fleet.PageShareClient(_store(P, port), "e0", job="t8")
            shB = P.fleet.PageShareClient(_store(P, port), "e1", job="t8")
            ea = _engine(P, engine_id="e0", page_share=shA, registry=reg,
                         max_queue=16)
            eb = _engine(P, engine_id="e1", page_share=shB, registry=reg,
                         max_queue=16)
            r = P.fleet.FleetRouter()
            r._prefetch_async = False
            r.add_engine(ea, "e0")
            r.add_engine(eb, "e1")
            rng = np.random.RandomState(12)
            head = rng.randint(1, 250, 8).tolist()
            s0 = r.submit(head + [7, 8], max_new_tokens=2, engine="e0")
            _drive(ea, eb)
            t0 = s0.result(10)
            assert shA.published == 2
            fillers = [r.submit(rng.randint(1, 250, 5).tolist(),
                                max_new_tokens=4, engine="e0")
                       for _ in range(5)]
            fr = r.submit(head + [9, 9], max_new_tokens=2)
            assert fr.engine_id == "e1"
            assert r.prefetch_pages == 2
            assert shB.remote_hit_tokens == 8
            eb.step()
            assert fr._leg.prefix_hit_tokens == 8
            _drive(ea, eb)
            out = fr.result(10)
            assert len(out) == 2
            ftoks = [f.result(10) for f in fillers]
            assert all(len(t) == 4 for t in ftoks)
            snap = reg.snapshot()
            assert snap["counters"][
                "serving_prefetch_pages_total{engine=e1}"] == 2
            st = r.stats()
            assert st["prefetch_pages"] == 2
            ea.close()
            eb.close()
            return (t0, out, ftoks, {k: st[k] for k in (
                "prefetch_pages", "dispatched", "affinity_hits")})
        finally:
            P.metrics.disable()
            del master
    _both(models, sc)


def test_remote_streaming_and_abort_over_store(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        eng = _engine(P, engine_id="e0", max_queue=8)
        eng.start()
        t = threading.Thread(target=P.fleet.serve_over_store,
                             args=(eng, _store(P, port), "e0"),
                             kwargs={"job": "t9", "poll_s": 0.01},
                             daemon=True)
        t.start()
        handle = P.fleet.RemoteEngineHandle(lambda: _store(P, port), "e0",
                                            job="t9", poll_s=0.01)
        r = P.fleet.FleetRouter()
        r.add_engine(None, handle=handle)
        r.page_size = 4
        stream = []
        fr = r.submit([5, 6, 7, 8], max_new_tokens=4,
                      on_token=lambda q, tok, fin: stream.append((tok, fin)))
        out = fr.result(60)
        assert len(out) == 4
        sp = P.keyspace.fleet_engine_stream("t9", "e0")
        assert int(master.add(f"{sp}/tok_seq", 0)) >= 1
        assert [tok for tok, _ in stream] == out
        assert [fin for _, fin in stream] == [False] * 3 + [True]
        fr2 = r.submit([9, 8, 7, 6], max_new_tokens=48)
        deadline = time.time() + 30
        while not fr2.generated and time.time() < deadline:
            time.sleep(0.005)
        assert fr2.generated and not fr2.done()
        assert handle.abort(fr2._leg) is True
        deadline = time.time() + 30
        while (eng.scheduler.has_work() or eng.kv.allocator.used_pages) \
                and time.time() < deadline:
            time.sleep(0.01)
        assert not eng.scheduler.has_work()
        assert eng.kv.allocator.used_pages == 0
        assert not fr2.done()
        master.set(f"{P.keyspace.fleet_registry('t9')}/stop", b"1")
        t.join(10)
        assert not t.is_alive()
        handle.close()
        eng.close()
        del master
        return out, stream
    _both(models, sc)


def test_remote_submit_retry_dedupes_by_rid(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        eng = _engine(P, engine_id="e0", max_queue=8)
        t = threading.Thread(target=P.fleet.serve_over_store,
                             args=(eng, _store(P, port), "e0"),
                             kwargs={"job": "t10", "poll_s": 0.01},
                             daemon=True)
        t.start()
        handle = P.fleet.RemoteEngineHandle(lambda: _store(P, port), "e0",
                                            job="t10", poll_s=0.01)
        r = P.fleet.FleetRouter()
        r.add_engine(None, handle=handle)
        r.page_size = 4
        stream = []
        fr = r.submit([5, 6, 7, 8], max_new_tokens=4,
                      on_token=lambda q, tok, fin: stream.append(tok))
        rid = fr._leg._wire_rid
        deadline = time.time() + 30
        while not eng.scheduler.has_work() and time.time() < deadline:
            time.sleep(0.01)
        assert eng.scheduler.has_work()
        rp = P.keyspace.fleet_engine_rpc("t10", "e0")
        dup = json.dumps({"rid": rid, "prompt": [5, 6, 7, 8],
                          "max_new_tokens": 4, "eos_token_id": None,
                          "temperature": 0.0, "top_k": None})
        seq = int(master.add(f"{rp}/in_seq", 1))
        master.set(f"{rp}/in/{seq}", dup)
        probe = r.submit([9, 8, 7, 6], max_new_tokens=2)
        deadline = time.time() + 30
        while eng.scheduler.queue_depth() < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.scheduler.queue_depth() == 2
        eng.start()
        out = fr.result(60)
        assert len(out) == 4 and stream == out
        pout = probe.result(60)
        assert len(pout) == 2
        nout = int(master.add(f"{rp}/out_seq", 0))
        recs = [json.loads(master.get(f"{rp}/out/{i}", timeout=10))
                for i in range(1, nout + 1)]
        assert len([x for x in recs if x["rid"] == rid]) == 1
        seq = int(master.add(f"{rp}/in_seq", 1))
        master.set(f"{rp}/in/{seq}", dup)
        deadline = time.time() + 30
        while int(master.add(f"{rp}/out_seq", 0)) == nout \
                and time.time() < deadline:
            time.sleep(0.01)
        recs = [json.loads(master.get(f"{rp}/out/{i}", timeout=10))
                for i in range(1, int(master.add(f"{rp}/out_seq", 0)) + 1)]
        mine = [x for x in recs if x["rid"] == rid]
        assert len(mine) == 2
        assert mine[0]["tokens"] == mine[1]["tokens"] == out
        assert not eng.scheduler.has_work()
        master.set(f"{P.keyspace.fleet_registry('t10')}/stop", b"1")
        t.join(10)
        handle.close()
        eng.close()
        del master
        return out, pout, len(mine)
    _both(models, sc)


def test_hedge_excludes_inflight_migration_target(models):
    def sc(P):
        e0 = _engine(P, engine_id="e0")
        e1 = _engine(P, engine_id="e1")
        r = P.fleet.FleetRouter(hedge_after_s=0.01)
        r.add_engine(e0, "e0")
        r.add_engine(e1, "e1")
        fr = r.submit([1, 2, 3, 4, 5], max_new_tokens=4, engine="e0")
        with fr._tok_lock:
            fr._migrating_to = "e1"
        first = r._hedge(fr)
        assert first is False
        assert r.hedges_fired == 0 and fr._hedge is None
        with fr._tok_lock:
            fr._migrating_to = None
        second = r._hedge(fr)
        assert second is True and fr._hedge is not None
        assert fr._hedge._handle_id == "e1"
        assert r.hedges_fired == 1
        hid = fr._hedge._handle_id
        e0.close()
        e1.close()
        return first, second, hid, r.hedges_fired
    _both(models, sc)


# ---------------------------------------- payloads across the packages

def _seeded_pools(P, L=3, pages=5, ps=4, kvh=2, dh=8, dtype="float32"):
    """A ``SharedPrefixCache`` over pools filled from a numpy seed."""
    kv_dtype = {"float32": (np.float32, torch.float32, jnp.float32),
                "bfloat16": (None, torch.bfloat16, jnp.bfloat16)}[dtype]
    if P.name == "port":
        kv = P.serving.PagedKVCache(L, pages, ps, kvh, dh,
                                    dtype=kv_dtype[1], device="cpu")
    else:
        kv = P.serving.PagedKVCache(L, pages, ps, kvh, dh,
                                    dtype=kv_dtype[2])
    rng = np.random.RandomState(17)
    for layer in range(L):
        for side in ("k", "v"):
            vals = rng.randn(pages, ps, kvh, dh).astype(np.float32)
            if P.name == "port":
                getattr(kv, side)[layer].copy_(torch.from_numpy(vals))
            else:
                getattr(kv, side)[layer] = jnp.asarray(vals, kv_dtype[2])
    share = SimpleNamespace(max_publish_pages=8, remote_hits=0,
                            remote_hit_tokens=0)
    return P.fleet.SharedPrefixCache(kv, ps, share)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_payload_bytes_cross_the_packages_both_ways(dtype):
    """JAX's ``_page_payload`` bytes written by the port's ``_write_page``
    into a port pool and gathered back by the port's ``_page_payload``
    are the same bytes; and the port's payload written into a JAX pool
    comes back from JAX unchanged (bf16 through ``ml_dtypes`` there, raw
    bytes here)."""
    jcache = _seeded_pools(_pkg("jax", None), dtype=dtype)
    pcache = _seeded_pools(_pkg("port", None), dtype=dtype)
    # both pools hold the same values: their payloads are the same bytes
    for page in (1, 3):
        assert pcache._page_payload(page) == jcache._page_payload(page)
    jbytes = jcache._page_payload(2)
    assert pcache._write_page(4, jbytes) is True
    assert pcache._page_payload(4) == jbytes
    pbytes = pcache._page_payload(1)
    assert jcache._write_page(4, pbytes) is True
    assert jcache._page_payload(4) == pbytes
    # a payload of the wrong size is a miss in both, nothing written
    before = pcache._page_payload(0)
    assert pcache._write_page(0, jbytes[:-2]) is False
    assert pcache._page_payload(0) == before


def test_an_import_writes_the_pools_in_place(models):
    """An admission that imports a published head writes every
    ``kv.k[l]`` / ``kv.v[l]`` through its storage (the round programs read
    it), never rebinding a pool; each imported page's bytes are the bytes
    the publisher put in the store."""
    from paddle_tpu_torch.serving.fleet.page_share import chain_hash
    _, tm = models
    P = _pkg("port", tm)
    port = _free_port()
    master = _store(P, port, is_master=True)
    ea = _engine(P, engine_id="A", page_share=P.fleet.PageShareClient(
        _store(P, port), "A", job="tp"))
    shB = P.fleet.PageShareClient(_store(P, port), "B", job="tp")
    eb = _engine(P, engine_id="B", page_share=shB)
    head = np.random.RandomState(31).randint(1, 250, 8).tolist()
    want = ea.generate(head + [3, 4], max_new_tokens=3)
    pools = [(t, t.data_ptr()) for t in eb.kv.k + eb.kv.v]
    req = eb.submit(head + [3, 4], max_new_tokens=3)
    eb.step()
    assert req.prefix_hit_tokens == 8 and shB.remote_hits == 1
    assert all(a is t for a, (t, _) in zip(eb.kv.k + eb.kv.v, pools))
    assert all(t.data_ptr() == p for t, p in pools)
    h = "root"
    for i, page in enumerate(req.pages[:2]):
        h = chain_hash(h, head[4 * i:4 * (i + 1)])
        published = ea.prefix.share.store.get(
            f"{ea.prefix.share.prefix}/pg/{h}")
        assert eb.prefix._page_payload(page) == published
    _drive(eb)
    assert req.result(10) == want
    ea.close()
    eb.close()
    del master
