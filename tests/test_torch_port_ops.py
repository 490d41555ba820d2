"""The port's serving operations against the JAX engine, on the CPU.

Graceful shutdown (``shutdown``, ``install_sigterm``), abort, KV page
migration between engines (``fleet.migrate_request`` / ``drain_active``)
and the measure-only A/B gate. Both packages serve ``gpt_tiny`` with the
same weights (carried by ``params_from_paddle_tpu``, ``dropout=0``) at
page 4, 32 pages, 2 slots; the JAX engines run eagerly on the
``xla`` backend, the port's on its plain versions. Each test mirrors the
JAX test it names: greedy tokens are compared exactly, and so are the
shutdown summaries and the outcomes of each migration.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import scheduler as jax_sched
from paddle_tpu.serving.decode import resolve_backend as jax_resolve
from paddle_tpu.serving.fleet import disagg as jax_disagg
from paddle_tpu_torch import ServingEngine, gpt_tiny, params_from_paddle_tpu
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import tracing as ptracing
from paddle_tpu_torch.serving import (BlockAllocator,
                                      ContinuousBatchingScheduler,
                                      EngineClosed, EngineShuttingDown,
                                      GenerationRequest, decode)
from paddle_tpu_torch.serving.fleet import disagg

ENG = dict(page_size=4, num_pages=32, max_slots=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-wide planes (metrics, tracing, faults, the
    preemption flag) back to their defaults after every test."""
    yield
    pmetrics._reset_state()
    ptracing._reset_state()
    fault._entries = None
    fault._preempt_event.clear()


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


@pytest.fixture(scope="module")
def mha():
    return _models(7)


@pytest.fixture(scope="module")
def gqa():
    return _models(11, num_kv_heads=2)


def _jax(jm, **kw):
    return JaxEngine(jm, attn_backend="xla", jit=False, **{**ENG, **kw})


def _port(tm, **kw):
    return ServingEngine(tm, **{**ENG, **kw})


def _drive(*engines, until=None, max_steps=300):
    """Step every engine round-robin until ``until()`` (or all idle)."""
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
    raise AssertionError("engines did not converge")


def _both(mha, fn):
    """``fn(make_engine, migrate, drain)`` on the JAX engine and on the
    port's -> the two results."""
    jm, tm = mha
    return (fn(lambda **kw: _jax(jm, **kw), jax_disagg.migrate_request,
               jax_disagg.drain_active),
            fn(lambda **kw: _port(tm, **kw), disagg.migrate_request,
               disagg.drain_active))


# --------------------------------------------------------------- migration

@pytest.mark.parametrize("ragged", [True, False])
def test_migrate_request_token_identical_across_page_boundary(mha, ragged):
    """Mirrors the JAX test of that name: migration after 1, 2 and 3
    rounds (num_cached mid-page, on a page boundary, on a new page) is
    token-identical to the unmigrated run, in the port and in JAX, and
    both packages agree token for token."""
    prompt = np.random.RandomState(5).randint(1, 250, 7).tolist()

    def run(make, migrate, _):
        solo = make(ragged=ragged)
        base = solo.generate(prompt, max_new_tokens=8)
        solo.close()
        out = []
        for steps in (1, 2, 3):
            src, dst = make(engine_id="s", ragged=ragged), \
                make(engine_id="d", ragged=ragged)
            req = src.submit(prompt, max_new_tokens=8)
            for _ in range(steps):
                src.step()
            assert migrate(src, dst, req) == "migrated"
            cached = req.num_cached
            assert req.pages and len(req.pages) * 4 >= cached
            _drive(dst)
            out.append((cached, req.result(10)))
            assert req.result(10) == base, f"diverged at steps={steps}"
            src.close()
            dst.close()
        return base, out

    jax_run, port_run = _both(mha, run)
    assert port_run == jax_run


def test_migrate_request_gqa_and_prefix_hit(gqa):
    """Mirrors the JAX test: GQA pools and a prefix-hit head — the
    source's shared head pages stay indexed (a deref, not a free) and the
    continuation is token-identical, equal to JAX's."""
    rng = np.random.RandomState(6)
    head = rng.randint(1, 250, 8).tolist()          # 2 full pages
    prompt = head + rng.randint(1, 250, 3).tolist()

    def run(make, migrate, _):
        solo = make()
        base = solo.generate(prompt, max_new_tokens=6)
        solo.close()
        src, dst = make(engine_id="s"), make(engine_id="d")
        warm = src.submit(head + [5, 6], max_new_tokens=2)
        _drive(src)
        warm.result(10)                              # indexes the head
        req = src.submit(prompt, max_new_tokens=6)
        src.step()
        assert req.prefix_hit_tokens == 8
        src.step()
        shared = req.pages[0]
        assert src.kv.allocator.refcount(shared) >= 1
        assert migrate(src, dst, req) == "migrated"
        assert src.prefix.holds(shared)
        assert src.kv.allocator.refcount(shared) == 0
        _drive(dst)
        assert req.result(10) == base
        assert dst.stats()["num_kv_heads"] == 2
        src.close()
        dst.close()
        return base

    jm, tm = gqa
    jax_tok = run(lambda **kw: _jax(jm, **kw), jax_disagg.migrate_request,
                  None)
    port_tok = run(lambda **kw: _port(tm, **kw), disagg.migrate_request,
                   None)
    assert port_tok == jax_tok


def test_migrate_fallback_recompute_when_target_full(mha):
    """Mirrors the JAX test: a target with its one slot taken refuses the
    adopt (OutOfSlots), the request recomputes from the target's queue,
    still token-identical and equal to JAX's."""
    rng = np.random.RandomState(8)
    prompt = rng.randint(1, 250, 9).tolist()
    blocker_p = rng.randint(1, 250, 5).tolist()

    def run(make, migrate, _):
        solo = make()
        base = solo.generate(prompt, max_new_tokens=6)
        solo.close()
        src, dst = make(engine_id="s"), make(engine_id="d", max_slots=1)
        blocker = dst.submit(blocker_p, max_new_tokens=12)
        dst.step()
        req = src.submit(prompt, max_new_tokens=6)
        src.step()
        src.step()
        assert migrate(src, dst, req) == "recompute"
        assert req.num_cached == 0 and req.state == "waiting"
        _drive(dst)
        assert req.result(20) == base
        out = (base, blocker.result(10))
        src.close()
        dst.close()
        return out

    jax_run, port_run = _both(mha, run)
    assert port_run == jax_run


def test_migrate_refused_by_a_closed_target_raises(mha):
    """A closed target takes the request neither way: MigrationFailed,
    and the request stays detached for the caller to place."""
    _, tm = mha
    src, dst = _port(tm, engine_id="s"), _port(tm, engine_id="d")
    req = src.submit([3, 1, 4, 1, 5], max_new_tokens=4)
    src.step()
    dst.close()
    with pytest.raises(disagg.MigrationFailed, match="refused"):
        disagg.migrate_request(src, dst, req)
    assert req.state == "migrating" and not req.pages
    src.close()


def test_drain_active_moves_every_inflight_request(mha):
    """``drain_active`` moves both in-flight requests off the source with
    their pages; tokens equal the unmigrated runs, in both packages."""
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, 250, n).tolist() for n in (6, 9)]

    def run(make, _, drain):
        solo = make()
        base = [solo.generate(p, max_new_tokens=6) for p in prompts]
        solo.close()
        src, dst = make(engine_id="s"), make(engine_id="d", max_slots=4)
        reqs = [src.submit(p, max_new_tokens=6) for p in prompts]
        src.step()
        src.step()
        moved = []
        outcomes = drain(src, lambda r: dst,
                         on_moved=lambda r, d, o: moved.append(o))
        assert sorted(outcomes.values()) == ["migrated", "migrated"]
        assert moved == ["migrated", "migrated"]
        assert not src.scheduler.has_work()
        _drive(dst)
        assert [r.result(10) for r in reqs] == base
        src.close()
        dst.close()
        return base

    jax_tok, port_tok = _both(mha, run)
    assert port_tok == jax_tok


def test_snapshot_kv_payload_is_the_pools_and_adopts_from_numpy(mha):
    """``snapshot_kv`` returns CPU tensors in the pools' dtype, equal to
    the JAX engine's numpy payload of the same request; a numpy payload
    adopts as well as the tensors."""
    jm, tm = mha
    prompt = np.random.RandomState(13).randint(1, 250, 10).tolist()
    je, te = _jax(jm), _port(tm)
    jr, tr = (e.submit(prompt, max_new_tokens=6) for e in (je, te))
    for _ in range(3):
        je.step()
        te.step()
    jk, jv, jlen = je.snapshot_kv(jr)
    tk, tv, tlen = te.snapshot_kv(tr)
    assert tlen == jlen == tr.num_cached
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in tk + tv)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-4)
    dst = _port(tm, engine_id="d")
    te.release_request(tr)
    dst.adopt_request(tr, [np.asarray(k) for k in tk],
                      [np.asarray(v) for v in tv], tlen)
    again = dst.snapshot_kv(tr)
    assert all(torch.equal(a, b) for a, b in zip(tk + tv,
                                                 again[0] + again[1]))
    _drive(je)
    _drive(dst)
    assert tr.result(1) == jr.result(1)


# ------------------------------------------------------------------ abort

@pytest.mark.parametrize("ragged", [True, False])
def test_engine_abort_frees_slot_and_pages(mha, ragged):
    """Mirrors the JAX test: abort frees slot + pages at once (refcount
    0), never fires waiters or ``on_done``, refuses terminal states, and
    a co-resident request decodes unperturbed — equal to JAX's."""

    def run(make, _, __):
        solo = make(ragged=ragged)
        base = solo.generate([1, 2, 3, 4], max_new_tokens=4)
        solo.close()
        e = make(ragged=ragged)
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
        return base

    jax_tok, port_tok = _both(mha, run)
    assert port_tok == jax_tok


def test_abort_of_a_prefix_hit_derefs_the_shared_head(mha):
    """Aborting a request that took a prefix-hit head drops only its own
    reference: the head stays indexed for the next hit."""
    _, tm = mha
    e = _port(tm)
    head = list(range(1, 9))
    e.generate(head + [20], max_new_tokens=2)
    req = e.submit(head + [30, 31], max_new_tokens=4)
    e.step()
    assert req.prefix_hit_tokens == 8
    shared = req.pages[:2]
    assert all(e.kv.allocator.refcount(p) == 1 for p in shared)
    assert e.abort_request(req) is True
    assert all(e.kv.allocator.refcount(p) == 0 and e.prefix.holds(p)
               for p in shared)
    again = e.submit(head + [40], max_new_tokens=2)
    e.run_until_idle()
    assert again.prefix_hit_tokens == 8 and len(again.result(1)) == 2


# --------------------------------------------------------------- shutdown

def test_scheduler_begin_shutdown_names_queued_keeps_inflight():
    """Mirrors the JAX test on both schedulers: only the QUEUED request
    fails, with the named status; the in-flight one is kept for the
    drain; later submits raise the same status; the final close fails
    the stragglers with it and frees every page."""
    from paddle_tpu.serving import kv_cache as jax_kv
    results = []
    for alloc_cls, sched_cls, req_cls, shutting in (
            (jax_kv.BlockAllocator, jax_sched.ContinuousBatchingScheduler,
             jax_sched.GenerationRequest, jax_sched.EngineShuttingDown),
            (BlockAllocator, ContinuousBatchingScheduler, GenerationRequest,
             EngineShuttingDown)):
        sched = sched_cls(alloc_cls(16), 2, 4, 64, max_queue=8)
        r1 = req_cls([1, 2, 3, 4], max_new_tokens=4)
        sched.submit(r1)
        sched.schedule()
        r2 = req_cls([1, 2, 3, 4], max_new_tokens=4)
        sched.submit(r2)
        failed = sched.begin_shutdown()
        assert failed == [r2]
        with pytest.raises(shutting):
            r2.result(timeout=1)
        assert r1.state == "active"
        with pytest.raises(shutting):
            sched.submit(req_cls([1, 2], max_new_tokens=2))
        sched.close()
        with pytest.raises(shutting) as ei:
            r1.result(timeout=1)
        assert sched.allocator.used_pages == 0
        results.append((r1.state, r2.state, str(ei.value)))
    assert results[0] == results[1]


@pytest.mark.parametrize("ragged", [True, False])
def test_engine_graceful_shutdown_drains_inflight(mha, ragged):
    """Mirrors the JAX test: in-flight requests finish, the queued one
    fails with EngineShuttingDown, shutdown is idempotent and close() a
    no-op after it; the summaries equal JAX's."""

    def run(make, _, __):
        eng = make(ragged=ragged)
        r1 = eng.submit([1, 2, 3], max_new_tokens=4)
        r2 = eng.submit([4, 5, 6], max_new_tokens=4)
        eng.step()
        r3 = eng.submit([7, 8], max_new_tokens=2)
        out = eng.shutdown(drain_s=60.0)
        assert out["failed_queued"] == 1 and out["failed_inflight"] == 0
        assert out["drained_tokens"] > 0
        toks = [r1.result(timeout=1), r2.result(timeout=1)]
        with pytest.raises(Exception, match="shutting down") as ei:
            r3.result(timeout=1)
        assert type(ei.value).__name__ == "EngineShuttingDown"
        with pytest.raises(Exception, match="shutting down"):
            eng.submit([1], max_new_tokens=1)
        again = eng.shutdown()
        eng.close()
        return out, again, toks

    jax_run, port_run = _both(mha, run)
    assert port_run == jax_run
    assert port_run[1] == {"drained_tokens": 0, "failed_queued": 0,
                           "failed_inflight": 0}


def test_engine_shutdown_deadline_fails_inflight_and_flushes(mha, tmp_path):
    """Mirrors the JAX test: a zero drain budget fails the in-flight
    request naming the deadline and still flushes the metrics JSONL; the
    summary and the flushed counters equal JAX's."""
    import json
    from paddle_tpu.observability import metrics as jax_metrics
    jm, tm = mha
    runs = []
    for make, reg in ((lambda r: _jax(jm, registry=r),
                       jax_metrics.MetricsRegistry(
                           rank=0, out_dir=str(tmp_path / "jax"))),
                      (lambda r: _port(tm, registry=r),
                       pmetrics.enable(out_dir=str(tmp_path / "port"),
                                       rank=0))):
        eng = make(reg)
        req = eng.submit([5, 6, 7, 8], max_new_tokens=50)
        eng.step()
        out = eng.shutdown(drain_s=0.0)
        with pytest.raises(Exception, match="drain deadline") as ei:
            req.result(timeout=1)
        assert type(ei.value).__name__ == "EngineShuttingDown"
        path = reg.out_path()
        rows = [json.loads(x) for x in open(path).read().splitlines()]
        assert any("serving_requests_total" in k for r in rows
                   for k in r["counters"])
        runs.append((out, rows[-1]["counters"], sorted(rows[-1])))
    assert runs[1] == runs[0]
    assert runs[1][0]["failed_inflight"] == 1


def test_engine_install_sigterm_drains_and_exits_75(mha, monkeypatch):
    """Mirrors the JAX test: SIGTERM -> graceful drain -> exit 75 through
    ``fault.install_preemption_handler`` (``os._exit`` monkeypatched)."""
    _, tm = mha
    exits = []
    monkeypatch.setattr(fault.os, "_exit", lambda rc: exits.append(rc))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        eng = _port(tm)
        assert eng.install_sigterm(drain_s=30.0) is True
        req = eng.submit([3, 1, 4], max_new_tokens=3)
        eng.step()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 30
        while not exits and time.time() < deadline:
            time.sleep(0.05)
        assert exits == [fault.EXIT_PREEMPT]
        assert len(req.result(timeout=1)) == 3
    finally:
        signal.signal(signal.SIGTERM, prev)


_CHILD = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {repo!r})
    import paddle_tpu_torch as pt
    model = pt.GPTForCausalLM(pt.gpt_tiny(), device="cpu", seed=0)
    eng = pt.ServingEngine(model, page_size=4, num_pages=32, max_slots=2)
    assert eng.install_sigterm(drain_s=60)
    req = eng.submit([1, 2, 3, 4, 5], max_new_tokens=20, on_done=lambda r:
                     print(json.dumps([len(r.generated), r.state]),
                           flush=True))
    while not req.generated:
        eng.step()
    print("STARTED", flush=True)
    while True:
        time.sleep(0.05)
""")


def test_sigterm_in_a_serving_process_drains_and_exits_75():
    """A real process: SIGTERM while a request is in flight -> its drain
    finishes the request (``on_done`` prints all 20 tokens) and the
    process exits 75, the resumable code."""
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO)],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    try:
        assert child.stdout.readline().strip() == "STARTED"
        child.send_signal(signal.SIGTERM)
        rest, _ = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == fault.EXIT_PREEMPT
    assert '[20, "finished"]' in rest.splitlines()


# ------------------------------------------- submit, on_done, crash site

def test_on_done_fires_once_and_a_crashed_loop_is_named(mha):
    """``submit(on_done=)`` fires once at the terminal state; an injected
    ``engine_die@serve_loop`` crashes the loop, every later submit raises
    EngineClosed naming the crash, as the JAX engine does."""
    jm, tm = mha
    messages = []
    for make in (lambda: _jax(jm), lambda: _port(tm)):
        done = []
        eng = make()
        eng.generate([1, 2, 3], max_new_tokens=3,
                     on_done=lambda r: done.append(r.state))
        assert done == ["finished"]
        for mod in (fault, __import__("paddle_tpu.distributed.fault",
                                      fromlist=["x"])):
            mod.set_fault_spec("engine_die@serve_loop:1")
        eng.start()
        deadline = time.time() + 30
        while eng._loop_error is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(Exception, match="serve loop crashed") as ei:
            eng.submit([1, 2], max_new_tokens=2)
        assert type(ei.value).__name__ == "EngineClosed"
        messages.append(str(ei.value))
        eng.close()
        fault.set_fault_spec(None)
    assert messages[1] == messages[0]
    assert issubclass(EngineShuttingDown, EngineClosed)


def test_prefetch_prefix_returns_zero_without_share_client(mha):
    jm, tm = mha
    assert _port(tm).prefetch_prefix([1, 2, 3, 4, 5]) == 0
    assert _jax(jm).prefetch_prefix([1, 2, 3, 4, 5]) == 0


# ----------------------------------------------------------- the A/B gate

@pytest.mark.parametrize("explicit,serving_env,kernels_env", [
    (None, None, None), ("pallas", "xla", None), (None, "xla", "pallas"),
    (None, None, "pallas"), ("AUTO", None, None), (None, "Pallas", None),
    ("bogus", None, None), (None, "bogus", None)])
def test_resolve_backend_precedence_matches_jax(monkeypatch, explicit,
                                                serving_env, kernels_env):
    """The explicit choice, then ``PADDLE_TPU_SERVING_ATTN``, then
    ``PADDLE_TPU_KERNELS``, then ``auto``: the same answer (or the same
    refusal) as the JAX package's."""
    for var, val in (("PADDLE_TPU_SERVING_ATTN", serving_env),
                     ("PADDLE_TPU_KERNELS", kernels_env)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    try:
        want = jax_resolve(explicit)
    except ValueError:
        with pytest.raises(ValueError, match="unknown serving attention"):
            decode.resolve_backend(explicit)
        return
    assert decode.resolve_backend(explicit) == want


@pytest.mark.parametrize("ragged", [True, False])
def test_auto_gate_on_the_cpu_reports_the_plain_version_untimed(
        mha, monkeypatch, ragged):
    """On a CPU engine ``auto`` times nothing (as the JAX gate skips the
    Pallas leg off the TPU) and reports the plain version; ``pallas`` and
    ``xla`` are taken as given there."""
    _, tm = mha
    monkeypatch.setattr(decode, "_event_ms", lambda *a, **k: pytest.fail(
        "the gate timed something on the CPU"))
    eng = _port(tm, attn_backend="auto", ragged=ragged)
    st = eng.stats()
    assert st["attn_backend"] == "xla"
    assert st["attn_ab"]["backend"] == "xla"
    assert st["attn_ab"]["xla_ms"] is None
    assert st["attn_ab"]["pallas_ms"] is None
    assert len(eng.generate([1, 2, 3], max_new_tokens=2)) == 2
    for b in ("pallas", "xla"):
        e = _port(tm, attn_backend=b, ragged=ragged)
        assert e.stats()["attn_backend"] == b and e.attn_ab is None


def test_xla_backend_is_refused_for_a_cuda_engine():
    """The plain version never serves the card: ``check_backend`` refuses
    ``xla`` for a CUDA device (the engine calls it before allocating),
    and takes every other choice."""
    with pytest.raises(ValueError, match="plain PyTorch version"):
        decode.check_backend("xla", "cuda")
    for b in ("pallas", "auto"):
        decode.check_backend(b, "cuda")
    decode.check_backend("xla", "cpu")
