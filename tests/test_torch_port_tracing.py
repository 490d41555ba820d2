"""The port's fault spec, metrics JSONL, request tracing and trace report
against the JAX package's, on the CPU.

Each test mirrors the JAX test it names (``tests/test_observability.py``,
``tests/test_request_tracing.py``, ``tests/test_fault_tolerance.py``) on
the port's own modules; where both packages run the same scenario
(``gpt_tiny`` with the same weights, page 4, 32 pages, 2 slots), the
per-request trace event names in order, the engine-lane round spans'
arguments and the flushed JSONL counters must be equal, and greedy tokens
exact.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.distributed import fault as jax_fault
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.observability import trace_report as jax_report
from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import ServingEngine
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.observability import metrics, trace_report, tracing
from tests.test_torch_port_ops import ENG, _models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    for var in ("PADDLE_TPU_TRACE", "PADDLE_TPU_TRACE_SAMPLE",
                "PADDLE_TPU_TRACE_SLOW_MS", "PADDLE_TPU_METRICS",
                "PADDLE_TPU_FAULTS", "PADDLE_TPU_FAULT_LEDGER"):
        monkeypatch.delenv(var, raising=False)
    metrics._reset_state()
    tracing._reset_state()
    yield
    metrics._reset_state()
    tracing._reset_state()
    fault._entries = None


@pytest.fixture(scope="module")
def mha():
    return _models(7)


# ------------------------------------------------------------- the faults

@pytest.mark.parametrize("spec", [
    "engine_die@serve_loop:3", "crash:2%1,slow_io@x:1",
    "engine_stall:1, hang@serve_loop:4%0", ""])
def test_fault_spec_parses_as_jax(spec):
    assert [e.key() for e in fault.parse_fault_spec(spec)] == \
        [e.key() for e in jax_fault.parse_fault_spec(spec)]


@pytest.mark.parametrize("spec", ["bogus:1", "engine_die@ckpt:1",
                                  "crash:0"])
def test_fault_spec_refusals(spec):
    with pytest.raises(ValueError):
        fault.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        jax_fault.parse_fault_spec(spec)


def test_maybe_inject_counts_hits_and_the_ledger_stops_a_refire(
        tmp_path, monkeypatch):
    """The Nth matching hit returns the cooperative kind once; a ledger
    file keeps a restarted process from firing it again."""
    ledger = tmp_path / "ledger"
    monkeypatch.setenv("PADDLE_TPU_FAULT_LEDGER", str(ledger))
    fault.set_fault_spec("engine_die@serve_loop:2")
    assert fault.maybe_inject("serve_loop") is None
    assert fault.maybe_inject("other_site") is None
    assert fault.maybe_inject("serve_loop") == "engine_die"
    assert fault.maybe_inject("serve_loop") is None
    assert ledger.read_text().split() == ["r0/engine_die@serve_loop:2"]
    fault.set_fault_spec("engine_die@serve_loop:2")   # a new incarnation
    assert [fault.maybe_inject("serve_loop") for _ in range(3)] == \
        [None] * 3


def test_exit_codes_and_descriptions_match_jax():
    for rc in (43, 75, 17, 19, 21, 64, 76, 47, 49, 0, 1, -9, -15):
        assert fault.describe_exit(rc) == jax_fault.describe_exit(rc)
    assert fault.EXIT_PREEMPT == jax_fault.EXIT_PREEMPT == 75


def test_preemption_scope_restores_the_previous_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with fault.preemption_scope() as scope:
        assert scope.installed
        assert signal.getsignal(signal.SIGTERM) is not prev
        os.kill(os.getpid(), signal.SIGTERM)
        assert scope.preempted() and fault.preempted()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert not fault.preempted()


# ------------------------------------------------------------ the metrics

def test_jsonl_snapshot_roundtrip(tmp_path):
    """Mirrors the JAX test: one cumulative snapshot a flush, in the JAX
    keys, at ``metrics.<rank>.jsonl``."""
    reg = metrics.enable(out_dir=str(tmp_path), interval_s=0, rank=3)
    reg.counter("steps_total").inc(2)
    reg.histogram("step_time_ms").observe(12.0)
    assert reg.flush() == str(tmp_path / "metrics.3.jsonl")
    reg.counter("steps_total").inc()
    reg.flush()
    lines = [json.loads(x) for x in
             open(tmp_path / "metrics.3.jsonl").read().splitlines()]
    assert len(lines) == 2
    assert sorted(lines[0]) == ["counters", "gauges", "histograms", "rank",
                                "seq", "ts"]
    assert lines[0]["rank"] == 3
    assert lines[0]["counters"]["steps_total"] == 2
    assert lines[1]["counters"]["steps_total"] == 3
    assert lines[1]["histograms"]["step_time_ms"]["count"] == 1


def test_metrics_env_gate_and_periodic_flusher(monkeypatch, tmp_path):
    """``PADDLE_TPU_METRICS=1`` with the workerlog dir as the fallback
    directory; a positive interval flushes on its own; off, every helper
    is a no-op."""
    assert metrics.get_registry() is None and not metrics.enabled()
    assert metrics.counter("x") is None and metrics.flush() is None
    metrics.observe("x", 1.0)
    metrics._reset_state()
    monkeypatch.setenv("PADDLE_TPU_METRICS", "1")
    monkeypatch.setenv("PADDLE_TPU_WORKERLOG_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_METRICS_INTERVAL_S", "0.05")
    reg = metrics.get_registry()
    assert reg is not None and reg.out_dir == str(tmp_path)
    metrics.counter("ticks_total").inc()
    metrics.gauge("g").set(2)
    metrics.observe("lat_ms", 3.0, kind="a")
    for _ in range(100):
        if reg.out_path() and os.path.exists(reg.out_path()):
            break
        import time
        time.sleep(0.02)
    row = json.loads(open(reg.out_path()).read().splitlines()[0])
    assert row["counters"] == {"ticks_total": 1}
    assert row["gauges"] == {"g": 2.0}
    assert row["histograms"]["lat_ms{kind=a}"]["count"] == 1
    metrics.disable()
    assert metrics.get_registry() is None


def test_hist_helpers_and_keys_match_jax():
    reg = metrics.MetricsRegistry()
    h = reg.histogram("h")
    for v in (1.5, 3, 3, 1000):
        h.observe(v)
    d = h.to_dict()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert metrics.hist_quantile(d, q) == jax_metrics.hist_quantile(d, q)
    assert metrics.hist_mean(d) == jax_metrics.hist_mean(d)
    assert metrics.hist_quantile({"count": 0, "bounds": [],
                                  "counts": []}, 0.5) is None
    key = metrics.metric_key("serving_phase_ms", {"phase": "decode",
                                                  "engine": "e0"})
    assert key == jax_metrics.metric_key("serving_phase_ms",
                                         {"phase": "decode",
                                          "engine": "e0"})
    assert metrics.parse_metric_key(key) == jax_metrics.parse_metric_key(key)


# ------------------------------------------------ the tracing buffer

def test_truncation_marker_and_drop_counter(monkeypatch, tmp_path):
    """Mirrors the JAX test: past ``_MAX_EVENTS`` the buffer drops
    visibly — one marker, a drop count, the registry metric."""
    monkeypatch.setattr(tracing, "_MAX_EVENTS", 4)
    reg = metrics.enable(out_dir=str(tmp_path), interval_s=0)
    buf = tracing.start(path=str(tmp_path / "t.json"), rank=0)
    for i in range(9):
        buf.add(f"ev{i}", i * 1.0, 0.5)
    assert buf.dropped == 5
    doc = buf.to_dict()
    marks = [e for e in doc["traceEvents"]
             if e.get("name") == "trace_truncated"]
    assert len(marks) == 1 and marks[0]["ph"] == "M"
    assert marks[0]["args"]["at_events"] == 4
    assert doc["droppedEvents"] == 5
    assert reg.snapshot()["counters"]["trace_events_dropped_total"] == 5
    tracing.stop()


def test_request_events_respect_cap(monkeypatch, tmp_path):
    monkeypatch.setattr(tracing, "_MAX_EVENTS", 2)
    buf = tracing.start(path=str(tmp_path / "t.json"), rank=0)
    ctx = tracing.mint_context()
    for i in range(6):
        tracing.req_event(ctx, f"s{i}", i * 1.0, 0.1)
    assert tracing.finish_request(ctx, error=True) is True
    assert buf.dropped >= 4


def test_tail_sampling_keep_and_drop(tmp_path):
    buf = tracing.start(path=str(tmp_path / "t.json"), rank=0)
    assert buf.sample_rate is None

    def n_request_events():
        return sum(1 for e in buf.events
                   if (e.get("args") or {}).get("trace"))

    ctx = tracing.mint_context()
    tracing.req_event(ctx, "queue_wait", 1.0, 0.5)
    assert tracing.finish_request(ctx, dur_s=0.01) is False
    assert n_request_events() == 0 and buf.req_traces_dropped == 1
    for kw in ({"error": True}, {"hedged": True}, {"evicted": True},
               {"aborted": True}, {"migrated": True}):
        c = tracing.mint_context()
        tracing.req_event(c, "queue_wait", 1.0, 0.5)
        assert tracing.finish_request(c, **kw) is True, kw
    assert n_request_events() == 5
    tracing.stop()


def test_tail_sampling_slow_threshold(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_TRACE_SLOW_MS", "100")
    buf = tracing.start(path=str(tmp_path / "t.json"), rank=0)
    assert buf.slow_ms == 100.0
    fast, slow = tracing.mint_context(), tracing.mint_context()
    tracing.req_event(fast, "decode", 1.0, 0.01)
    tracing.req_event(slow, "decode", 1.0, 0.5)
    assert tracing.finish_request(fast, dur_s=0.05) is False
    assert tracing.finish_request(slow, dur_s=0.5) is True
    tracing.stop()


def test_sampled_is_deterministic_and_equal_to_jax():
    """Every process hashes a trace id to the same verdict — the port's
    and the JAX package's included."""
    assert tracing.sampled("anything", 1.0) is True
    assert tracing.sampled("anything", 0.0) is False
    assert tracing.sampled("anything", None) is False
    ids = [os.urandom(8).hex() for _ in range(400)]
    verdicts = [tracing.sampled(t, 0.5) for t in ids]
    assert verdicts == [jax_tracing.sampled(t, 0.5) for t in ids]
    assert 80 < sum(verdicts) < 320


def test_verdict_gates_late_events(tmp_path):
    buf = tracing.start(path=str(tmp_path / "t.json"), rank=0)

    def names():
        return [e["name"] for e in buf.events
                if (e.get("args") or {}).get("trace")]

    kept = tracing.mint_context()
    tracing.req_event(kept, "route", 1.0, 0.1)
    assert tracing.finish_request(kept, hedged=True) is True
    tracing.req_event(kept, "hedge_lost", 2.0, 0.0)
    assert names() == ["route", "hedge_lost"]
    dropped = tracing.mint_context()
    tracing.req_event(dropped, "route", 1.0, 0.1)
    assert tracing.finish_request(dropped) is False
    tracing.req_event(dropped, "leg_abort", 2.0, 0.0)
    assert names() == ["route", "hedge_lost"]
    assert tracing.finish_request(dropped, error=True) is True
    tracing.req_event(dropped, "ledger_replay", 3.0, 0.0)
    assert names() == ["route", "hedge_lost", "ledger_replay"]
    tracing.stop()


def test_undecided_traces_flush_at_export_and_env_gate(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "t.json")
    tracing.start(path=path, rank=0)
    ctx = tracing.mint_context()
    tracing.req_event(ctx, "queue_wait", 1.0, 0.5)
    with tracing.span("host_work", cat="host", step=3):
        pass
    tracing.stop()
    doc = json.load(open(path))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"queue_wait", "host_work", "process_name"} <= names
    tracing._reset_state()
    env_path = str(tmp_path / "env.json")
    monkeypatch.setenv("PADDLE_TPU_TRACE", env_path)
    assert tracing.enabled() and tracing.get_buffer().path == env_path
    tracing.add_complete("x", 1.0, 0.1)
    assert tracing.export() == env_path


def test_mint_context_none_when_off():
    assert tracing.mint_context() is None
    tracing.req_event(None, "x", 0.0, 0.0)
    assert tracing.finish_request(None) is False
    with tracing.span("off") as buf:
        assert buf is None


# --------------------------------------------------- tracing the engine

@pytest.mark.parametrize("ragged", [True, False])
def test_tracing_off_structurally_zero_overhead(mha, monkeypatch, ragged):
    """Mirrors the JAX test: tracing off, the rounds and the serve loop
    make ZERO calls into the tracing feeds and mint no context."""
    calls = {"req_event": 0, "finish_request": 0, "add": 0, "req_add": 0}

    def count(key, ret=None):
        def h(*a, **k):
            calls[key] += 1
            return ret
        return h

    monkeypatch.setattr(tracing, "req_event", count("req_event"))
    monkeypatch.setattr(tracing, "finish_request",
                        count("finish_request", False))
    monkeypatch.setattr(tracing.TraceBuffer, "add", count("add"))
    monkeypatch.setattr(tracing.TraceBuffer, "req_add", count("req_add"))
    eng = ServingEngine(mha[1], ragged=ragged, **ENG)
    r1 = eng.submit([1, 2, 3, 4], max_new_tokens=3)
    while not r1.done():
        eng.step()
    assert r1.trace is None
    eng.start()
    r2 = eng.submit([5, 6, 7], max_new_tokens=3)
    assert len(r2.result(30)) == 3
    eng.close()
    assert calls == {"req_event": 0, "finish_request": 0, "add": 0,
                     "req_add": 0}


def _scenario(eng):
    """Three requests into two slots with chunked prefill, then the first
    prompt again (a prefix hit) -> the requests."""
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, 250, n).tolist() for n in (11, 9, 5)]
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run_until_idle()
    reqs.append(eng.submit(prompts[0], max_new_tokens=5))
    eng.run_until_idle()
    return reqs


def _traced(mod, eng, path):
    """The scenario on ``eng`` traced at sample rate 1 by ``mod`` ->
    (tokens, each request's event names in order, the round spans'
    arguments)."""
    os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "1"
    try:
        buf = mod.start(path=path, rank=0)
    finally:
        os.environ.pop("PADDLE_TPU_TRACE_SAMPLE")
    reqs = _scenario(eng)
    mod.stop()
    lanes = [[e["name"] for e in buf.events
              if (e.get("args") or {}).get("trace") == r.trace["tid"]]
             for r in reqs]
    rounds = [e["args"] for e in buf.events if e["name"] == "decode_round"]
    return [r.result(1) for r in reqs], lanes, rounds


@pytest.mark.parametrize("ragged", [True, False])
def test_request_trace_events_equal_jax(mha, tmp_path, ragged):
    """The same scenario traced in both packages: per request the same
    event names in the same order (enqueue … request_done, with
    queue_wait, prefix_hit, prefill_chunk, first_token, prefill and
    decode), the same round spans with the same arguments, and the same
    tokens as an untraced run."""
    jm, tm = mha
    kw = dict(ENG, prefill_chunk=6) if ragged else dict(ENG)
    untraced = [r.result(1) for r in _scenario(
        ServingEngine(tm, ragged=ragged, **kw))]
    jt = _traced(jax_tracing, JaxEngine(jm, attn_backend="xla", jit=False,
                                        ragged=ragged, **kw),
                 str(tmp_path / "jax.json"))
    pt_ = _traced(tracing, ServingEngine(tm, ragged=ragged, **kw),
                  str(tmp_path / "port.json"))
    assert pt_[0] == jt[0] == untraced
    assert pt_[1] == jt[1]
    assert pt_[2] == jt[2]
    for names in pt_[1]:
        assert names[0] == "enqueue" and names[-1] == "request_done"
        assert {"queue_wait", "prefill_chunk", "first_token", "prefill",
                "decode"} <= set(names)
    assert "prefix_hit" in pt_[1][3]
    rows = trace_report.build_request_rows(
        trace_report.load_events(str(tmp_path / "port.json")))
    assert len(rows) == 4
    assert all({"queue_wait", "prefill", "decode"} <= set(r["phases"])
               for r in rows.values())
    assert sum("prefix_hit" in r["flags"] for r in rows.values()) == 1


@pytest.mark.parametrize("ragged", [True, False])
def test_jsonl_counters_equal_jax(mha, tmp_path, ragged):
    """The same scenario with a registry in each package: the flushed
    JSONL counters (keys and values) are equal, and so are the gauge and
    histogram keys and the histograms' sample counts."""
    jm, tm = mha
    kw = dict(ENG, prefill_chunk=6) if ragged else dict(ENG)
    rows = []
    for make, reg in ((lambda r: JaxEngine(jm, attn_backend="xla",
                                           jit=False, ragged=ragged,
                                           registry=r, engine_id="e0",
                                           **kw),
                       jax_metrics.MetricsRegistry(
                           rank=0, out_dir=str(tmp_path / "jax"))),
                      (lambda r: ServingEngine(tm, ragged=ragged,
                                               registry=r, engine_id="e0",
                                               **kw),
                       metrics.MetricsRegistry(
                           rank=0, out_dir=str(tmp_path / "port")))):
        _scenario(make(reg))
        reg.flush()
        rows.append(json.loads(open(reg.out_path()).read().splitlines()[-1]))
    jrow, prow = rows
    assert prow["counters"] == jrow["counters"]
    assert prow["counters"]["serving_requests_total{engine=e0,status=ok}"] \
        == 4
    assert sorted(prow["gauges"]) == sorted(jrow["gauges"])
    assert {k: v["count"] for k, v in prow["histograms"].items()} == \
        {k: v["count"] for k, v in jrow["histograms"].items()}


# ------------------------------------------------------ the trace report

def _synthetic_trace(path, tid="feedbeef", pid=0, t0=1000.0):
    us = 1e6
    evs = [
        {"name": "client_submit", "ts": t0 * us, "dur": 0.001 * us,
         "pid": pid, "args": {"trace": tid, "rid": "r1"}},
        {"name": "queue_wait", "ts": (t0 + 0.01) * us, "dur": 0.02 * us,
         "pid": pid, "args": {"trace": tid}},
        {"name": "prefill", "ts": (t0 + 0.03) * us, "dur": 0.05 * us,
         "pid": pid + 1, "args": {"trace": tid}},
        {"name": "decode", "ts": (t0 + 0.08) * us, "dur": 0.1 * us,
         "pid": pid + 1, "args": {"trace": tid}},
        {"name": "hedge_fired", "ts": (t0 + 0.09) * us, "dur": 0.0,
         "pid": pid, "args": {"trace": tid, "engine": "e1"}},
        {"name": "stream_token", "ts": (t0 + 0.1) * us, "dur": 0.0,
         "pid": pid, "args": {"trace": tid, "i": 0}},
        {"name": "fleet_done", "ts": (t0 + 0.18) * us, "dur": 0.0,
         "pid": pid, "args": {"trace": tid, "state": "finished",
                              "hedged": True}},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": [dict(e, ph="X", tid=1, cat="request")
                                   for e in evs]}, f)


def test_trace_report_rows_flags_and_dedup_equal_jax(tmp_path):
    """Mirrors the JAX report tests: phases, flags, token and process
    counts, and a merged copy of the same events counted once — the port's
    rows, report and text equal the JAX module's."""
    _synthetic_trace(tmp_path / "trace.0.json")
    src = json.load(open(tmp_path / "trace.0.json"))["traceEvents"]
    with open(tmp_path / "merged.json", "w") as f:
        json.dump({"traceEvents": [{**e, "pid": 7} for e in src]}, f)
    rows = trace_report.build_request_rows(
        trace_report.load_events(str(tmp_path)))
    r = rows["feedbeef"]
    assert r["procs"] == 2 and r["tokens"] == 1 and r["events"] == 7
    assert "hedged" in r["flags"]
    assert r["phases"]["prefill"] == pytest.approx(50.0, abs=1e-6)
    assert r["e2e_ms"] == pytest.approx(180.0, abs=1e-3)
    assert rows == jax_report.build_request_rows(
        jax_report.load_events(str(tmp_path)))
    assert trace_report.rows_to_report(rows, top=3) == \
        jax_report.rows_to_report(rows, top=3)
    assert trace_report.format_request_rows(rows) == \
        jax_report.format_request_rows(rows)


def test_trace_report_cli(tmp_path):
    _synthetic_trace(tmp_path / "trace.0.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "paddle_tpu_torch.observability.trace_report"]
    out = subprocess.run(run + [str(tmp_path), "--top", "5"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "feedbeef" in out.stdout and "slowest" in out.stdout
    js = subprocess.run(run + [str(tmp_path / "trace.0.json"), "--json"],
                        capture_output=True, text=True, env=env, timeout=120)
    assert json.loads(js.stdout)[0]["trace"] == "feedbeef"
    empty = tmp_path / "empty"
    empty.mkdir()
    assert subprocess.run(run + [str(empty)], capture_output=True,
                          env=env, timeout=120).returncode == 1
