"""Serving metrics — TTFT, inter-token latency, throughput, KV occupancy.

The port of ``paddle_tpu/serving/metrics.py`` for one engine. Everything
lands in the registry of :mod:`paddle_tpu_torch.observability.metrics`
(``PADDLE_TPU_METRICS=1``). Names:

* ``serving_requests_total{status=ok|failed|evicted}`` — counters
  (``evicted`` counts preemptions, not terminal states)
* ``serving_tokens_total`` — generated tokens
* ``serving_ttft_ms`` / ``serving_inter_token_ms`` / ``serving_e2e_ms`` /
  ``serving_queue_wait_ms`` — latency histograms
* ``serving_phase_ms{phase=queue_wait|prefill|decode}`` — per-phase
  latency histograms
* ``serving_qps`` / ``serving_tokens_per_sec`` — finished requests/s and
  generated tokens/s over a sliding window
* ``serving_active_slots`` / ``serving_queue_depth`` /
  ``serving_kv_occupancy_pct`` — gauges sampled every round
* ``serving_prefix_{hits,misses,hit_tokens}_total`` — prefix-cache
  admission counters; ``serving_prefix_shared_pages`` /
  ``serving_prefix_cached_pages`` — page gauges
* ``serving_prefill_chunk_tokens_total`` — prefill tokens processed
* ``serving_compiles_total`` / ``serving_distinct_programs`` — the
  shape-specialised programs the engine installed (ragged token pads,
  prefill/chunk bucket pairs, the decode step), as the JAX engine counts
  its compiles

``engine="e0"`` labels every row. Every hook is a no-op when the registry
is off (one ``None`` check).
"""
from __future__ import annotations

import time
from collections import deque

from ..observability import metrics as _metrics

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """Per-engine metrics frontend over the process registry."""

    def __init__(self, registry=None, window_s=30.0, prefix_enabled=True,
                 engine=None):
        self._reg = registry if registry is not None \
            else _metrics.get_registry()
        self.window_s = float(window_s)
        self._labels = {"engine": str(engine)} if engine is not None \
            else {}
        # engines without a prefix cache export no prefix family (every
        # request would read as a miss)
        self.prefix_enabled = bool(prefix_enabled)
        self._finish_times: deque = deque()
        self._token_times: deque = deque()

    @property
    def enabled(self):
        return self._reg is not None

    def _trim(self, dq, now):
        cutoff = now - self.window_s
        while dq and dq[0] < cutoff:
            dq.popleft()

    def _counter(self, name, **extra):
        return self._reg.counter(name, **self._labels, **extra)

    def _gauge(self, name):
        return self._reg.gauge(name, **self._labels)

    def _hist(self, name):
        return self._reg.histogram(name, **self._labels)

    def on_phase(self, phase, dur_s):
        reg = self._reg
        if reg is None or dur_s is None:
            return
        reg.histogram("serving_phase_ms", **self._labels,
                      phase=str(phase)).observe(max(0.0, dur_s) * 1e3)

    def on_admit(self, req):
        if self._reg is None or req.t_admit is None:
            return
        self.on_phase("queue_wait", req.t_admit - req.t_enqueue)
        # request-level prefix hit/miss: FIRST admission only
        if self.prefix_enabled and req.evictions == 0:
            if req.prefix_hit_tokens > 0:
                self._counter("serving_prefix_hits_total").inc()
                self._counter("serving_prefix_hit_tokens_total").inc(
                    req.prefix_hit_tokens)
            else:
                self._counter("serving_prefix_misses_total").inc()

    def on_first_token(self, req):
        if self._reg is None:
            return
        ttft = req.ttft_s()
        if ttft is not None:
            self._hist("serving_ttft_ms").observe(ttft * 1e3)
        if req.t_admit is not None and req.t_first_token is not None:
            self.on_phase("prefill", req.t_first_token - req.t_admit)

    def on_token(self, req, dt_s=None):
        if self._reg is None:
            return
        self._counter("serving_tokens_total").inc()
        if dt_s is not None:
            self._hist("serving_inter_token_ms").observe(dt_s * 1e3)
        now = time.perf_counter()
        self._token_times.append(now)
        self._trim(self._token_times, now)
        span = now - self._token_times[0]
        if len(self._token_times) > 1 and span > 0:
            self._gauge("serving_tokens_per_sec").set(
                (len(self._token_times) - 1) / span)

    def on_evict(self, req):
        if self._reg is None:
            return
        self._counter("serving_evictions_total").inc()
        self._counter("serving_requests_total", status="evicted").inc()

    def on_finish(self, req):
        if self._reg is None:
            return
        status = "failed" if req.error is not None else "ok"
        self._counter("serving_requests_total", status=status).inc()
        # cumulative queue wait, observed once at the terminal state
        self._hist("serving_queue_wait_ms").observe(req.queue_wait_s * 1e3)
        if req.t_done is not None:
            self._hist("serving_e2e_ms").observe(
                (req.t_done - req.t_submit) * 1e3)
            if req.t_first_token is not None:
                self.on_phase("decode", req.t_done - req.t_first_token)
        now = time.perf_counter()
        self._finish_times.append(now)
        self._trim(self._finish_times, now)
        span = now - self._finish_times[0]
        if len(self._finish_times) > 1 and span > 0:
            self._gauge("serving_qps").set(
                (len(self._finish_times) - 1) / span)

    def sample_state(self, active_slots, queue_depth, occupancy_pct,
                     shared_pages=None, cached_pages=None):
        if self._reg is None:
            return
        self._gauge("serving_active_slots").set(active_slots)
        self._gauge("serving_queue_depth").set(queue_depth)
        self._gauge("serving_kv_occupancy_pct").set(occupancy_pct)
        if shared_pages is not None:
            self._gauge("serving_prefix_shared_pages").set(shared_pages)
        if cached_pages is not None:
            self._gauge("serving_prefix_cached_pages").set(cached_pages)

    def on_prefill_chunk(self, n_tokens):
        if self._reg is None:
            return
        self._counter("serving_prefill_chunk_tokens_total").inc(n_tokens)

    def on_compile(self, distinct_programs):
        """The engine installed a NEW shape-specialised program (a ragged
        token pad, a prefill/chunk bucket pair or the decode step): the
        bounded program surface as a measured number."""
        if self._reg is None:
            return
        self._counter("serving_compiles_total").inc()
        self._gauge("serving_distinct_programs").set(distinct_programs)
