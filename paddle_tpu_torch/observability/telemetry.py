"""Per-step training telemetry — step-time breakdown, tokens/sec, MFU,
after ``paddle_tpu/observability/telemetry.py``.

Threaded through ``hapi.Model.fit`` as a :class:`TelemetryCallback`
(auto-attached when ``PADDLE_TPU_METRICS=1``; attach explicitly to pass
a known ``flops_per_step``). Per step it records into the metrics
registry:

* ``step_time_ms`` — wall time between consecutive batch completions,
  split into ``data_wait_ms`` (loader/iterator stall before the batch was
  available), ``compute_ms`` (dispatching the train step) and
  ``sync_ms`` (the blocking device→host loss fetch — under CUDA's
  asynchronous launches this is where the host actually waits for the
  card).
  Under the fused donated train step the fit loop AMORTIZES that fetch
  (``loss_fetch_every``): steps without a fetch observe ``sync_ms=0`` and
  a dispatch-only ``compute_ms``, while the fetch step's ``sync_ms``
  covers the whole window the device ran ahead — the split degrades
  gracefully instead of forcing a per-step pipeline drain. ``step_time_ms``
  (and therefore tokens/sec and MFU) is wall-clock between batch ends and
  stays exact either way;
* ``tokens_per_sec`` / ``tokens_total`` — tokens = batch×seq for integer
  token inputs, leading batch dim otherwise;
* ``mfu_pct`` — achieved fraction of the chip's peak FLOP/s, estimated
  from ``hapi.dynamic_flops`` on the real input shape (×3 for fwd+bwd+
  update) with a ``6·N·tokens`` parameter-count fallback, against
  ``metrics.peak_flops`` of the card the model lives on (no MFU on the
  CPU or on a card the table does not hold).

When tracing is on, the same measurements land as nested
``step``/``data_wait``/``compute``/``sync`` spans in the Perfetto export.

The fit loop calls :meth:`TelemetryCallback.batch_ready` when a batch
arrives and ``Model.train_batch`` calls :func:`mark_sync_begin` right
before its blocking loss fetch; both are constant-time no-ops when
metrics are off (fit never constructs the callback).

Stdlib-only at import time; torch is touched lazily (the card's name for
the MFU peak) and only when metrics are on.
"""
from __future__ import annotations

import time

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["TelemetryCallback", "EMATimer", "maybe_telemetry_callback",
           "mark_sync_begin"]


class EMATimer:
    """Exponential-moving-average interval timer (the telemetry clock
    ProgBarLogger renders ``ips``/smoothed step-time from)."""

    def __init__(self, alpha=0.3):
        self.alpha = float(alpha)
        self.ema = None
        self._last = None

    def reset(self):
        self._last = None

    def tick(self, now=None):
        """-> (dt, ema) seconds; (None, None) on the first tick."""
        now = time.perf_counter() if now is None else now
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else \
                self.alpha * dt + (1 - self.alpha) * self.ema
        self._last = now
        return dt, self.ema


_active: "TelemetryCallback | None" = None


def mark_sync_begin():
    """Hot-path hook (``Model.train_batch``): stamp where compute ends and
    the blocking device sync begins. One global ``None`` check when
    telemetry is inactive."""
    cb = _active
    if cb is not None:
        cb._sync_t0 = time.perf_counter()


def maybe_telemetry_callback(model=None):
    """A :class:`TelemetryCallback` when metrics are enabled, else None —
    the fit loops' one-line auto-attach."""
    if _metrics.get_registry() is None:
        return None
    cb = TelemetryCallback()
    if model is not None:
        cb.set_model(model)
    return cb


def _tokens_of(x):
    """Tokens in one batch: batch×seq for integer token ids (LLM-style
    inputs), the leading batch dim otherwise."""
    shape = getattr(x, "shape", None)
    if not shape:
        return 1
    try:
        dt = str(getattr(x, "dtype", ""))
        if len(shape) >= 2 and ("int" in dt or "uint" in dt):
            return int(shape[0]) * int(shape[1])
    except Exception:
        pass
    return int(shape[0])


class TelemetryCallback:
    """hapi-compatible callback (duck-typed: no import of hapi here) that
    owns the per-step clock. Reusable standalone::

        cb = TelemetryCallback(flops_per_step=6 * n_params * tokens)
        model.fit(ds, callbacks=[cb])
    """

    stop_training = False

    def __init__(self, registry=None, flops_per_step=None,
                 tokens_per_batch=None, flush_every=50):
        self._registry = registry
        self.flops_per_step = flops_per_step
        self.tokens_per_batch = tokens_per_batch
        self.flush_every = int(flush_every)
        self.model = None
        self.params = None
        self.last_step_ms = None
        self._reg = None
        self._peak = None
        self._flops_failed = flops_per_step is not None
        self._t_prev = None        # previous batch completion
        self._t_ready = None       # this batch became available
        self._sync_t0 = None
        self._steps = 0

    # ---- hapi Callback surface ------------------------------------------
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        global _active
        self._reg = self._registry or _metrics.get_registry()
        _active = self if self._reg is not None else _active
        self._t_prev = None
        self._t_ready = None

    def on_train_end(self, logs=None):
        # idempotent: fit's error path runs this from a finally AND the
        # normal callback loop runs it on success
        global _active
        if _active is self:
            _active = None
        reg, self._reg = self._reg, None
        if reg is not None:
            reg.flush()

    def on_epoch_begin(self, epoch, logs=None):
        # an epoch boundary (eval, checkpoint, reshuffle) is not data wait
        self._t_prev = None

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    # ---- the clock -------------------------------------------------------
    def note_pause(self):
        """Non-training work between steps (an interval checkpoint save,
        an eval pass): restamp the clock so the pause lands in NEITHER
        the next step_time_ms nor its data_wait_ms — without this, a
        synchronous snapshot would read as an input-pipeline stall."""
        if self._reg is not None and self._t_prev is not None:
            self._t_prev = time.perf_counter()

    def batch_ready(self, x=None):
        """The fit loop got a batch from the loader: data wait ends."""
        self._t_ready = time.perf_counter()
        self._sync_t0 = None
        if self.tokens_per_batch is None and x is not None:
            self._batch_tokens = _tokens_of(x)
        else:
            self._batch_tokens = self.tokens_per_batch or 1
        if self.flops_per_step is None and not self._flops_failed \
                and x is not None:
            self._probe_flops(x)

    def on_train_batch_end(self, step, logs=None):
        reg = self._reg
        if reg is None:
            return
        now = time.perf_counter()
        ready = self._t_ready if self._t_ready is not None else now
        prev = self._t_prev
        self._t_prev = now
        self._t_ready = None
        data_wait = (ready - prev) if prev is not None else 0.0
        sync_t0 = self._sync_t0
        compute = ((sync_t0 or now) - ready)
        sync = (now - sync_t0) if sync_t0 is not None else 0.0
        step_time = (now - prev) if prev is not None \
            else (compute + sync)
        self.last_step_ms = step_time * 1e3
        reg.counter("steps_total").inc()
        reg.histogram("step_time_ms").observe(step_time * 1e3)
        reg.histogram("data_wait_ms").observe(max(0.0, data_wait) * 1e3)
        reg.histogram("compute_ms").observe(max(0.0, compute) * 1e3)
        reg.histogram("sync_ms").observe(max(0.0, sync) * 1e3)
        tokens = getattr(self, "_batch_tokens", 1)
        if tokens and step_time > 0:
            reg.counter("tokens_total").inc(tokens)
            reg.gauge("tokens_per_sec").set(tokens / step_time)
        if self.flops_per_step and step_time > 0:
            peak = self._peak_flops()
            if peak:
                reg.gauge("mfu_pct").set(
                    100.0 * self.flops_per_step / step_time / peak)
        if _tracing.enabled():
            wall = time.time()
            t_end = wall
            t_start = t_end - step_time
            _tracing.add_complete("step", t_start, step_time, cat="step",
                                  args={"step": step})
            if data_wait > 0:
                _tracing.add_complete("data_wait", t_start,
                                      min(data_wait, step_time))
            t_ready_wall = t_end - (compute + sync)
            _tracing.add_complete("compute", t_ready_wall,
                                  max(0.0, compute))
            if sync > 0:
                _tracing.add_complete("sync", t_end - sync, sync)
        self._steps += 1
        if self.flush_every and self._steps % self.flush_every == 0:
            reg.flush()

    # ---- MFU plumbing ----------------------------------------------------
    def _peak_flops(self):
        if self._peak is None:
            kind = ""
            net = getattr(self.model, "network", None) or self.model
            p = next(iter(getattr(net, "parameters", list)()), None)
            if p is not None and p.device.type == "cuda":
                import torch
                kind = torch.cuda.get_device_name(p.device)
            self._peak = _metrics.peak_flops(kind) or 0.0
        return self._peak

    def _probe_flops(self, x):
        """One-shot fwd-FLOPs probe on the REAL input shape via
        hapi.dynamic_flops (×3 for fwd+bwd+update), falling back to the
        6·N·tokens parameter-count rule. Any failure disables MFU rather
        than training."""
        self._flops_failed = True  # sticky: probe at most once
        net = getattr(self.model, "network", None) or self.model
        if net is None:
            return
        shape = getattr(x, "shape", None)
        try:
            from ..hapi.dynamic_flops import flops as _flops
            fwd = int(_flops(net, list(shape)))
            if fwd > 0:  # 0 = nothing hookable (e.g. a bare leaf layer)
                self.flops_per_step = 3 * fwd
                return
        except Exception:
            pass
        try:
            n_params = sum(p.numel() for p in net.parameters())
            tokens = getattr(self, "_batch_tokens", 1)
            if n_params and tokens:
                self.flops_per_step = 6 * n_params * tokens
        except Exception:
            pass
