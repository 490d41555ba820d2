"""Metrics registry — lock-cheap counters, gauges and histograms, and
their JSONL snapshots.

The port of ``paddle_tpu/observability/metrics.py`` (stdlib only):

* :class:`Counter` / :class:`Gauge` / :class:`Histogram` with labels;
  latency histograms use exponential buckets so one 24-bucket vector
  spans 1..8.4e6 (µs or ms) with constant relative error.
* One process-wide :class:`MetricsRegistry`, env-gated
  (``PADDLE_TPU_METRICS=1``; unset = every hook is a constant-time
  no-op: one module-global ``None`` check, no allocation).
* Periodic JSONL snapshots, one per line, into
  ``<dir>/metrics.<rank>.jsonl`` (``PADDLE_TPU_METRICS_DIR``, falling
  back to the launcher's ``PADDLE_TPU_WORKERLOG_DIR``; interval
  ``PADDLE_TPU_METRICS_INTERVAL_S``, default 10 s, 0 = explicit flushes
  only) plus an atexit flush. Each line holds ``ts``, ``rank``, ``seq``,
  ``counters``, ``gauges`` and ``histograms``, as the JAX package writes
  them.

* :func:`peak_flops` — the card's dense bf16 peak for training
  telemetry's MFU: NVIDIA's data sheet for the H100 SXM (989 TFLOP/s) and
  PCIe (756 TFLOP/s) parts; ``PADDLE_TPU_PEAK_FLOPS`` overrides. The JAX
  module's TPU entries are not carried over: an unknown card gives no MFU.

The collective and replication helpers of the JAX module are not ported.
"""
from __future__ import annotations

import atexit
import bisect
import json
import os
import sys
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "env_rank",
           "exp_buckets", "get_registry", "enabled", "enable", "disable",
           "metric_key", "parse_metric_key", "counter", "gauge",
           "histogram", "observe", "observe_collective",
           "observe_replication", "flush", "hist_quantile", "hist_mean",
           "peak_flops"]


def env_rank() -> int:
    """This process's rank for artifact naming — the launcher-exported
    id chain (one copy, shared with the trace buffer)."""
    return int(os.environ.get(
        "PADDLE_TPU_PROCESS_ID",
        os.environ.get("PADDLE_TRAINER_ID", "0")) or 0)


def exp_buckets(start=1.0, factor=2.0, count=24):
    """Exponential bucket upper bounds ``[start, start*factor, ...]``."""
    out = []
    b = float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return out


# default latency buckets: 1 .. ~8.4e6 (microseconds or milliseconds)
_DEFAULT_BOUNDS = tuple(exp_buckets(1.0, 2.0, 24))


def metric_key(name, labels=None):
    """Canonical flat key: ``name`` or ``name{k=v,k2=v2}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_metric_key(key):
    """Inverse of :func:`metric_key` -> (name, labels dict)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for part in rest.rstrip("}").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    """Monotonic counter (a short lock keeps cross-thread increments
    exact)."""

    __slots__ = ("key", "value", "_lock")

    def __init__(self, key):
        self.key = key
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Gauge:
    """Last-value metric."""

    __slots__ = ("key", "value")

    def __init__(self, key):
        self.key = key
        self.value = None

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (upper bounds + overflow) with sum/count/
    min/max, good enough for p50/p99 without keeping samples."""

    __slots__ = ("key", "bounds", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, key, bounds=None):
        self.key = key
        self.bounds = tuple(bounds) if bounds else _DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def to_dict(self):
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self.counts),
                    "count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max}


def hist_quantile(h, q):
    """Quantile estimate from a histogram dict (``Histogram.to_dict`` or a
    JSONL-deserialized one); linear within the winning bucket. Returns
    None for an empty histogram."""
    count = h.get("count") or 0
    if count <= 0:
        return None
    bounds = h["bounds"]
    counts = h["counts"]
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i] if i < len(bounds) else (h.get("max") or bounds[-1])
        if cum + c >= target:
            frac = (target - cum) / c
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        cum += c
    return h.get("max")


def hist_mean(h):
    count = h.get("count") or 0
    return (h.get("sum", 0.0) / count) if count else None


class MetricsRegistry:
    """Process-wide metric store + JSONL snapshot writer: ``flush()``
    appends one snapshot line to :meth:`out_path`, and with ``out_dir``
    and ``interval_s > 0`` a daemon thread flushes every ``interval_s``
    seconds until :meth:`close`."""

    def __init__(self, rank=None, out_dir=None, interval_s=0.0):
        self.rank = env_rank() if rank is None else int(rank)
        self.out_dir = out_dir
        self.interval_s = float(interval_s or 0.0)
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        if self.out_dir and self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._flusher, name="paddle-tpu-torch-metrics",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ children
    def _child(self, cls, name, labels, *args):
        key = metric_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(key, *args)
                    self._metrics[key] = m
        return m

    def counter(self, name, **labels) -> Counter:
        return self._child(Counter, name, labels)

    def gauge(self, name, **labels) -> Gauge:
        return self._child(Gauge, name, labels)

    def histogram(self, name, bounds=None, **labels) -> Histogram:
        return self._child(Histogram, name, labels, bounds)

    # ------------------------------------------------------------ snapshot
    def snapshot(self):
        """One JSON-ready dict of everything (counters cumulative)."""
        with self._lock:
            items = list(self._metrics.items())
        self._seq += 1
        out = {"ts": time.time(), "rank": self.rank, "seq": self._seq,
               "counters": {}, "gauges": {}, "histograms": {}}
        for key, m in items:
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                if m.value is not None:
                    out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.to_dict()
        return out

    def out_path(self):
        if not self.out_dir:
            return None
        return os.path.join(self.out_dir, f"metrics.{self.rank}.jsonl")

    def flush(self):
        """Append one snapshot line; returns the path (None when no dir is
        configured or nothing was ever recorded)."""
        path = self.out_path()
        if path is None:
            return None
        with self._lock:
            empty = not self._metrics
        if empty:
            return None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(self.snapshot(), default=str) + "\n")
        except OSError as e:  # telemetry must never kill the job
            print(f"[metrics] flush to {path} failed: {e}",
                  file=sys.stderr, flush=True)
            return None
        return path

    def _flusher(self):
        while not self._stop.wait(self.interval_s):
            self.flush()

    def close(self):
        self._stop.set()
        self.flush()


# ------------------------------------------------- module-level singleton

_state_lock = threading.Lock()
_REG: MetricsRegistry | None = None
_loaded = False
_atexit_armed = False


def _arm_atexit():
    global _atexit_armed
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(_atexit_flush)


def _atexit_flush():
    reg = _REG
    if reg is not None:
        reg.flush()


def _load():
    """Resolve the env gate once: ``PADDLE_TPU_METRICS=1`` enables the
    registry; snapshots land in ``PADDLE_TPU_METRICS_DIR`` (falling back
    to ``PADDLE_TPU_WORKERLOG_DIR``) every ``PADDLE_TPU_METRICS_INTERVAL_S``
    seconds (default 10; 0 = explicit flushes only)."""
    global _REG, _loaded
    with _state_lock:
        if _loaded:
            return _REG
        on = os.environ.get("PADDLE_TPU_METRICS", "")
        if on not in ("", "0", "false", "False"):
            out_dir = (os.environ.get("PADDLE_TPU_METRICS_DIR")
                       or os.environ.get("PADDLE_TPU_WORKERLOG_DIR"))
            try:
                interval = float(
                    os.environ.get("PADDLE_TPU_METRICS_INTERVAL_S", "10")
                    or 0)
            except ValueError:
                interval = 10.0
            _REG = MetricsRegistry(out_dir=out_dir, interval_s=interval)
            _arm_atexit()
        else:
            _REG = None
        _loaded = True
        return _REG


def get_registry() -> MetricsRegistry | None:
    """The env-gated singleton registry, or None when metrics are off."""
    return _REG if _loaded else _load()


def enabled() -> bool:
    return get_registry() is not None


def enable(out_dir=None, interval_s=0.0, rank=None) -> MetricsRegistry:
    """Programmatic gate (tests / bench) — replaces the singleton."""
    global _REG, _loaded
    with _state_lock:
        if _REG is not None:
            _REG.close()
        _REG = MetricsRegistry(rank=rank, out_dir=out_dir,
                               interval_s=interval_s)
        _loaded = True
        _arm_atexit()
        return _REG


def disable():
    global _REG, _loaded
    with _state_lock:
        if _REG is not None:
            _REG.close()
        _REG = None
        _loaded = True


def _reset_state():
    """Test hook: back to the unresolved env-gated state."""
    global _REG, _loaded
    with _state_lock:
        if _REG is not None:
            _REG._stop.set()
        _REG = None
        _loaded = False


# ------------------------------------------------------ no-op-safe helpers

def counter(name, **labels) -> Counter | None:
    reg = _REG if _loaded else _load()
    return reg.counter(name, **labels) if reg is not None else None


def gauge(name, **labels) -> Gauge | None:
    reg = _REG if _loaded else _load()
    return reg.gauge(name, **labels) if reg is not None else None


def histogram(name, bounds=None, **labels) -> Histogram | None:
    reg = _REG if _loaded else _load()
    return reg.histogram(name, bounds, **labels) if reg is not None \
        else None


def observe(name, value, **labels):
    reg = _REG if _loaded else _load()
    if reg is not None:
        reg.histogram(name, **labels).observe(value)


def flush():
    reg = _REG if _loaded else _load()
    return reg.flush() if reg is not None else None


def observe_collective(entry):
    """Feed one completed flight-recorder ring entry into the per-
    kind x group latency histogram and the wire-volume counter
    (``paddle_tpu/observability/metrics.py:415``). Called from
    ``FlightRecorder.complete``; one ``None`` check when metrics are off.
    ``step``-group markers (heartbeats, resume markers) and aborted
    entries are skipped; ``pipe``-group entries are compute and go to
    ``pipeline_latency_us``. An awaited asynchronous collective that
    carries ``t_wait`` and ``device_synced`` adds its issue-to-wait window
    to the overlap counters (``comm_overlap_pct``)."""
    reg = _REG if _loaded else _load()
    if reg is None or entry is None:
        return
    group = entry.get("group", "?")
    if group == "step" or entry.get("aborted"):
        return
    t0, t1 = entry.get("t_issue"), entry.get("t_complete")
    if t0 is None or t1 is None:
        return
    kind = entry.get("kind", "?")
    family = "pipeline_latency_us" if group == "pipe" \
        else "collective_latency_us"
    reg.histogram(family, kind=kind, group=group).observe(
        (t1 - t0) * 1e6)
    if group == "pipe":
        return
    nbytes = entry.get("nbytes")
    if nbytes:
        reg.counter("collective_bytes_total", kind=kind).inc(int(nbytes))
    t_w = entry.get("t_wait")
    if t_w is not None and entry.get("device_synced"):
        inflight_us = (t1 - t0) * 1e6
        hidden_us = min(max((t_w - t0) * 1e6, 0.0), inflight_us)
        c_in = reg.counter("comm_inflight_us_total")
        c_hid = reg.counter("comm_overlapped_us_total")
        c_in.inc(inflight_us)
        c_hid.inc(hidden_us)
        if c_in.value > 0:
            reg.gauge("comm_overlap_pct").set(
                100.0 * c_hid.value / c_in.value)


def observe_replication(head_seq, acked_seq, shipped=0, torn=0):
    """Replication-plane telemetry of the log-shipped store failover
    (``paddle_tpu/observability/metrics.py:467``):
    ``store_replication_lag`` gauge (primary WAL head minus the standby's
    acked seq) plus shipped/torn counters. Called from
    ``distributed.tcp_store.LogShipper.ship_once``; one ``None`` check
    when metrics are off."""
    reg = _REG if _loaded else _load()
    if reg is None:
        return
    reg.gauge("store_replication_lag").set(
        max(0, int(head_seq) - int(acked_seq)))
    if shipped:
        reg.counter("store_wal_shipped_total").inc(int(shipped))
    if torn:
        reg.counter("store_wal_torn_total").inc(int(torn))


# ---------------------------------------------------------- hardware table

def peak_flops(device_kind=""):
    """Dense bf16 peak FLOP/s of the card named ``device_kind`` (as
    ``torch.cuda.get_device_name()`` gives it), or None for a card the
    table does not hold. ``PADDLE_TPU_PEAK_FLOPS`` overrides (CPU plumbing
    runs)."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    kind = str(device_kind).lower()
    if "h100" in kind and "pcie" in kind:
        return 756e12
    if "h100" in kind and ("hbm3" in kind or "sxm" in kind):
        return 989e12
    return None
