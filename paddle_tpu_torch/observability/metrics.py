"""Metrics registry — lock-cheap counters, gauges and histograms.

The registry half of ``paddle_tpu/observability/metrics.py`` (stdlib
only): :class:`Counter` / :class:`Gauge` / :class:`Histogram` with labels
and one process-wide :class:`MetricsRegistry` gated by
``PADDLE_TPU_METRICS=1`` (unset: every hook is a constant-time no-op);
:meth:`MetricsRegistry.snapshot` reads everything as one dict. The JSONL
writer and the collective, replication and peak-rate helpers of the JAX
package are not ported yet.
"""
from __future__ import annotations

import bisect
import os
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "exp_buckets", "metric_key", "get_registry"]


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


class MetricsRegistry:
    """Process-wide metric store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._seq = 0

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

    def snapshot(self):
        """One JSON-ready dict of everything (counters cumulative)."""
        with self._lock:
            items = list(self._metrics.items())
        self._seq += 1
        out = {"ts": time.time(), "seq": self._seq,
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


_state_lock = threading.Lock()
_REG: MetricsRegistry | None = None
_loaded = False


def get_registry() -> MetricsRegistry | None:
    """The env-gated singleton registry, or None when metrics are off."""
    global _REG, _loaded
    if _loaded:
        return _REG
    with _state_lock:
        if not _loaded:
            on = os.environ.get("PADDLE_TPU_METRICS", "")
            _REG = MetricsRegistry() \
                if on not in ("", "0", "false", "False") else None
            _loaded = True
    return _REG
