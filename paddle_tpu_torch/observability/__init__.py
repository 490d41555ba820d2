"""Observability of the port — stdlib-only pieces, as in
``paddle_tpu/observability``:

* :mod:`.metrics` — env-gated (``PADDLE_TPU_METRICS=1``) Counter/Gauge/
  Histogram registry with per-rank JSONL snapshots.
* :mod:`.tracing` — ``span("name")`` host spans and per-request traces
  with tail sampling, exported as Chrome-trace/Perfetto JSON
  (``PADDLE_TPU_TRACE=1``).
* :mod:`.trace_report` — per-request phase attribution over exported
  traces, and its CLI.

The serving engine feeds the same registry and trace buffer. Disabled
(the default), every hook in the hot paths is a constant-time no-op. The
launcher report (``report.py``) and training telemetry (``telemetry.py``)
of the JAX package are not ported.
"""
from . import metrics  # noqa: F401
from . import trace_report  # noqa: F401
from . import tracing  # noqa: F401
from .metrics import MetricsRegistry, get_registry  # noqa: F401
from .tracing import span  # noqa: F401

__all__ = ["metrics", "tracing", "trace_report", "MetricsRegistry",
           "get_registry", "span"]
