"""Observability of the port — stdlib-only pieces, as in
``paddle_tpu/observability``:

* :mod:`.metrics` — env-gated (``PADDLE_TPU_METRICS=1``) Counter/Gauge/
  Histogram registry with per-rank JSONL snapshots.
* :mod:`.tracing` — ``span("name")`` host spans and per-request traces
  with tail sampling, exported as Chrome-trace/Perfetto JSON
  (``PADDLE_TPU_TRACE=1``).
* :mod:`.trace_report` — per-request phase attribution over exported
  traces, and its CLI.
* :mod:`.telemetry` — the per-step training clock ``hapi.Model.fit``
  attaches (step time split into data wait, compute and sync; tokens/s;
  MFU against :func:`.metrics.peak_flops`), and its
  :class:`~.telemetry.TelemetryCallback`.
* :mod:`.report` — the launcher's cross-rank run report over the
  per-rank metrics snapshots.

The serving engine feeds the same registry and trace buffer. Disabled
(the default), every hook in the hot paths is a constant-time no-op.
"""
from . import metrics  # noqa: F401
from . import report  # noqa: F401
from . import telemetry  # noqa: F401
from . import trace_report  # noqa: F401
from . import tracing  # noqa: F401
from .metrics import MetricsRegistry, get_registry  # noqa: F401
from .telemetry import TelemetryCallback  # noqa: F401
from .tracing import span  # noqa: F401

__all__ = ["metrics", "tracing", "trace_report", "telemetry", "report",
           "MetricsRegistry", "TelemetryCallback", "get_registry", "span"]
