"""Host-side span tracing — Chrome-trace/Perfetto JSON export.

The port of ``paddle_tpu/observability/tracing.py`` (stdlib only): what
the HOST did around the device's work. ``span("name")`` context managers
and :func:`add_complete` become ``ph: "X"`` complete events on this
process's lane; the export loads in chrome://tracing / ui.perfetto.dev.

Gating mirrors the metrics registry: ``PADDLE_TPU_TRACE=1`` (export path
from ``PADDLE_TPU_TRACE_PATH``, default ``trace.<rank>.json`` under
``PADDLE_TPU_WORKERLOG_DIR``; ``PADDLE_TPU_TRACE=/path.json`` sets both),
or programmatic :func:`start` / :func:`stop`, with an atexit export.
Disabled (the default), ``span()`` yields off one module-global ``None``
check and the feeds return without allocating.

Timestamps are ``time.time()`` µs, one wall clock for every process, so
traces of several processes line up in one timeline.

Request tracing: :func:`mint_context` mints a trace context
(``{"tid": <hex id>, "ps": <parent span, 0 = root>}``); the scheduler and
the engine feed that request's spans through :func:`req_event` into a
per-trace pending buffer, and the terminal :func:`finish_request` applies
TAIL-BASED sampling — the trace is retained (flushed onto the main buffer,
on its own per-request lane) only when the request erred, hedged,
evicted, aborted, migrated, was slow (``PADDLE_TPU_TRACE_SLOW_MS``), or
hits the deterministic sample (``PADDLE_TPU_TRACE_SAMPLE=<rate>``, hashed
from the trace id so every process makes the same decision). Everything
else is dropped before export; a verdict also gates the trace's later
events. Undecided traces still pending at export time are flushed as they
are, so a shutdown mid-request stays visible. The buffer holds at most
``_MAX_EVENTS`` events: the first drop leaves one ``trace_truncated``
marker, and every drop counts in ``dropped`` and the
``trace_events_dropped_total`` metric.

The flight recorder's collective events of the JAX module are not ported.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import sys
import threading
import time
import zlib

from . import metrics as _metrics

__all__ = ["TraceBuffer", "span", "add_complete", "collective_event",
           "mint_context",
           "req_event", "sampled", "finish_request", "enabled",
           "get_buffer", "start", "stop", "export", "_reset_state"]

_MAX_EVENTS = 200_000  # runaway guard: ~40MB of JSON at most
_DECIDED_CAP = 4096    # remembered tail-sampling verdicts (FIFO)
_PENDING_CAP = 1024    # simultaneously-undecided request traces

_SAMPLE_ENV = "PADDLE_TPU_TRACE_SAMPLE"
_SLOW_ENV = "PADDLE_TPU_TRACE_SLOW_MS"


def _env_float(name):
    raw = os.environ.get(name, "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _tid_bucket(tid):
    """Deterministic 32-bit hash of a trace id — identical in every
    process, so the sampling verdict needs no coordination."""
    return zlib.crc32(str(tid).encode("utf-8", "replace"))


def _metric_drop(n=1):
    c = _metrics.counter("trace_events_dropped_total")
    if c is not None:
        c.inc(n)


class TraceBuffer:
    """Append-only buffer of chrome-trace events for ONE process."""

    def __init__(self, rank=None, path=None):
        self.rank = _metrics.env_rank() if rank is None else int(rank)
        self.path = path
        self.events = []
        self._lock = threading.Lock()
        self.dropped = 0
        # -------- request tracing (tail-based sampling) state
        self._req = {}              # tid -> pending event list
        self._decided = {}          # tid -> kept? (post-terminal verdict)
        self._decided_order = collections.deque()
        self._named_lanes = set()   # tids whose lane got a thread_name
        self.req_traces_dropped = 0
        self.sample_rate = _env_float(_SAMPLE_ENV)
        self.slow_ms = _env_float(_SLOW_ENV)

    def _append_locked(self, ev):
        """Append under self._lock; at the cap the FIRST drop leaves one
        over-cap metadata marker so a truncated export never silently
        looks complete. Returns False when the event was dropped."""
        if len(self.events) >= _MAX_EVENTS:
            if self.dropped == 0:
                self.events.append({
                    "name": "trace_truncated", "ph": "M",
                    "pid": self.rank,
                    "args": {"at_events": _MAX_EVENTS,
                             "wall_us": time.time() * 1e6}})
            self.dropped += 1
            return False
        self.events.append(ev)
        return True

    def add(self, name, ts_s, dur_s, cat="host", tid=None, args=None):
        ev = {"name": str(name), "ph": "X", "pid": self.rank,
              "tid": tid if tid is not None else threading.get_ident(),
              "ts": ts_s * 1e6, "dur": max(0.0, dur_s) * 1e6, "cat": cat}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            ok = self._append_locked(ev)
        if not ok:
            _metric_drop()

    # ---------------------------------------------- request-trace feeds

    def _lane(self, tid):
        return _tid_bucket(tid)

    def _name_lane_locked(self, tid):
        if tid in self._named_lanes:
            return
        self._named_lanes.add(tid)
        self._append_locked({
            "name": "thread_name", "ph": "M", "pid": self.rank,
            "tid": self._lane(tid), "args": {"name": f"req {tid}"}})

    def req_add(self, tid, name, ts_s, dur_s, cat="request", args=None):
        """Buffer one span for request ``tid`` pending its tail-sampling
        verdict; post-verdict events append (kept) or vanish (dropped)
        directly."""
        a = {"trace": tid}
        if args:
            a.update(args)
        ev = {"name": str(name), "ph": "X", "pid": self.rank,
              "tid": self._lane(tid), "ts": ts_s * 1e6,
              "dur": max(0.0, dur_s) * 1e6, "cat": cat, "args": a}
        dropped = False
        with self._lock:
            verdict = self._decided.get(tid)
            if verdict is False:
                return
            if verdict is True:
                dropped = not self._append_locked(ev)
            else:
                pend = self._req.get(tid)
                if pend is None:
                    if len(self._req) >= _PENDING_CAP:
                        dropped = True    # overflow: runaway guard
                    else:
                        self._req[tid] = pend = []
                if pend is not None:
                    pend.append(ev)
        if dropped:
            _metric_drop()

    def req_finish(self, tid, keep):
        """Apply the tail-sampling verdict for ``tid``: flush (keep) or
        discard its pending spans. A later ``keep`` upgrades an earlier
        drop verdict for FUTURE events (the already-dropped ones are
        gone). Returns the effective verdict."""
        lost = 0
        with self._lock:
            pending = self._req.pop(tid, None)
            prior = self._decided.get(tid)
            if prior is True:
                keep = True
            elif prior is None:
                self._decided[tid] = bool(keep)
                self._decided_order.append(tid)
                while len(self._decided_order) > _DECIDED_CAP:
                    old = self._decided_order.popleft()
                    self._decided.pop(old, None)
                    self._named_lanes.discard(old)
            elif keep:
                self._decided[tid] = True
            if not keep:
                if pending:
                    self.req_traces_dropped += 1
                return False
            if pending:
                self._name_lane_locked(tid)
                for ev in pending:
                    if not self._append_locked(ev):
                        lost += 1
        if lost:
            _metric_drop(lost)
        return True

    def _flush_pending_locked(self):
        """Export-time flush of still-undecided traces (process exiting
        mid-request): keep them so the shutdown stays visible."""
        for tid, pending in list(self._req.items()):
            self._name_lane_locked(tid)
            for ev in pending:
                self._append_locked(ev)
        self._req.clear()

    def to_dict(self):
        with self._lock:
            self._flush_pending_locked()
            events = list(self.events)
            dropped = self.dropped
        meta = [{"name": "process_name", "ph": "M", "pid": self.rank,
                 "args": {"name": f"rank_{self.rank} host"}},
                # clock provenance: host spans stamp time.time() µs, so
                # lanes from another clock domain can be shifted onto
                # this one
                {"name": "clock_domain", "ph": "M", "pid": self.rank,
                 "args": {"domain": "wall", "export_wall_us":
                          time.time() * 1e6}}]
        d = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if dropped:
            d["droppedEvents"] = dropped
        return d

    def export(self, path=None):
        path = path or self.path
        if not path:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


# ------------------------------------------------- module-level singleton

_state_lock = threading.Lock()
_TR: TraceBuffer | None = None
_loaded = False
_atexit_armed = False


def _default_path(rank):
    d = os.environ.get("PADDLE_TPU_WORKERLOG_DIR") or "."
    return os.path.join(d, f"trace.{rank}.json")


def _load():
    global _TR, _loaded
    with _state_lock:
        if _loaded:
            return _TR
        raw = os.environ.get("PADDLE_TPU_TRACE", "")
        if raw in ("", "0", "false", "False"):
            _TR = None
        else:
            buf = TraceBuffer()
            if raw not in ("1", "true", "True"):
                buf.path = raw  # PADDLE_TPU_TRACE=/path.json
            else:
                buf.path = (os.environ.get("PADDLE_TPU_TRACE_PATH")
                            or _default_path(buf.rank))
            _TR = buf
            _arm_atexit()
        _loaded = True
        return _TR


def _arm_atexit():
    global _atexit_armed
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(_atexit_export)


def _atexit_export():
    buf = _TR
    if buf is not None and buf.path:
        try:
            buf.export()
        except (OSError, TypeError, ValueError) as e:
            print(f"[trace] export at exit failed: {e}", file=sys.stderr,
                  flush=True)


def get_buffer() -> TraceBuffer | None:
    return _TR if _loaded else _load()


def enabled() -> bool:
    return get_buffer() is not None


def start(path=None, rank=None) -> TraceBuffer:
    """Programmatic gate (tests / bench) — replaces the singleton."""
    global _TR, _loaded
    with _state_lock:
        _TR = TraceBuffer(rank=rank, path=path)
        _loaded = True
        _arm_atexit()
        return _TR


def stop(path=None):
    """Export (when a path is known) and disable; returns the path."""
    global _TR, _loaded
    with _state_lock:
        buf = _TR
        _TR = None
        _loaded = True
    if buf is None:
        return None
    try:
        return buf.export(path)
    except (OSError, TypeError, ValueError) as e:
        print(f"[trace] export failed: {e}", file=sys.stderr, flush=True)
        return None


def export(path=None):
    buf = _TR if _loaded else _load()
    return buf.export(path) if buf is not None else None


def _reset_state():
    """Test hook: back to the unresolved env-gated state."""
    global _TR, _loaded
    with _state_lock:
        _TR = None
        _loaded = False


# ------------------------------------------------------------------ feeds

@contextlib.contextmanager
def span(name, cat="host", **args):
    """Trace one host scope; a constant-time no-op when tracing is off."""
    buf = _TR if _loaded else _load()
    if buf is None:
        yield None
        return
    t0 = time.time()
    try:
        yield buf
    finally:
        buf.add(name, t0, time.time() - t0, cat=cat, args=args or None)


def add_complete(name, ts_s, dur_s, cat="host", tid=None, args=None):
    buf = _TR if _loaded else _load()
    if buf is not None:
        buf.add(name, ts_s, dur_s, cat=cat, tid=tid, args=args)


def collective_event(entry):
    """Feed one completed flight-recorder entry as a trace event
    (``paddle_tpu/observability/tracing.py:434``). ``step``-group markers
    and aborted entries are skipped; pipeline micro-batch entries keep a
    category of their own, so the collective lane holds collectives
    only."""
    buf = _TR if _loaded else _load()
    if buf is None or entry is None:
        return
    group = entry.get("group")
    if group == "step" or entry.get("aborted"):
        return
    t0, t1 = entry.get("t_issue"), entry.get("t_complete")
    if t0 is None or t1 is None:
        return
    cat = "pipeline" if group == "pipe" else "collective"
    args = {"group": group, "seq": entry.get("seq"),
            "gseq": entry.get("gseq")}
    if entry.get("shape") is not None:
        args["shape"] = str(entry["shape"])
    buf.add(entry.get("kind", "?"), t0, t1 - t0, cat=cat, args=args)


# -------------------------------------------------- request-trace feeds
#
# Hot-path discipline (the standing contract): tracing off, a request
# never gets a context minted, so every hook in the scheduler and engine
# gates on ``req.trace is not None`` — one attribute check, no
# allocation, no call into this module.

def mint_context():
    """-> a fresh trace context ``{"tid", "ps"}`` (``ps`` 0 = root) when
    tracing is on, else None. The None is what makes the off path free:
    downstream hooks check the attribute, not this module."""
    buf = _TR if _loaded else _load()
    if buf is None:
        return None
    return {"tid": os.urandom(8).hex(), "ps": 0}


def _ctx_tid(ctx):
    if type(ctx) is dict:
        tid = ctx.get("tid")
        return str(tid) if tid else None
    return None


def req_event(ctx, name, ts_s, dur_s, cat="request", args=None):
    """Feed one span for the request identified by trace context ``ctx``
    into the tail-sampling pending buffer. No-op off / ctx-less."""
    buf = _TR if _loaded else _load()
    if buf is None or ctx is None:
        return
    tid = _ctx_tid(ctx)
    if tid is not None:
        buf.req_add(tid, name, ts_s, dur_s, cat=cat, args=args)


def sampled(tid, rate):
    """Deterministic head-of-trace sample: every process hashes the same
    trace id to the same verdict — no coordination, no wire bits."""
    if not rate or rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return (_tid_bucket(tid) % 100_000) / 100_000.0 < rate


def finish_request(ctx, dur_s=None, error=False, hedged=False,
                   evicted=False, aborted=False, migrated=False):
    """Terminal-state tail-sampling decision for one request trace:
    retain when interesting (errored / hedged / evicted / aborted /
    migrated), slow (``PADDLE_TPU_TRACE_SLOW_MS``), or explicitly
    sampled (``PADDLE_TPU_TRACE_SAMPLE``); else drop the pending spans
    before they ever reach the export. Returns the verdict."""
    buf = _TR if _loaded else _load()
    if buf is None or ctx is None:
        return False
    tid = _ctx_tid(ctx)
    if tid is None:
        return False
    keep = bool(error or hedged or evicted or aborted or migrated)
    if not keep and buf.slow_ms is not None and dur_s is not None \
            and dur_s * 1e3 >= buf.slow_ms:
        keep = True
    if not keep:
        keep = sampled(tid, buf.sample_rate)
    return buf.req_finish(tid, keep)
