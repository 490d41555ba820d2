"""Training-step watchdog — the native heartbeat watchdog wired around
the training loop: the port's copy of ``paddle_tpu/distributed/
watchdog.py``.

Reference: CommTaskManager (comm_task_manager.cc:153) scans comm tasks and
aborts hung comms. The failure mode is a step blocking forever (a
collective whose peer died, a wedged kernel, a hung data source); the
controller thread is stuck, so recovery happens off-thread.

Escalation: the native watchdog (``core/native/tcp_store.cpp``) only
FLAGS the trip; a Python monitor thread (a hung native call or sleep
releases the GIL, so it still runs) dumps the flight recorder +
all-thread stacks into the workerlog dir, publishes its last seq to the
store, gathers peers' to compute blame, then exits ``EXIT_HANG`` (19) —
a distinct code the launcher maps and follows with a per-rank
post-mortem. A second native watchdog armed for the escalation budget
(and never beaten) is the backstop: if the diagnosis itself wedges, the
process still dies — with the blind ``_exit(17)``.

Enable with env ``PADDLE_TPU_WATCHDOG_TIMEOUT=<seconds>`` (the launcher
forwards it) or explicitly via :func:`start_step_watchdog`. Every staged
train step (``jit.to_static(..., capture=...)``, which ``Model.fit``'s
step is) beats it, in its replayed and its eager calls alike.
"""
from __future__ import annotations

import os
import sys
import threading
import time

_watchdog = None
_monitor = None
_disabled = False
_atexit_registered = False
_lock = threading.Lock()


class _EscalationMonitor(threading.Thread):
    """Polls the native watchdog's tripped flag; on trip runs the
    dump -> publish -> blame -> abort pipeline."""

    def __init__(self, native, timeout_seconds):
        super().__init__(name="pd-watchdog-escalation", daemon=True)
        self._native = native
        self._timeout_s = float(timeout_seconds)
        self._cancel = threading.Event()

    def cancel(self):
        self._cancel.set()

    def run(self):
        while not self._cancel.wait(0.05):
            try:
                tripped = self._native.tripped
            except Exception:
                return  # native handle torn down under us: disarmed
            if tripped:
                self._escalate()
                return

    def _escalate(self):
        from . import fault as _fault
        from . import flight_recorder as _fr
        from .tcp_store import Watchdog as _Native
        budget = float(os.environ.get(
            "PADDLE_TPU_WATCHDOG_ESCALATION_BUDGET_S", "10"))
        # backstop: never beaten — if the diagnosis below wedges (store
        # mutex, disk hang), the native thread still ends the process.
        # The reference is held: a GC'd Watchdog stops its native thread.
        self._backstop = _Native(timeout_seconds=budget, abort_on_trip=True)
        t0 = time.monotonic()
        print(f"[pd_watchdog] no heartbeat within "
              f"{int(self._timeout_s * 1000)} ms - collective presumed "
              "hung, aborting process after flight-recorder dump",
              file=sys.stderr, flush=True)
        try:
            _fr.watchdog_escalation(self._timeout_s, budget)
        except Exception as e:  # escalation must never block the abort
            print(f"[pd_watchdog] escalation failed: {e}", file=sys.stderr,
                  flush=True)
        print(f"[pd_watchdog] escalation done in "
              f"{time.monotonic() - t0:.2f}s; exiting "
              f"{_fault.EXIT_HANG}", file=sys.stderr, flush=True)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(_fault.EXIT_HANG)


def start_step_watchdog(timeout_seconds: float, abort_on_trip: bool = True):
    """Arm (or re-arm) the global per-step watchdog. ``abort_on_trip``
    arms the escalation monitor (dump + blame + ``EXIT_HANG``); False
    leaves a flag-only watchdog for callers that poll ``tripped``."""
    global _watchdog, _monitor, _disabled
    import atexit

    from .tcp_store import Watchdog
    with _lock:
        _stop_locked()
        # the native watchdog never aborts directly anymore: the monitor
        # owns the abort so the flight recorder gets dumped first
        _watchdog = Watchdog(timeout_seconds=timeout_seconds,
                             abort_on_trip=False)
        if abort_on_trip:
            _monitor = _EscalationMonitor(_watchdog, timeout_seconds)
            _monitor.start()
        _disabled = False
        global _atexit_registered
        if not _atexit_registered:
            atexit.register(stop_step_watchdog)  # normal exit must disarm
            _atexit_registered = True
    return _watchdog


def _stop_locked():
    global _watchdog, _monitor
    if _monitor is not None:
        _monitor.cancel()
        _monitor.join(timeout=1.0)
        _monitor = None
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


def stop_step_watchdog():
    """Disarm durably: beat()/get_step_watchdog() will NOT re-arm from the
    env var afterwards (a finished train loop followed by slow eval or
    checkpointing must not be shot by a stale timeout)."""
    global _disabled
    with _lock:
        _stop_locked()
        _disabled = True


def get_step_watchdog():
    """The armed watchdog, auto-arming from PADDLE_TPU_WATCHDOG_TIMEOUT
    (unless durably stopped via stop_step_watchdog)."""
    global _watchdog
    if _watchdog is None and not _disabled:
        t = os.environ.get("PADDLE_TPU_WATCHDOG_TIMEOUT")
        if t:
            start_step_watchdog(float(t))
    return _watchdog


def beat():
    """Heartbeat — called by the training-step entry points. The beat lands
    BEFORE the step executes: if the step hangs, the missing next beat
    trips the timeout. Doubles as the chaos harness's ``step`` injection
    site: every staged train step (``to_static`` whole-step call, both
    pipeline ``train_batch`` paths) funnels through here, so
    ``crash@step:N`` fires deterministically before the Nth step runs —
    and ``hang@step:N`` freezes this rank BEFORE it records the step's
    heartbeat, so the flight-recorder blame points at it."""
    from . import fault as _fault
    _fault.maybe_inject("step")
    from . import flight_recorder as _fr
    _fr.note_heartbeat()
    wd = get_step_watchdog()
    if wd is not None:
        wd.beat()
