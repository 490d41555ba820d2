"""Fault injection and graceful preemption for the serving engine.

The part of ``paddle_tpu/distributed/fault.py`` that the port's serving
engine uses, kept as the port's own copy (stdlib only):

1. **Exit codes** — ``EXIT_*`` and :func:`describe_exit`, the one mapping
   of a worker's exit code to its cause. ``EXIT_PREEMPT`` (75,
   EX_TEMPFAIL) marks a graceful, resumable exit.
2. **Injection points** — ``maybe_inject(site)``, driven by
   ``PADDLE_TPU_FAULTS`` (or :func:`set_fault_spec`) with the grammar::

       spec    := entry ("," entry)*
       entry   := kind ["@" site] ":" trigger ["%" rank]
       trigger := 1-based Nth matching hit that fires the fault
       rank    := only this process id injects (default: every rank)

   Counting is hit-based, with no randomness, so a spec reproduces the
   same failure every run. ``crash`` (exits ``EXIT_FAULT``), ``hang``,
   ``slow_io`` and ``engine_stall`` execute here; ``engine_die`` is
   cooperative: ``maybe_inject`` returns the kind and the serving
   engine's serve loop enacts it (``PADDLE_TPU_FAULT_ENGINE`` narrows it
   to one engine id). A fired entry is recorded in the ledger file named
   by ``PADDLE_TPU_FAULT_LEDGER`` so a restarted process does not fire it
   again.
3. **Graceful preemption** — :func:`install_preemption_handler` turns
   SIGTERM into a flag (or a callback and ``EXIT_PREEMPT``);
   :func:`preempted` polls it, :func:`exit_preempted` leaves with 75 and
   :class:`preemption_scope` installs and restores the handler around a
   block.
4. **Atomic writes** — :func:`atomic_write` / :func:`atomic_write_bytes`
   (``fault.py:495-517``), which ``framework/io.py``'s ``save`` publishes
   through.

The JAX module's other kinds (checkpoint, store, collective, router and
linear-algebra sites), its backoff and checkpoint lineage are not
ported.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time

__all__ = [
    "EXIT_FAULT", "EXIT_PREEMPT", "EXIT_WATCHDOG", "EXIT_HANG",
    "EXIT_DESYNC", "EXIT_USAGE", "EXIT_DEPOSED", "EXIT_ORACLE",
    "EXIT_INTEGRITY", "EXIT_CAUSES", "describe_exit",
    "FaultEntry", "parse_fault_spec", "set_fault_spec", "maybe_inject",
    "fault_rank",
    "install_preemption_handler", "preempted", "exit_preempted",
    "preemption_scope", "atomic_write", "atomic_write_bytes",
]

EXIT_FAULT = 43      # injected crash — a real failure, consumes a restart
EXIT_PREEMPT = 75    # graceful preemption (EX_TEMPFAIL) — resumable free
EXIT_WATCHDOG = 17   # native watchdog abort
EXIT_HANG = 19       # watchdog escalation: dump + blame, then abort
EXIT_DESYNC = 21     # collective desync detected before issue
EXIT_USAGE = 64      # launcher flag combination rejected (EX_USAGE)
EXIT_DEPOSED = 76    # control-plane coordinator deposed (EX_PROTOCOL)
EXIT_ORACLE = 47     # numerical-correctness oracle violated
EXIT_INTEGRITY = 49  # training integrity guard exhausted its rewinds

EXIT_CAUSES = {
    EXIT_FAULT: "injected chaos crash",
    EXIT_PREEMPT: "graceful preemption (resumable, does not consume "
                  "restarts)",
    EXIT_WATCHDOG: "hung collective — native watchdog abort (no dump: "
                   "escalation backstop)",
    EXIT_HANG: "hung collective — watchdog escalated: flight-recorder "
               "dump + blame written",
    EXIT_DESYNC: "collective desync — mismatched collective detected "
                 "before issue (fail-fast)",
    EXIT_USAGE: "launcher usage error — incompatible flag combination "
                "(see the hint printed above it)",
    EXIT_DEPOSED: "coordinator deposed — a shadow coordinator took over "
                  "the lease term; this instance yielded (writes fenced)",
    EXIT_ORACLE: "numerical oracle violated — a dlinalg residual/"
                 "orthogonality gate failed (silent corruption made loud)",
    EXIT_INTEGRITY: "training integrity guard exhausted — sustained loss/"
                    "gradient anomaly survived max_rewinds rewind-and-skip "
                    "attempts (SDC, poisoned data or divergence: a human "
                    "looks, restarts would loop)",
}


def describe_exit(rc) -> str:
    """'rc=<n>: <cause>' for known worker exit codes; signal names for
    negative codes; bare 'rc=<n>' otherwise."""
    cause = EXIT_CAUSES.get(rc)
    if cause is None and isinstance(rc, int) and rc < 0:
        try:
            cause = f"killed by {signal.Signals(-rc).name}"
        except ValueError:
            cause = None
    return f"rc={rc}: {cause}" if cause else f"rc={rc}"


# the kinds that act at the serving sites: crash / hang / slow_io execute
# at any site; engine_stall sleeps and engine_die is returned to the serve
# loop, which enacts a crash of its own loop
_KINDS = ("crash", "hang", "slow_io", "engine_die", "engine_stall")
# a site-less (wildcard) cooperative entry only fires at sites whose
# callers honour the returned kind — anywhere else it would burn its
# trigger silently
_WILDCARD_SITES = {"engine_die": ("serve_loop",),
                   "engine_stall": ("serve_loop",)}

_lock = threading.Lock()
_entries: list | None = None  # parsed spec; None = not yet loaded from env


def fault_rank() -> int:
    """This process's rank for %rank filters and the ledger namespace."""
    return int(os.environ.get("PADDLE_TPU_PROCESS_ID",
                              os.environ.get("PADDLE_TRAINER_ID", "0")))


class FaultEntry:
    __slots__ = ("kind", "site", "trigger", "rank", "hits", "fired")

    def __init__(self, kind, site=None, trigger=1, rank=None):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {_KINDS})")
        self.kind = kind
        self.site = site
        honored = _WILDCARD_SITES.get(kind)
        if honored is not None and site is not None and site not in honored:
            # a cooperative fault at a site that ignores the returned kind
            # would burn its trigger while enacting nothing
            raise ValueError(
                f"cooperative fault {kind!r} is only honored at site(s) "
                f"{honored}, not '@{site}'")
        self.trigger = int(trigger)
        if self.trigger < 1:
            raise ValueError(f"fault trigger must be >= 1, got {trigger}")
        self.rank = rank
        self.hits = 0
        self.fired = False

    def key(self) -> str:
        """Canonical spec form — the ledger identity of this entry."""
        s = self.kind + (f"@{self.site}" if self.site else "")
        s += f":{self.trigger}"
        if self.rank is not None:
            s += f"%{self.rank}"
        return s

    def matches(self, site: str, rank: int) -> bool:
        if self.rank is not None and self.rank != rank:
            return False
        if self.site is not None:
            return self.site == site
        honored = _WILDCARD_SITES.get(self.kind)
        return honored is None or site in honored

    def __repr__(self):
        return f"FaultEntry({self.key()})"


def parse_fault_spec(spec: str) -> list:
    """Parse ``kind[@site]:trigger[%rank]`` comma-separated entries."""
    entries = []
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        body, rank = raw, None
        if "%" in body:
            body, r = body.rsplit("%", 1)
            rank = int(r)
        trigger = 1
        if ":" in body:
            body, t = body.rsplit(":", 1)
            trigger = int(t)
        if "@" in body:
            kind, site = body.split("@", 1)
        else:
            kind, site = body, None
        entries.append(FaultEntry(kind.strip(),
                                  site.strip() if site else None,
                                  trigger, rank))
    return entries


def _ledger_path():
    return os.environ.get("PADDLE_TPU_FAULT_LEDGER")


def _apply_ledger_locked(entries):
    """Mark entries this rank already fired in a previous incarnation."""
    path = _ledger_path()
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            fired = {line.strip() for line in f if line.strip()}
    except OSError:
        return
    me = f"r{fault_rank()}/"
    for e in entries:
        if me + e.key() in fired:
            e.fired = True


def _record_fired(entry):
    """Persist the firing durably BEFORE executing it — a crash fault must
    not fire again after the launcher restarts this rank."""
    entry.fired = True
    path = _ledger_path()
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(f"r{fault_rank()}/{entry.key()}\n")
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        pass


def set_fault_spec(spec):
    """Install a fault spec programmatically (None/"" clears all faults)."""
    global _entries
    with _lock:
        _entries = parse_fault_spec(spec) if spec else []
        _apply_ledger_locked(_entries)
    return list(_entries)


def _get_entries():
    global _entries
    if _entries is None:
        with _lock:
            if _entries is None:
                loaded = parse_fault_spec(
                    os.environ.get("PADDLE_TPU_FAULTS", ""))
                _apply_ledger_locked(loaded)
                _entries = loaded
    return _entries


def maybe_inject(site: str):
    """Fault-injection hook; a cheap no-op unless a spec is configured.
    -> a cooperative fault kind (``"engine_die"``) the caller must enact,
    or None. ``crash``, ``hang``, ``slow_io`` and ``engine_stall`` are
    executed here."""
    entries = _get_entries()
    if not entries:
        return None
    rank = fault_rank()
    result = None
    for e in entries:
        if not e.matches(site, rank):
            continue
        with _lock:
            if e.fired:
                continue
            e.hits += 1
            if e.hits != e.trigger:
                continue
            _record_fired(e)
        print(f"[fault] rank {rank}: injecting {e.kind} at site "
              f"'{site}' (entry {e.key()})", file=sys.stderr, flush=True)
        if e.kind == "crash":
            sys.stdout.flush()
            os._exit(EXIT_FAULT)
        elif e.kind == "hang":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_HANG_S", "3600")))
        elif e.kind == "slow_io":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_SLOW_IO_S", "1.0")))
        elif e.kind == "engine_stall":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_ENGINE_STALL_S", "30.0")))
        else:
            result = e.kind
    return result


# ----------------------------------------------------------- atomic write

def atomic_write(path, write_fn) -> None:
    """Durable atomic file publish: ``write_fn(f)`` streams into a
    same-dir temp file, then flush+fsync+rename — a kill at any point
    leaves either the old file or the complete new one, never a torn
    write."""
    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path, data) -> None:
    atomic_write(path, lambda f: f.write(data))


# ------------------------------------------------------------- preemption

_preempt_event = threading.Event()
_preempt_cb = None


def install_preemption_handler(on_preempt=None):
    """Turn SIGTERM into graceful preemption.

    With ``on_preempt`` the handler runs it and exits ``EXIT_PREEMPT``.
    Without a callback the handler only sets a flag; the caller polls
    :func:`preempted` and drains at a safe point (the safe default: work
    started from a signal frame could deadlock on a lock the interrupted
    thread holds). Returns True if the handler was installed (main thread
    only)."""
    global _preempt_cb
    _preempt_cb = on_preempt

    def _handler(signum, frame):
        _preempt_event.set()
        print("[fault] SIGTERM: graceful preemption requested",
              file=sys.stderr, flush=True)
        if _preempt_cb is not None:
            try:
                _preempt_cb()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(EXIT_PREEMPT)

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread
        return False
    return True


def preempted() -> bool:
    """True once SIGTERM arrived — poll at step boundaries."""
    return _preempt_event.is_set()


def exit_preempted(save_fn=None):
    """Run the final save (if any) and exit with the resumable code."""
    if save_fn is not None:
        save_fn()
    sys.stdout.flush()
    sys.stderr.flush()
    sys.exit(EXIT_PREEMPT)


class preemption_scope:
    """Scoped SIGTERM -> drain -> exit-75 watcher: installs the handler on
    entry and restores the previous SIGTERM disposition, callback and flag
    state on exit, so scopes nest and a library never clobbers its
    host application's handler. Without ``on_preempt``, poll
    :meth:`preempted` and call :meth:`exit` to leave with
    ``EXIT_PREEMPT``."""

    def __init__(self, on_preempt=None):
        self._on_preempt = on_preempt
        self._prev_handler = None
        self._prev_cb = None
        self._was_set = False
        self.installed = False

    def __enter__(self):
        self._prev_cb = _preempt_cb
        self._was_set = _preempt_event.is_set()
        try:
            self._prev_handler = signal.getsignal(signal.SIGTERM)
        except (ValueError, OSError):
            self._prev_handler = None
        self.installed = install_preemption_handler(self._on_preempt)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _preempt_cb
        _preempt_cb = self._prev_cb
        if not self._was_set:
            _preempt_event.clear()
        if self.installed and self._prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except (ValueError, OSError):
                pass
        return False

    @staticmethod
    def preempted() -> bool:
        return preempted()

    @staticmethod
    def exit(save_fn=None):
        exit_preempted(save_fn)
