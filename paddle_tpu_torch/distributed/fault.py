"""Deterministic fault injection + end-to-end crash/preempt recovery:
the port's copy of ``paddle_tpu/distributed/fault.py``, kept whole (the
same kinds, sites, exit codes, ``describe_exit`` text and lineage) so a
fault spec, a ledger and a snapshot lineage mean the same in both
packages. ``framework/io.py``'s ``save`` publishes through
:func:`atomic_write`.

Four pieces, stdlib-only (importable by the launcher before torch
loads):

1. **Injection points** — ``maybe_inject(site)`` is threaded through the
   distributed stack (collectives, checkpoint writers, the TCPStore, the
   staged train-step entry). Faults are driven by ``PADDLE_TPU_FAULTS``
   (or :func:`set_fault_spec`) with the grammar::

       spec    := entry ("," entry)*
       entry   := kind ["@" site] ":" trigger ["%" rank]
       kind    := crash | hang | torn_write | store_drop | slow_io
                | async_torn | commit_stall | desync
                | node_die | agent_stall | store_die
                | engine_die | engine_stall
                | router_die | router_stall
       trigger := 1-based Nth matching hit that fires the fault
       rank    := only this process id injects (default: every rank;
                  node-scoped kinds filter by NODE ordinal — the agent
                  exports its ordinal as its own process id)

   e.g. ``PADDLE_TPU_FAULTS="crash@step:3,torn_write@ckpt:1%0"`` crashes
   every rank at its 3rd train step and tears rank 0's first checkpoint
   shard write. Counting is purely hit-based — no randomness — so a
   given spec reproduces the same failure every run. Sites count
   *python-level* calls: collective sites (``allreduce`` …) fire per
   call in eager mode, but inside a ``to_static``/jit-staged region the
   python collective runs only at trace time, so a staged loop hits them
   once, not per step — target ``step`` (the watchdog heartbeat, which
   every staged train step enters eagerly) to fault staged training. ``crash`` (exits
   ``EXIT_FAULT``), ``hang`` and ``slow_io`` execute here; ``torn_write``
   and ``store_drop`` are *cooperative*: ``maybe_inject`` returns the
   kind and the call site enacts it (truncate the write / drop the
   connection). A fired entry is recorded in the ledger file named by
   ``PADDLE_TPU_FAULT_LEDGER`` (the launcher sets it) so a restarted
   process does not re-fire the same fault — without the ledger a
   ``crash@step:3`` would kill every incarnation at step 3 forever.

2. **Retry with backoff** — :class:`Backoff` (exponential, deterministic
   seeded jitter, cap + deadline) and :func:`retry`, used by TCPStore
   connect/ops and distributed init.

3. **Checkpoint lineage** — :class:`CheckpointLineage`: step-numbered
   snapshot dirs under one root, two-phase commit of a ``LATEST``
   pointer behind a TCPStore barrier, CRC-verified load with fallback to
   the newest *complete* snapshot, and garbage collection of torn ones.

4. **Graceful preemption** — :func:`install_preemption_handler` turns
   SIGTERM into a synchronized save + ``EXIT_PREEMPT`` (75, EX_TEMPFAIL)
   which the launcher treats as resumable without consuming
   ``--max_restarts``.
"""
from __future__ import annotations

import os
import random
import signal
import sys
import threading
import time

__all__ = [
    "EXIT_FAULT", "EXIT_PREEMPT", "EXIT_WATCHDOG", "EXIT_HANG",
    "EXIT_DESYNC", "EXIT_USAGE", "EXIT_DEPOSED", "EXIT_ORACLE",
    "EXIT_INTEGRITY",
    "EXIT_CAUSES",
    "describe_exit",
    "FaultEntry",
    "parse_fault_spec", "set_fault_spec", "maybe_inject", "fault_rank",
    "Backoff", "retry", "atomic_write", "atomic_write_bytes",
    "CheckpointLineage",
    "install_preemption_handler", "preempted", "exit_preempted",
    "preemption_scope",
]

EXIT_FAULT = 43      # injected crash — a real failure, consumes a restart
EXIT_PREEMPT = 75    # graceful preemption (EX_TEMPFAIL) — resumable free
EXIT_WATCHDOG = 17   # native watchdog abort (core/native/tcp_store.cpp)
EXIT_HANG = 19       # watchdog ESCALATION: flight-recorder dump + blame
                     # written, then abort (distributed/watchdog.py)
EXIT_DESYNC = 21     # collective desync detected pre-issue (fail-fast,
                     # distributed/flight_recorder.py)
EXIT_USAGE = 64      # launcher flag combination rejected (EX_USAGE) —
                     # mapped + hinted instead of a bare traceback
EXIT_DEPOSED = 76    # control-plane coordinator deposed (EX_PROTOCOL):
                     # a shadow took over the lease term; this instance
                     # yielded instead of split-braining the round
EXIT_ORACLE = 47     # numerical-correctness oracle violated (dlinalg
                     # residual/orthogonality gate): the answer is WRONG,
                     # not just late — never auto-resumed, a human looks
EXIT_INTEGRITY = 49  # training integrity guard verdict (distributed/
                     # integrity.py): sustained loss/gradient anomaly
                     # survived the in-process rewind-and-skip budget —
                     # a restart would resume the same snapshot and
                     # re-trip the guard, so the launcher does not

# The one copy of the worker exit-code -> human cause mapping (launcher
# failure summaries, tests). Negative codes are death-by-signal and are
# rendered by describe_exit.
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


_KINDS = ("crash", "hang", "torn_write", "store_drop", "slow_io",
          "async_torn", "commit_stall", "desync",
          "node_die", "agent_stall", "store_die",
          "coordinator_die", "wal_torn",
          "engine_die", "engine_stall",
          "router_die", "router_stall",
          "panel_corrupt", "sweep_stall",
          "grad_bitflip", "loss_spike")
# a site-less (wildcard) cooperative entry only fires at sites whose
# callers honor the returned kind — anywhere else it would burn its
# trigger silently; crash/hang/slow_io/commit_stall wildcards fire at
# any site. ``async_torn`` tears a shard landed by the OVERLAPPED async
# writer (checkpoint.AsyncSaveHandle); ``commit_stall`` sleeps inside
# the lineage commit window (between the durability barrier and the
# LATEST flip) so the chaos harness can kill mid-commit. ``desync`` is
# cooperative at the eager-collective sites: the collective perturbs its
# cross-rank signature so the opt-in desync check trips deterministically.
_DESYNC_SITES = ("allreduce", "allgather", "reduce", "broadcast", "scatter",
                 "reducescatter", "alltoall", "barrier")
# node-scoped kinds (multi-host elastic): ``node_die`` is cooperative at
# the agent's heartbeat site — the agent enacts a whole-node SIGKILL
# (itself + every local worker, modelling sudden host loss);
# ``agent_stall`` executes a sleep there (heartbeats stop while workers
# keep running — the zombie-node case the coordinator must fence);
# ``store_die`` is cooperative at the coordinator's registry-poll site —
# the coordinator enacts it by stopping the PRIMARY registry server
# (master-node death), forcing every client onto the warm standby.
_WILDCARD_SITES = {"store_drop": ("store",), "torn_write": ("ckpt",),
                   "async_torn": ("async_ckpt",), "desync": _DESYNC_SITES,
                   "node_die": ("node_beat",),
                   "agent_stall": ("node_beat",),
                   "store_die": ("elastic_store",),
                   # control-plane replication kinds:
                   # ``coordinator_die`` is cooperative at the
                   # coordinator's lease-beat site — the coordinator
                   # enacts a sudden SIGKILL of itself (its in-process
                   # primary registry server dies with it, so ONE kind
                   # kills both halves of the control plane);
                   # ``wal_torn`` is cooperative at the log shipper's
                   # replication site — the shipper tears the entry it is
                   # applying to the standby (truncated set / dropped
                   # add), proving the on_failover gap-filler heals the
                   # un-replicated tail
                   "coordinator_die": ("coord_beat",),
                   "wal_torn": ("replication",),
                   # serving chaos kinds: ``engine_die`` is
                   # cooperative at the serving engine's serve-loop site
                   # — the engine enacts a serve-loop crash (its crash
                   # containment marks the engine unhealthy, fails every
                   # waiter, and the fleet router re-dispatches);
                   # ``engine_stall`` executes a sleep there (the loop
                   # freezes mid-traffic while the process lives — the
                   # straggler case hedging and the stale-heartbeat
                   # sweep must survive). PADDLE_TPU_FAULT_ENGINE can
                   # name one engine_id so a multi-engine process kills
                   # a chosen replica deterministically.
                   "engine_die": ("serve_loop",),
                   "engine_stall": ("serve_loop",),
                   # durable front door: ``router_die`` is
                   # cooperative at the serving router's route-loop
                   # site — the front-door process enacts SIGKILL on
                   # itself mid-dispatch (the shadow router adopts the
                   # ledger and the in-flight legs); ``router_stall``
                   # executes a sleep there (the lease goes stale while
                   # the process lives — the shadow must adopt AND the
                   # revived primary must hit the term fence, exiting
                   # EXIT_DEPOSED instead of split-brain dispatching).
                   "router_die": ("route",),
                   "router_stall": ("route",),
                   # distributed linear algebra:
                   # ``panel_corrupt`` is cooperative at the dlinalg
                   # panel site — the sweep driver enacts a bit-flip on
                   # the panel it just computed (modelling silent memory
                   # corruption after a fault), which the per-step
                   # residual oracle must turn into a loud
                   # OracleViolation / EXIT_ORACLE instead of a wrong
                   # answer; ``sweep_stall`` executes a sleep at the
                   # sweep boundary (the straggler-solver case the
                   # launcher's terminate-grace path must cover).
                   "panel_corrupt": ("linalg_panel",),
                   "sweep_stall": ("linalg_sweep",),
                   # training integrity: ``grad_bitflip`` is
                   # cooperative at the bucket-fingerprint site — the
                   # fingerprinting rank perturbs the payload copy it is
                   # about to summarize (the SDC bit-flip model: ONE rank
                   # differs pre-collective where fingerprints must
                   # agree), which the TrainingGuard must blame, strike
                   # and redo; ``loss_spike`` is cooperative at the
                   # guarded fit loop's batch site — the loop scales that
                   # batch's labels so the step genuinely corrupts,
                   # which the MAD health gate must catch and the
                   # rewind-and-skip replay must excise.
                   "grad_bitflip": ("grad_fingerprint",),
                   "loss_spike": ("batch",)}

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
            # would burn its trigger (and ledger slot) while enacting
            # nothing — the chaos run would pass vacuously
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
    not re-fire after the launcher restarts this rank."""
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
    """Fault-injection hook. Cheap no-op unless a spec is configured.

    Returns a cooperative fault kind (``"torn_write"`` / ``"store_drop"``)
    the *caller* must enact, or None. ``crash``, ``hang`` and ``slow_io``
    are executed here.
    """
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
        elif e.kind == "commit_stall":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_COMMIT_STALL_S", "5.0")))
        elif e.kind == "agent_stall":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_AGENT_STALL_S", "30.0")))
        elif e.kind == "engine_stall":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_ENGINE_STALL_S", "30.0")))
        elif e.kind == "router_stall":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_ROUTER_STALL_S", "30.0")))
        elif e.kind == "sweep_stall":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_SWEEP_STALL_S", "30.0")))
        else:
            result = e.kind
    return result


# ---------------------------------------------------------------- backoff

class Backoff:
    """Exponential backoff schedule with deterministic jitter, a delay cap
    and an overall deadline.

    ``delays()`` yields sleep durations: ``base * factor**i`` capped at
    ``cap``, each scaled by ``1 ± jitter`` (seeded per rank so schedules
    are reproducible yet decorrelated across ranks — a thundering herd of
    reconnecting workers must not stay in lockstep). Iteration stops
    after ``attempts`` delays or when ``deadline`` seconds have elapsed
    since the first delay was requested.
    """

    def __init__(self, base=0.05, cap=2.0, factor=2.0, jitter=0.25,
                 attempts=None, deadline=None, seed=None):
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self.attempts = attempts
        self.deadline = deadline
        if seed is None:
            seed = 0x5DEECE66D ^ (fault_rank() * 7919)
        self._rng = random.Random(seed)

    def delays(self):
        i = 0
        start = time.monotonic()
        while self.attempts is None or i < self.attempts:
            d = min(self.cap, self.base * (self.factor ** i))
            if self.jitter:
                d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
            if self.deadline is not None:
                remaining = self.deadline - (time.monotonic() - start)
                if remaining <= 0:
                    return
                d = min(d, remaining)
            yield max(0.0, d)
            i += 1

    def __iter__(self):
        return self.delays()


def retry(fn, *, retry_on=(Exception,), attempts=5, base=0.05, cap=2.0,
          factor=2.0, jitter=0.25, deadline=None, seed=None, on_retry=None):
    """Call ``fn()``, retrying on ``retry_on`` with exponential backoff.

    Stops after ``attempts`` total calls (None = unlimited) or once
    ``deadline`` seconds have elapsed, re-raising the last failure.
    ``on_retry(exc, delay)`` observes each scheduled retry.
    """
    bo = Backoff(base=base, cap=cap, factor=factor, jitter=jitter,
                 attempts=None if attempts is None else max(0, attempts - 1),
                 deadline=deadline, seed=seed)
    it = bo.delays()
    while True:
        try:
            return fn()
        except retry_on:
            delay = next(it, None)
            if delay is None:
                raise
            if on_retry is not None:
                on_retry(sys.exc_info()[1], delay)
            time.sleep(delay)


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

    With ``on_preempt`` (e.g. a synchronized checkpoint save) the handler
    runs it and exits ``EXIT_PREEMPT`` — the launcher resumes the job
    without consuming ``--max_restarts``. Without a callback the handler
    only sets a flag; the training loop polls :func:`preempted` and calls
    :func:`exit_preempted` at a step boundary (the safe default: a save
    started mid-collective from a signal frame could deadlock).
    Returns True if the handler was installed (main thread only).
    """
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
    """Scoped SIGTERM→drain→exit-75 watcher for non-hapi drivers.

    ``Model.fit`` and ``ServingEngine`` each hand-wire
    :func:`install_preemption_handler`; any other long-running driver
    (the dlinalg sweep driver, future workloads) wants the same contract
    without owning process-global signal state. This context manager
    installs the handler on entry and restores the PREVIOUS SIGTERM
    disposition, callback and flag state on exit, so scopes nest and a
    library driver never clobbers its host application's handler.

    With ``on_preempt`` the handler saves-and-exits from the signal
    frame (callback mode — pass a function that snapshots only
    already-committed state). Without it, poll :meth:`preempted` at
    panel/step boundaries and call :meth:`exit` to save and leave with
    ``EXIT_PREEMPT``.
    """

    def __init__(self, on_preempt=None):
        self._on_preempt = on_preempt
        self._prev_handler = None
        self._prev_cb = None
        self._was_set = False
        self.installed = False

    def __enter__(self):
        global _preempt_cb
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


# ------------------------------------------------------ checkpoint lineage

class CheckpointLineage:
    """Verified checkpoint lineage under one root directory::

        root/step_00000012/    sharded snapshot (shards+metadata+manifests)
        root/LATEST            committed pointer ("step_00000012")

    ``save`` two-phase commits: phase 1 every rank's shards + CRC manifest
    land durably (``checkpoint.save_state_dict``), phase 2 a TCPStore
    barrier proves all hosts landed, then rank 0 atomically flips
    ``LATEST`` and the others wait for the commit flag — a crash anywhere
    leaves either the old pointer or the new fully-verified snapshot,
    never a pointer to a torn one. ``load_latest`` walks snapshots
    newest-first, CRC-verifying each (``checkpoint.verify_checkpoint``),
    loads the newest *complete* one, garbage-collects torn snapshots and
    returns the saved step (None when no usable snapshot exists).
    """

    def __init__(self, root, store=None, world_size=1, rank=0, keep=3):
        self.root = str(root)
        self.store = store
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.keep = int(keep)
        self._warned_no_store = False
        self._store_hostage = False  # abandoned thread may hold the store
        self._inflight = None  # overlapped async save not yet committed
        os.makedirs(self.root, exist_ok=True)

    # -- layout --
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step):08d}")

    @staticmethod
    def _step_of(name: str):
        if not name.startswith("step_"):
            return None
        try:
            return int(name[len("step_"):])
        except ValueError:
            return None

    def candidates(self):
        """(step, dir) snapshot candidates, newest first."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            step = self._step_of(name)
            d = os.path.join(self.root, name)
            if step is not None and os.path.isdir(d):
                out.append((step, d))
        out.sort(reverse=True)
        return out

    def latest_committed(self):
        """Step named by the LATEST pointer, or None."""
        try:
            with open(os.path.join(self.root, "LATEST")) as f:
                return self._step_of(f.read().strip())
        except OSError:
            return None

    # -- save --
    def save(self, state_dict, step: int, async_save=False) -> str:
        """Write one snapshot and two-phase commit the LATEST pointer.

        ``async_save=True`` OVERLAPS with training: device buffers are
        snapshotted synchronously (cheap D2H), then serialization, per-
        shard CRC, disk IO *and the commit barrier itself* run on the
        handle's completion thread — the trainer keeps stepping while the
        previous snapshot streams out and commits. At most one snapshot
        is in flight: a new ``save`` (or :meth:`wait`, or ``load_latest``)
        first drains the previous one, so the commit order matches the
        step order and the lineage's TCPStore is never used from two
        threads at once."""
        from . import checkpoint as _ckpt
        if preempted():
            # graceful-save window: the previous overlapped commit may be
            # stuck in a barrier whose peer died BEFORE SIGTERM arrived
            # (entered with the store's long timeout, not the preempt-
            # bounded one) — draining unbounded here would blow past the
            # launcher's kill grace and lose this save entirely. Bound
            # the drain and abandon the stale handle: the snapshot we
            # are about to write is newer than anything it could commit.
            if not self.wait(float(os.environ.get(
                    "PADDLE_TPU_PREEMPT_COMMIT_TIMEOUT_S", "5"))):
                self._inflight = None
                # the abandoned thread may be blocked INSIDE a store op,
                # holding the client mutex — _commit must not queue
                # behind it (it flips locally instead)
                self._store_hostage = True
        else:
            self.wait()  # ≤1 in flight; completes the prior commit
        d = self.step_dir(step)
        handle = _ckpt.save_state_dict(state_dict, d, async_save=async_save)
        if handle is not None:
            # overlapped commit: barrier + pointer flip run from the
            # handle's completion thread once every per-shard CRC future
            # resolved and the files are durable
            handle.add_done_callback(lambda: self._commit_and_prune(step))
            self._inflight = handle
            return d
        self._commit_and_prune(step)
        return d

    def _commit_and_prune(self, step: int):
        self._commit(step)
        if self.rank == 0:
            self._prune()

    def wait(self, timeout=None) -> bool:
        """Drain the in-flight overlapped snapshot (durability + commit).
        True when nothing is pending or the drain finished; False on
        timeout (the handle stays in flight). Errors from the background
        write/commit re-raise here."""
        h = self._inflight
        if h is None:
            return True
        try:
            if not h.wait(timeout):
                return False
        except BaseException:
            # a failed overlapped save is finished, not in flight: keep
            # the handle and every later save()/load_latest()/wait() —
            # including the SIGTERM graceful-save path — re-raises the
            # same stale error forever
            self._inflight = None
            h.close()
            raise
        self._inflight = None
        h.close()
        return True

    def _commit(self, step: int):
        """Two-phase commit of the LATEST pointer (class docstring).

        Once SIGTERM has arrived (``preempted()``) the barriers are
        bounded (``PADDLE_TPU_PREEMPT_COMMIT_TIMEOUT_S``, default 5s): a
        peer that died before its preemption save would otherwise hold
        this rank in the barrier past the launcher's kill grace, turning
        every graceful save into a SIGKILL mid-save. On timeout the
        pointer flip is skipped — the snapshot stays
        uncommitted-but-complete, which ``load_latest`` still rescues
        (it scans every candidate, not just LATEST)."""
        def _flip():
            # chaos window: ``commit_stall`` sleeps here — after the
            # shards are durable, before the pointer names them — so a
            # kill lands exactly mid-commit (snapshot complete but
            # uncommitted; load_latest still rescues it)
            maybe_inject("commit")
            # LATEST is monotonic: an abandoned overlapped commit (e.g.
            # one the preemption drain timed out on) waking up after a
            # newer sync save committed must not flip the pointer BACK —
            # the next incarnation would restore the older step and GC
            # the newer snapshot, losing the graceful save
            cur = self.latest_committed()
            if cur is not None and cur >= step:
                return
            atomic_write_bytes(os.path.join(self.root, "LATEST"),
                               os.path.basename(self.step_dir(step)).encode())

        if self._store_hostage and preempted():
            # the preempt drain abandoned a completion thread that may
            # still be blocked inside a store op — the client's per-call
            # mutex would serialize OUR barrier behind it for the store's
            # FULL timeout, blowing the launcher's kill grace. Skip the
            # barrier (the peer it would prove is likely dead anyway) and
            # flip locally: uncommitted-but-complete snapshots are still
            # restored by load_latest.
            print(f"[fault] rank {self.rank}: step-{step} commit skips "
                  "the barrier (store held by an abandoned overlapped "
                  "commit); flipping locally", file=sys.stderr, flush=True)
            if self.rank == 0:
                _flip()
            return
        if self.store is None or self.world_size <= 1:
            if self.store is None and self.world_size > 1 \
                    and not self._warned_no_store:
                self._warned_no_store = True
                print(f"[fault] rank {self.rank}: CheckpointLineage has "
                      f"no store at world_size {self.world_size} — LATEST "
                      "is flipped without proof that peer shards landed "
                      "(load-time verify+fallback still guards loads)",
                      file=sys.stderr, flush=True)
            if self.rank == 0:
                _flip()
            return
        from .tcp_store import StoreTimeoutError
        timeout = None
        if preempted():
            timeout = float(os.environ.get(
                "PADDLE_TPU_PREEMPT_COMMIT_TIMEOUT_S", "5"))
        key = f"__ckpt/{step}/committed"
        try:
            # phase 1 barrier: every host's shards + manifest are durable
            self.store.barrier(f"__ckpt/{step}/landed", self.world_size,
                               timeout=timeout)
            if self.rank == 0:
                _flip()
                self.store.set(key, b"1")
            else:
                # phase 2: proceed only after rank 0's pointer flip
                self.store.get(key, timeout=timeout)
        except StoreTimeoutError:
            if timeout is None:
                raise  # regular save: a stuck barrier is the caller's bug
            print(f"[fault] rank {self.rank}: step-{step} commit barrier "
                  "timed out (dead peer?); snapshot left uncommitted — "
                  "complete snapshots are still restored by load_latest",
                  file=sys.stderr, flush=True)

    def _prune(self):
        """Keep the newest ``keep`` snapshots; GC the rest."""
        import shutil
        for _, d in self.candidates()[max(self.keep, 1):]:
            shutil.rmtree(d, ignore_errors=True)

    # -- load --
    def load_latest(self, state_dict):
        """Restore ``state_dict`` from the best verified snapshot; GC the
        dead ones; return its step (None = fresh start).

        Choice order: the committed ``LATEST`` target first (that's what
        the two-phase barrier bought), then every other snapshot
        newest-first — so an uncommitted-but-complete snapshot still
        rescues a run whose pointer flip was lost. Each candidate is
        CRC-verified before anything is deserialized. After the choice,
        rank 0 garbage-collects every snapshot NEWER than the chosen one
        (torn or dead lineage branches — resumed training will rewrite
        those steps) plus any torn older candidate it scanned, and heals
        the pointer."""
        from . import checkpoint as _ckpt
        import shutil
        self.wait()  # an in-flight overlapped save must land before we scan
        cands = self.candidates()
        ptr = self.latest_committed()
        ordered = [c for c in cands if c[0] == ptr] \
            + [c for c in cands if c[0] != ptr]
        chosen = None
        torn = []
        for step, d in ordered:
            try:
                _ckpt.verify_checkpoint(d)
            except _ckpt.CheckpointCorruptError as e:
                print(f"[fault] rank {self.rank}: skipping snapshot "
                      f"{os.path.basename(d)}: {e}",
                      file=sys.stderr, flush=True)
                torn.append(d)
                continue
            _ckpt.load_state_dict(state_dict, d, _verified=True)
            chosen = step
            break
        if self.rank == 0:
            dead = set(torn)
            if chosen is not None:
                dead.update(d for step, d in cands if step > chosen)
            for d in dead:
                shutil.rmtree(d, ignore_errors=True)
            if chosen is not None and ptr != chosen:
                # heal the pointer after a fallback
                atomic_write_bytes(
                    os.path.join(self.root, "LATEST"),
                    os.path.basename(self.step_dir(chosen)).encode())
            elif chosen is None:
                try:
                    os.unlink(os.path.join(self.root, "LATEST"))
                except OSError:
                    pass
        return chosen
