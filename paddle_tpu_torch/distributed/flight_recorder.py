"""Collective flight recorder — per-rank diagnosis of hangs and desyncs:
the port's copy of ``paddle_tpu/distributed/flight_recorder.py``. The
ring, the dump file format, the blame rule and the post-mortem text are
the JAX package's, so either package's launcher reads the other's dumps.

Reference capability: the NCCL flight recorder / CommTaskManager comm-task
scanner (comm_task_manager.cc:153) that large-job operators use to answer
"which rank hung on which collective". A blind watchdog abort destroys
exactly the evidence needed to diagnose a hang; this module keeps it:

1. **Ring buffer** — env-gated (``PADDLE_TPU_FLIGHT_RECORDER=<capacity>``)
   lock-cheap ring of events: monotonic per-rank seq + per-group seq, op
   kind, group, shape/dtype, step number, caller site and wall
   timestamps. In the port it is fed by the eager collectives
   (``collective.py``, ``comm_extra.py``, ``stream.py``), the staged
   train step's heartbeat (``watchdog.beat``), ``resumable.py``'s step
   boundaries and resume markers, the integrity guard's anomaly and
   rewind markers and ``tcp_store.barrier``. Each completed entry feeds
   ``observability.metrics.observe_collective`` and
   ``observability.tracing.collective_event``, as in JAX. Disabled (the
   default) every hook is a constant-time no-op.

2. **Desync detection** — opt-in (``PADDLE_TPU_DESYNC_CHECK=1``): a
   collective's signature (per-group seq, kind, shape, dtype) is
   cross-checked against every peer through the TCPStore side channel
   (``PADDLE_TPU_FR_STORE=host:port``); a mismatch raises
   :class:`CollectiveDesyncError` naming the diverging rank. The check
   and its signatures are here; their callers are the collectives.

3. **Post-mortem** — :func:`dump` writes the ring + all-thread stacks as
   JSON into the workerlog dir (``PADDLE_TPU_WORKERLOG_DIR``, exported by
   the launcher); :func:`watchdog_escalation` additionally publishes this
   rank's last seq to the store, gathers peers' and computes *blame*. The
   launcher's :func:`format_post_mortem` renders the per-rank dumps into
   a one-screen summary.

Stdlib-only at import time (like ``fault.py``) so the launcher can use the
dump readers without loading torch.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback

from . import fault as _fault
from ..observability import metrics as _obs_metrics
from ..observability import tracing as _obs_tracing

__all__ = [
    "FlightRecorder", "CollectiveDesyncError", "get_recorder", "enable",
    "disable", "record_issue", "record_complete", "note_wait_begin",
    "note_step",
    "note_heartbeat", "note_resume", "check_desync", "verify_signatures",
    "wire_from_env",
    "next_group_seq", "current_group_seq", "reset_seqs", "incarnation",
    "note_store_incarnation", "note_fenced", "store_incarnation",
    "store_scope", "side_store", "dump", "dump_path", "watchdog_escalation",
    "collect_dumps", "rows_from_dumps", "blame_rows", "format_post_mortem",
]

_DEFAULT_CAPACITY = 256
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


class CollectiveDesyncError(RuntimeError):
    """Ranks disagreed on the signature of the next collective — issuing it
    would hang (shape/count mismatch) or silently corrupt numerics (dtype/
    kind mismatch). Raised *before* the collective is issued."""


# ---------------------------------------------------------- seq registry
# One authority for per-group monotonic sequence numbers, shared with
# comm_extra's gloo barrier (the old process-global
# _gloo_barrier_seq was never reset, so a resumed incarnation collided on
# store keys). Store keys derive from store_scope(), which namespaces by
# incarnation, and destroy_process_group()/gloo_release() reset counters.

_seq_lock = threading.Lock()
_seqs: dict = {}
_scope_epoch = [0]


def next_group_seq(key: str) -> int:
    with _seq_lock:
        _seqs[key] = _seqs.get(key, 0) + 1
        return _seqs[key]


def current_group_seq(key: str) -> int:
    with _seq_lock:
        return _seqs.get(key, 0)


def reset_seqs(prefix: str | None = None):
    """Clear seq counters (all, or those under ``prefix``) AND rotate the
    store-key namespace: a reset counter re-issues the same seq values, so
    keys derived from them must never land in the old namespace — against
    a still-alive store a reused ``gloo_barrier/1`` key would find the
    previous lifetime's done-flag and release the barrier before any peer
    arrived. Resets happen at SPMD-symmetric points (destroy_process_group,
    gloo_release), so peers' epochs stay aligned."""
    with _seq_lock:
        if prefix is None:
            _seqs.clear()
        else:
            for k in [k for k in _seqs if k.startswith(prefix)]:
                del _seqs[k]
        _scope_epoch[0] += 1


def incarnation() -> int:
    """Launcher restart round of this process (0 on the first spawn)."""
    return int(os.environ.get("PADDLE_TPU_RESTART_NUM", "0") or 0)


_store_inc = [0]


def note_store_incarnation(n: int):
    """Record the control-plane store incarnation — bumped by
    :class:`~.tcp_store.FailoverStore` when clients
    re-home to a standby master. Keys derived from :func:`store_scope`
    rotate with it, so a process that outlived a store failover can never
    collide with keys a slow peer wrote under the previous store lifetime
    (or with a restarted primary's leftovers). When the recorder is
    enabled the rotation also leaves a completed ``store_failover`` ring
    marker, so a post-mortem spanning a control-plane failover can name
    which store epoch any surrounding entry belongs to."""
    changed = int(n) > _store_inc[0]
    _store_inc[0] = max(_store_inc[0], int(n))
    if not changed:
        return
    rec = _rec if _loaded else _load()
    if rec is not None:
        rec.complete(rec.issue("store_failover", group="step",
                               extra={"incarnation": int(n)}))


def note_fenced(kind, old_epoch, new_epoch, detail=None):
    """Ring marker for a fenced write: a deposed writer (an old store
    epoch or a deposed coordinator term) tried to mutate the control
    plane and was rejected. The marker names BOTH epochs so post-mortems
    can attribute a stray write to the lifetime it came from. ``kind`` is
    ``store_fenced`` (FailoverStore epoch fence), ``coord_fenced``
    (coordinator lease term) or ``wal_replay_fenced`` (log shipper
    rejected a deposed primary's late WAL entry)."""
    rec = _rec if _loaded else _load()
    if rec is None:
        return
    extra = {"old_epoch": int(old_epoch), "new_epoch": int(new_epoch)}
    if detail is not None:
        extra["detail"] = str(detail)
    rec.complete(rec.issue(kind, group="step", extra=extra))


def store_incarnation() -> int:
    return max(_store_inc[0],
               int(os.environ.get("PADDLE_TPU_STORE_INCARNATION", "0")
                   or 0))


def store_scope() -> str:
    """Store-key namespace: unique per incarnation (a relaunched worker
    must never collide with keys its previous incarnation left behind),
    per seq-reset epoch (same-process re-init against a surviving
    store must not reuse the old lifetime's keys) AND per store
    incarnation (a store failover re-homes everyone onto a different
    master whose keyspace history is unknown)."""
    e = _scope_epoch[0]
    s = store_incarnation()
    return (f"fr/i{incarnation()}" + (f".e{e}" if e else "")
            + (f".s{s}" if s else ""))


def _env_world() -> int:
    return int(os.environ.get("PADDLE_TPU_NUM_PROCESSES",
                              os.environ.get("PADDLE_TRAINERS_NUM", "1"))
               or 1)


def _caller_site(skip_frames=2):
    """First stack frame outside this package's ``distributed/`` — the
    user-level call site of the collective."""
    try:
        f = sys._getframe(skip_frames)
        while f is not None:
            fn = f.f_code.co_filename
            if not os.path.abspath(fn).startswith(_PKG_DIR):
                return f"{os.path.basename(fn)}:{f.f_lineno}"
            f = f.f_back
    except Exception:
        pass
    return None


# -------------------------------------------------------------- recorder

class FlightRecorder:
    """Fixed-capacity ring of collective events. "Lock-cheap": the only
    synchronization on the record path is one short lock inside
    :func:`next_group_seq`; the ring index comes from an
    ``itertools.count`` (atomic under the GIL) and the slot write is a
    single list assignment."""

    def __init__(self, capacity=_DEFAULT_CAPACITY, rank=None,
                 world_size=None, desync=False, store=None):
        self.capacity = max(1, int(capacity))
        self.ring = [None] * self.capacity
        self._idx = itertools.count(1)
        self.rank = _fault.fault_rank() if rank is None else int(rank)
        self.world_size = int(world_size) if world_size else _env_world()
        self.desync = bool(desync)
        self._store = store
        self._store_failed = False
        self.step = 0
        self.last_issued = None
        self.last_completed = None

    def issue(self, kind, group="world", shape=None, dtype=None, site=None,
              extra=None):
        seq = next(self._idx)
        e = {"seq": seq,
             "gseq": next_group_seq(f"op/{group}"),
             "kind": kind, "group": group,
             "shape": list(shape) if shape is not None else None,
             "dtype": str(dtype) if dtype is not None else None,
             "step": self.step,
             "site": site if site is not None else _caller_site(3),
             "t_issue": time.time(), "t_complete": None,
             "status": "issued"}
        if extra:
            e.update(extra)
        self.ring[(seq - 1) % self.capacity] = e
        self.last_issued = e
        return e

    def complete(self, e):
        e["t_complete"] = time.time()
        e["status"] = "completed"
        self.last_completed = e
        # the ring doubles as a metrics/trace source: each issue→complete
        # pair feeds the per-kind x group latency histogram and (when
        # tracing) a collective event; both are one None check when off
        try:
            _obs_metrics.observe_collective(e)
            _obs_tracing.collective_event(e)
        except Exception:
            pass  # telemetry must never break a collective

    def entries(self):
        """Live ring contents, oldest first."""
        out = [e for e in self.ring if e is not None]
        out.sort(key=lambda e: e["seq"])
        return out


# ------------------------------------------------- module-level singleton

_state_lock = threading.Lock()
_rec: FlightRecorder | None = None
_loaded = False


def _load():
    """Resolve the env gate once: ``PADDLE_TPU_FLIGHT_RECORDER=<capacity>``
    (unset/0 = disabled); ``PADDLE_TPU_DESYNC_CHECK=1`` implies a default-
    capacity recorder (the check needs the seq/signature bookkeeping)."""
    global _rec, _loaded
    with _state_lock:
        if _loaded:
            return _rec
        raw = os.environ.get("PADDLE_TPU_FLIGHT_RECORDER", "")
        try:
            cap = int(raw or "0")
        except ValueError:
            # the gate is documented as a capacity with unset/0 = off:
            # garbage must fail toward OFF, never silently enable
            # per-collective recording in a job that asked for none
            print(f"[flight-recorder] PADDLE_TPU_FLIGHT_RECORDER={raw!r} "
                  "is not a capacity (integer); recorder stays DISABLED",
                  file=sys.stderr, flush=True)
            cap = 0
        desync = os.environ.get("PADDLE_TPU_DESYNC_CHECK") == "1"
        if desync and cap <= 0:
            cap = _DEFAULT_CAPACITY
        if cap <= 0 and _obs_metrics.enabled():
            # PADDLE_TPU_METRICS=1 alone must yield collective latency
            # histograms: the histograms are fed from issue→complete
            # pairs, so metrics-on implies a default-capacity recorder
            cap = _DEFAULT_CAPACITY
        _rec = FlightRecorder(capacity=cap, desync=desync) if cap > 0 \
            else None
        if desync:
            _install_desync_excepthook()
        _loaded = True
        return _rec


def get_recorder():
    """The env-gated singleton recorder, or None when disabled."""
    return _rec if _loaded else _load()


def enable(capacity=_DEFAULT_CAPACITY, desync=False, store=None,
           world_size=None, rank=None):
    """Programmatic gate (tests / embedding) — replaces the singleton."""
    global _rec, _loaded
    with _state_lock:
        _rec = FlightRecorder(capacity=capacity, rank=rank,
                              world_size=world_size, desync=desync,
                              store=store)
        _loaded = True
        return _rec


def disable():
    global _rec, _loaded
    with _state_lock:
        _rec = None
        _loaded = True


def _reset_state():
    """Test hook: back to the unresolved env-gated state, seqs cleared."""
    global _rec, _loaded
    with _state_lock:
        _rec = None
        _loaded = False
    _store_inc[0] = 0
    reset_seqs()


def record_issue(kind, group="world", shape=None, dtype=None, site=None,
                 extra=None):
    """Record one collective issue; returns the ring entry (None when the
    recorder is disabled — the fast path is this one None check)."""
    rec = _rec if _loaded else _load()
    if rec is None:
        return None
    return rec.issue(kind, group=group, shape=shape, dtype=dtype, site=site,
                     extra=extra)


def record_complete(entry):
    rec = _rec
    if rec is None or entry is None:
        return
    rec.complete(entry)


def note_wait_begin(entry):
    """Stamp the moment a consumer started WAITING on an async collective
    (``_StreamTask.wait`` / the bucket scheduler's backward-end drain).
    The in-run overlap sampler (observability.metrics.observe_collective)
    reads ``t_issue → t_wait`` as the window the collective was in flight
    while the host kept working — the hidden-communication credit."""
    if entry is not None and "t_wait" not in entry:
        entry["t_wait"] = time.time()


def note_step(step):
    """Pin the recorder's step number (resumable.py step boundaries)."""
    rec = _rec if _loaded else _load()
    if rec is not None:
        rec.step = int(step)


def note_heartbeat():
    """One staged train step passed through watchdog.beat(): bump the step
    counter and leave a completed marker entry in the ring."""
    rec = _rec if _loaded else _load()
    if rec is None:
        return
    rec.step += 1
    rec.complete(rec.issue("step", group="step"))


def note_resume(step, old_world=None, new_world=None):
    """Leave a completed ``resume`` marker in the ring: a post-mortem that
    spans an elastic relaunch must show WHERE the restored incarnation
    re-entered the step sequence (and across which world-size change)."""
    rec = _rec if _loaded else _load()
    if rec is None:
        return
    rec.step = int(step)
    extra = {}
    if old_world is not None:
        extra["old_world"] = int(old_world)
    if new_world is not None:
        extra["new_world"] = int(new_world)
    rec.complete(rec.issue("resume", group="step", extra=extra or None))


# ------------------------------------------------------ store side channel

def _side_store(rec, rank, world, timeout):
    """The TCPStore side channel (``PADDLE_TPU_FR_STORE=host:port``),
    created lazily and bounded by ``timeout`` — never retried once it
    failed (an unreachable store must not stall every later check)."""
    if rec is not None:
        if rec._store is not None or rec._store_failed:
            return rec._store
    ep = os.environ.get("PADDLE_TPU_FR_STORE")
    if not ep:
        if rec is not None:
            rec._store_failed = True
        return None
    store = None
    try:
        from .tcp_store import TCPStore
        host, _, port = ep.rpartition(":")
        store = TCPStore(host or "127.0.0.1", int(port),
                         is_master=(rank == 0), world_size=world,
                         timeout=max(1.0, float(timeout)))
    except Exception as e:
        print(f"[flight-recorder] rank {rank}: side-channel store "
              f"{ep} unavailable: {e}", file=sys.stderr, flush=True)
    if rec is not None:
        rec._store = store
        rec._store_failed = store is None
    return store


def wire_from_env(timeout=30.0):
    """Eagerly connect the side-channel store (workers call this at start
    so the watchdog escalation never has to bootstrap it mid-crisis)."""
    rec = _rec if _loaded else _load()
    if rec is None:
        return None
    return _side_store(rec, rec.rank, rec.world_size, timeout)


def side_store(rank=0, world=1, timeout=30.0):
    """Public side-channel accessor for subsystems that ride the
    ``PADDLE_TPU_FR_STORE`` channel even when the recorder itself is
    disabled — the integrity guard's gradient fingerprints publish under
    ``store_scope() + "/gfp/..."`` keys (per-incarnation namespace, so
    they rotate across restarts/failovers like every other side-channel
    family). With a live recorder the connection is shared and cached on
    it; without one a fresh connection is made per call, so callers keep
    their own reference. Returns None when no endpoint is configured or
    the store is unreachable."""
    rec = _rec if _loaded else _load()
    if rec is not None:
        return _side_store(rec, rec.rank, rec.world_size, timeout)
    return _side_store(None, int(rank), int(world), timeout)


# -------------------------------------------------------- desync detection

def signature_of(entry, perturbed=False):
    """The cross-rank signature of one collective. ``perturbed`` models an
    injected desync (fault kind ``desync``): this rank announces a
    signature no peer can match."""
    sig = (f"{entry['kind']}|group={entry['group']}"
           f"|shape={entry['shape']}|dtype={entry['dtype']}")
    if perturbed:
        sig += "|DESYNC-INJECTED"
    return sig


def verify_signatures(sigs, what=""):
    """Compare per-rank signatures; raise :class:`CollectiveDesyncError`
    naming the diverging rank(s) and both signatures. ``sigs`` is
    rank -> signature. Majority = the largest agreeing group (ties broken
    toward the group containing the lowest rank)."""
    groups: dict = {}
    for r, s in sigs.items():
        groups.setdefault(s, []).append(r)
    if len(groups) <= 1:
        return
    # majority = the largest agreeing group; an injection-marked signature
    # can never win (a 2-rank tie must still blame the perturbed rank);
    # remaining ties break toward the group containing the lowest rank
    majority_sig = max(groups, key=lambda s: ("DESYNC-INJECTED" not in s,
                                              len(groups[s]),
                                              -min(groups[s])))
    divergent = sorted(r for s, rs in groups.items()
                       if s != majority_sig for r in rs)
    msg = (f"collective desync{' at ' + what if what else ''}: "
           f"rank {divergent[0] if len(divergent) == 1 else divergent} "
           f"diverged — signature {sigs[divergent[0]]!r} vs majority "
           f"{majority_sig!r} (ranks {sorted(groups[majority_sig])})")
    try:
        dump(reason="desync", extra={"desync": {
            "divergent_ranks": divergent, "signatures": dict(sigs)}})
    except Exception:
        pass
    raise CollectiveDesyncError(msg)


def check_desync(entry, injected=False):
    """Pre-issue cross-rank signature check (tentpole (2)). No-op unless
    desync mode is on and the world is multi-rank. A peer that never
    publishes within the deadline is reported as a desync too (it stalled
    before this collective) rather than hanging this rank forever."""
    rec = _rec
    if rec is None or not rec.desync or entry is None \
            or rec.world_size <= 1:
        if injected:
            # the fault trigger is already consumed (and ledger-recorded):
            # a chaos run that expected a desync failure would otherwise
            # pass vacuously with nothing on stderr to explain why
            print("[flight-recorder] injected desync consumed but desync "
                  "checking is INACTIVE (need PADDLE_TPU_DESYNC_CHECK=1, "
                  "a multi-rank world and the recorder enabled) — the "
                  "fault enacted nothing", file=sys.stderr, flush=True)
        return
    timeout = float(os.environ.get("PADDLE_TPU_DESYNC_TIMEOUT_S", "30"))
    store = _side_store(rec, rec.rank, rec.world_size, timeout)
    if store is None:
        return
    sig = signature_of(entry, perturbed=injected)
    sig_prefix = f"{store_scope()}/sig/{entry['group']}/{entry['gseq']}"
    sigs = {rec.rank: sig}
    store.set(f"{sig_prefix}/{rec.rank}", sig.encode())
    for r in range(rec.world_size):
        if r == rec.rank:
            continue
        try:
            sigs[r] = store.get(f"{sig_prefix}/{r}",
                                timeout=timeout).decode()
        except Exception:
            sigs[r] = f"<rank {r} never announced seq {entry['gseq']} " \
                      f"within {timeout:.0f}s>"
    verify_signatures(
        sigs,
        what=f"{entry['kind']} group={entry['group']} seq={entry['gseq']}")


def _install_desync_excepthook():
    """In desync debug mode an uncaught CollectiveDesyncError becomes the
    distinct ``EXIT_DESYNC`` exit code so the launcher can name the cause."""
    prev = sys.excepthook

    def hook(tp, val, tb):
        if isinstance(tp, type) and issubclass(tp, CollectiveDesyncError):
            try:
                prev(tp, val, tb)
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(_fault.EXIT_DESYNC)
        prev(tp, val, tb)

    sys.excepthook = hook


# ----------------------------------------------------------------- dumps

def dump_path(dump_dir, rank):
    """Single copy of the dump-file naming scheme (launcher, tests and
    bench all glob through :func:`collect_dumps`)."""
    return os.path.join(dump_dir, f"flight_recorder.{rank}.json")


def _dump_dir():
    return (os.environ.get("PADDLE_TPU_FR_DUMP_DIR")
            or os.environ.get("PADDLE_TPU_WORKERLOG_DIR"))


def _thread_stacks():
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    try:
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, 'thread')}-{tid}"
            out[label] = [ln.rstrip("\n")
                          for ln in traceback.format_stack(frame)]
    except Exception:
        pass
    return out


def dump(reason="manual", dump_dir=None, extra=None):
    """Write this rank's flight-recorder dump (ring + all-thread stacks)
    as JSON; returns the path (None when no dump dir is configured — the
    document goes to stderr instead). Deliberately store-free: the dump
    must land even when the TCPStore is unreachable."""
    rec = _rec if _loaded else _load()
    rank = rec.rank if rec is not None else _fault.fault_rank()
    li = rec.last_issued if rec is not None else None
    doc = {
        "rank": rank,
        "incarnation": incarnation(),
        "reason": reason,
        "wall_time": time.time(),
        "enabled": rec is not None,
        "capacity": rec.capacity if rec is not None else 0,
        "step": rec.step if rec is not None else None,
        "last_issued": li,
        "last_completed": rec.last_completed if rec is not None else None,
        "pending": li if li is not None and li["status"] == "issued"
        else None,
        "entries": rec.entries() if rec is not None else [],
        "threads": _thread_stacks(),
    }
    if extra:
        doc.update(extra)
    d = dump_dir or _dump_dir()
    data = json.dumps(doc, indent=1, default=str).encode()
    if not d:
        print(f"[flight-recorder] rank {rank}: no dump dir "
              "(PADDLE_TPU_WORKERLOG_DIR unset) — dump follows on stderr",
              file=sys.stderr, flush=True)
        sys.stderr.write(data.decode() + "\n")
        sys.stderr.flush()
        return None
    os.makedirs(d, exist_ok=True)
    path = dump_path(d, rank)
    _fault.atomic_write_bytes(path, data)
    return path


# ----------------------------------------------------------------- blame

def _row_of(rec, rank):
    li = rec.last_issued if rec is not None else None
    lc = rec.last_completed if rec is not None else None
    return {"rank": rank,
            "issued_seq": li["seq"] if li else 0,
            "issued_kind": li["kind"] if li else None,
            "issued_status": li["status"] if li else None,
            "completed_seq": lc["seq"] if lc else 0,
            "step": rec.step if rec is not None else None}


def blame_rows(rows):
    """Laggard analysis over per-rank seq rows — the ONE copy of the blame
    rule, shared by the in-worker escalation and the launcher post-mortem:
    the rank with the lowest issued seq stalled *before* the collective
    the furthest-ahead peer already issued."""
    rows = [r for r in rows if r and r.get("rank") is not None]
    if len(rows) < 2:
        return None
    lag = min(rows, key=lambda r: (r.get("issued_seq") or 0, r["rank"]))
    ahead = [r for r in rows
             if (r.get("issued_seq") or 0) > (lag.get("issued_seq") or 0)]
    if not ahead:
        return None  # all ranks aligned: no one to blame
    peer = max(ahead, key=lambda r: r.get("issued_seq") or 0)
    completed = max((r.get("completed_seq") or 0) for r in rows)
    text = (f"rank {lag['rank']} stalled before "
            f"{peer.get('issued_kind') or 'a collective'} "
            f"seq={peer['issued_seq']}"
            + (f", step {lag['step']}" if lag.get("step") is not None
               else "")
            + f"; peers issued seq={peer['issued_seq']}, "
              f"last completed seq={completed}")
    return {"rank": lag["rank"], "seq": peer["issued_seq"],
            "kind": peer.get("issued_kind"), "step": lag.get("step"),
            "text": text}


def _publish_and_gather(budget):
    """Publish this rank's last seq row to the store; gather peers' rows
    within ``budget`` seconds. Returns the rows (>=2) or None."""
    rec = _rec
    rank = rec.rank if rec is not None else _fault.fault_rank()
    world = rec.world_size if rec is not None else _env_world()
    if world <= 1:
        return None
    store = _side_store(rec, rank, world, budget)
    if store is None:
        return None
    me = _row_of(rec, rank)
    scope = store_scope()
    store.set(f"{scope}/wd/{rank}", json.dumps(me).encode())
    rows = [me]
    per = max(0.5, float(budget) / max(1, 2 * (world - 1)))
    for r in range(world):
        if r == rank:
            continue
        try:
            rows.append(json.loads(
                store.get(f"{scope}/wd/{r}", timeout=per).decode()))
        except Exception:
            pass
    return rows if len(rows) > 1 else None


def watchdog_escalation(timeout_s, budget):
    """The watchdog's dump-then-blame path (tentpole (3)): write the dump
    FIRST (must land even with the store unreachable), then publish this
    rank's last seq, gather peers' within ``budget`` seconds, compute
    blame, fold blame + latency back into the dump. Never raises; returns
    the blame text or None."""
    t0 = time.monotonic()
    path = None
    try:
        path = dump(reason="watchdog_timeout",
                    extra={"watchdog_timeout_s": timeout_s})
    except Exception as e:
        print(f"[flight-recorder] dump failed: {e}", file=sys.stderr,
              flush=True)
    rows, blame = None, None
    try:
        rows = _publish_and_gather(budget)
        if rows:
            blame = blame_rows(rows)
    except Exception as e:
        print(f"[flight-recorder] blame gather failed: {e}",
              file=sys.stderr, flush=True)
    if blame is not None:
        print(f"[flight-recorder] blame: {blame['text']}",
              file=sys.stderr, flush=True)
    if path is not None:
        try:
            with open(path) as f:
                doc = json.load(f)
            doc["peer_rows"] = rows
            doc["blame"] = blame
            doc["escalate_ms"] = round((time.monotonic() - t0) * 1e3, 1)
            _fault.atomic_write_bytes(
                path, json.dumps(doc, indent=1, default=str).encode())
        except Exception:
            pass
    return blame["text"] if blame is not None else None


# ----------------------------------------------- launcher-side post-mortem

def collect_dumps(dump_dir):
    """Read every per-rank dump under ``dump_dir`` (launcher/bench/tests)."""
    import glob
    out = []
    for p in sorted(glob.glob(os.path.join(dump_dir,
                                           "flight_recorder.*.json"))):
        try:
            with open(p) as f:
                out.append(json.load(f))
        except Exception:
            pass
    return out


def rows_from_dumps(dumps):
    rows = []
    for d in dumps:
        li = d.get("last_issued") or {}
        lc = d.get("last_completed") or {}
        rows.append({"rank": d.get("rank"),
                     "issued_seq": li.get("seq", 0) or 0,
                     "issued_kind": li.get("kind"),
                     "completed_seq": lc.get("seq", 0) or 0,
                     "step": d.get("step")})
    return rows


def format_post_mortem(dumps):
    """One-screen launcher post-mortem from the per-rank dumps, e.g.::

        [post-mortem] collective flight recorder (3 rank dump(s)):
        [post-mortem]   rank 0 [watchdog_timeout]: waiting inside barrier seq=8 (step 3)
        [post-mortem]   rank 1 [watchdog_timeout]: completed barrier seq=6 (step 2), issued nothing after
        [post-mortem] blame: rank 1 stalled before barrier seq=8, step 2; ...
    """
    if not dumps:
        return None
    lines = [f"[post-mortem] collective flight recorder "
             f"({len(dumps)} rank dump(s)):"]
    for d in sorted(dumps, key=lambda d: (d.get("rank") or 0)):
        li = d.get("last_issued")
        if not d.get("enabled"):
            what = "recorder disabled (stacks-only dump)"
        elif li is None:
            what = "no collectives recorded"
        elif li.get("status") == "issued":
            what = (f"waiting inside {li.get('kind')} seq={li.get('seq')} "
                    f"(step {d.get('step')})")
        else:
            what = (f"completed {li.get('kind')} seq={li.get('seq')} "
                    f"(step {d.get('step')}), issued nothing after")
        lines.append(f"[post-mortem]   rank {d.get('rank')} "
                     f"[{d.get('reason', '?')}]: {what}")
    blame = blame_rows(rows_from_dumps(dumps))
    if blame is not None:
        lines.append(f"[post-mortem] blame: {blame['text']}")
    return "\n".join(lines)
