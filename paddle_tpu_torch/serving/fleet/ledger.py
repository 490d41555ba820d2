"""Durable request ledger + router lease — the fleet's exactly-once spine.

The port of ``paddle_tpu/serving/fleet/ledger.py`` (host Python). Without
it every bit of front-door state — pending legs, affinity, hedge
bookkeeping, streamed-token cursors — lives in one
:class:`~.router.FleetRouter` process, and a router death orphans every
in-flight request. This module journals each request's lifecycle into
the control-plane store under registry-scope keys
(:func:`~paddle_tpu_torch.distributed.keyspace.fleet_ledger`), which ride
the FailoverStore WAL like fleet membership does: a promoted standby
store still holds the journal, and a shadow router rebuilds the front
door from it.

**Record lifecycle** (one JSON record per request id, last write wins —
the leased router is the single writer)::

    accepted ──▶ dispatched(engine, leg) ──▶ streaming(cursor, tokens)
                                                  └──▶ done | failed

**Exactly-once contract** (client-supplied request ids are the
idempotency key, end to end — the same id dedupes in this ledger AND in
the engine-side store-RPC server):

* resubmitting a **terminal** id replays the recorded result —
  identical tokens or the same typed error — without touching any
  engine;
* resubmitting an **in-flight** id attaches the caller to the live leg
  (same ``FleetRequest``), never generating twice;
* after a router failover the shadow adopts every non-terminal record:
  it re-attaches to engines' live legs through the store-RPC streams,
  replaying only each request's unstreamed tail off the persisted
  ``cursor``, and re-dispatches legs whose engine died with the router.

``lookup`` + ``accept`` + ``dispatched`` are one store round trip each on
the submit path: that is the durability the contract is made of.
Token-cursor updates are not per token: the router's sweep batches them
(one write per changed request per sweep tick).

:class:`RouterLease` is the serving twin of the coordinator lease in
``launch/main.py``: the term counter is the fence — a shadow adopting
the front door bumps it, and every later renewal by the deposed router
raises :class:`RouterDeposedError` (exit ``EXIT_DEPOSED``, 76, as a
deposed coordinator).
"""
from __future__ import annotations

import json
import os
import threading
import time

from ...distributed import keyspace
from ..scheduler import EngineClosed, EngineShuttingDown, QueueFull

__all__ = ["RequestLedger", "RouterLease", "RouterDeposedError",
           "TERMINAL_STATES"]

TERMINAL_STATES = ("done", "failed")

# typed errors cross the ledger the same way they cross the store-RPC
# wire: retryability-preserving reconstruction on replay
_ERRORS = {"QueueFull": QueueFull,
           "EngineShuttingDown": EngineShuttingDown,
           "EngineClosed": EngineClosed}


class RouterDeposedError(RuntimeError):
    """This router's lease term was superseded: a shadow adopted the
    front door while this instance was presumed dead. The holder must
    stop dispatching (exit ``EXIT_DEPOSED``) instead of split-braining
    the fleet — its ledger writes would race the adopter's."""


def rebuild_error(err):
    """Recorded ``{"type", "msg"}`` -> the typed exception instance."""
    if err is None:
        return None
    cls = _ERRORS.get(err.get("type"), RuntimeError)
    return cls(err.get("msg", "recorded request error"))


class RequestLedger:
    """Journal request lifecycles under ``serving/<job>/ledger/...``.

    One store client, many callers (router dispatch threads, engine
    completion callbacks, the sweep) — ops serialize behind one lock,
    the same rule :class:`~.registry.EngineRegistry` follows.
    """

    def __init__(self, store, job="fleet"):
        self.store = store
        self.job = str(job)
        self._prefix = keyspace.fleet_ledger(self.job)
        self._store_lock = threading.Lock()
        self._idx_cache = {}     # join-log idx -> rid (immutable)

    def _k(self, *parts):
        return "/".join((self._prefix,) + parts)

    # ----------------------------------------------------------- records
    def _write(self, rid, rec):
        with self._store_lock:
            # the lock only serializes this one store client; no
            # router/engine lock is ever taken inside it
            self.store.set(self._k("req", str(rid)), json.dumps(rec))

    def lookup(self, rid):
        """Latest record for one request id (None = never accepted)."""
        key = self._k("req", str(rid))
        try:
            with self._store_lock:
                if not self.store.check(key):
                    return None
                raw = self.store.get(key, timeout=10)
            return json.loads(raw)
        except Exception:
            return None

    @staticmethod
    def _base_record(fr):
        rec = {"rid": str(fr.request_id),
               "prompt": [int(t) for t in fr.prompt_ids],
               "max_new_tokens": int(fr.max_new_tokens),
               "eos_token_id": fr.eos_token_id,
               "temperature": fr.temperature, "top_k": fr.top_k,
               "engine_id": fr.engine_id,
               "engine_ids": list(fr.engine_ids)}
        # the trace context rides the journal so a shadow that adopts or
        # replays this request keeps stamping the SAME trace id
        trace = getattr(fr, "trace", None)
        if trace is not None:
            rec["trace"] = trace
        return rec

    def accept(self, fr):
        """Journal admission (state ``accepted``) and append the rid to
        the join-log — the enumeration a shadow reconstructs from (the
        store has no key listing; same idiom as the engine registry).
        Call once per NEW rid: the submit path's ``lookup`` already
        proved novelty, so no existence re-check burns a round-trip."""
        rec = self._base_record(fr)
        rec.update(state="accepted", cursor=0, tokens=[], error=None)
        self._write(fr.request_id, rec)
        with self._store_lock:
            # join-log append: the durable enumeration record, a
            # dispatch-path round trip by design
            idx = int(self.store.add(self._k("seq"), 1))
            self.store.set(self._k("idx", str(idx)),
                           str(fr.request_id))

    def dispatched(self, fr, engine_id, leg_rid=None):
        """Journal a placement: which engine, which engine-side leg id
        (the store-RPC wire rid for remote legs — the handle a shadow
        re-attaches to). Re-dispatches and hedge promotions re-journal
        with the new engine; ``cursor``/``tokens`` carry forward."""
        rec = self._base_record(fr)
        with fr._tok_lock:
            toks = [int(t) for t in fr.generated]
        rec.update(state="dispatched", engine_id=engine_id,
                   leg_rid=leg_rid, cursor=len(toks), tokens=toks,
                   error=None)
        self._write(fr.request_id, rec)

    def streaming(self, fr, tokens, leg_rid=None):
        """Journal the surfaced-token cursor (batched by the router's
        sweep — never per token). ``tokens`` is the full surfaced list:
        a shadow pre-seeds the client's view from it, so re-attachment
        replays only the unstreamed tail."""
        rec = self._base_record(fr)
        rec.update(state="streaming", leg_rid=leg_rid,
                   cursor=len(tokens),
                   tokens=[int(t) for t in tokens], error=None)
        self._write(fr.request_id, rec)

    def terminal(self, fr):
        """Journal the terminal state: full token list on success, the
        typed error on failure — the replayable result of record."""
        rec = self._base_record(fr)
        with fr._tok_lock:
            toks = [int(t) for t in fr.generated]
        err = fr.error
        rec.update(state="failed" if err is not None else "done",
                   cursor=len(toks), tokens=toks,
                   error=None if err is None else
                   {"type": type(err).__name__, "msg": str(err)},
                   queue_wait_s=fr.queue_wait_s,
                   evictions=fr.evictions)
        self._write(fr.request_id, rec)

    # --------------------------------------------------------- discovery
    def rids(self):
        """Every request id ever accepted, in acceptance order."""
        try:
            with self._store_lock:
                n = int(self.store.add(self._k("seq"), 0))
        except Exception:
            return []
        out = []
        for i in range(1, n + 1):
            rid = self._idx_cache.get(i)
            if rid is None:
                key = self._k("idx", str(i))
                try:
                    with self._store_lock:
                        if not self.store.check(key):
                            continue
                        rid = self.store.get(key, timeout=10).decode()
                except Exception:
                    continue
                self._idx_cache[i] = rid
            if rid not in out:
                out.append(rid)
        return out

    def inflight_records(self):
        """Every non-terminal record, acceptance order — the set a
        shadow router adopts at takeover."""
        out = []
        for rid in self.rids():
            rec = self.lookup(rid)
            if rec is not None and rec.get("state") not in TERMINAL_STATES:
                out.append(rec)
        return out


class RouterLease:
    """Primary/shadow lease for the serving front door.

    The same protocol as the coordinator lease in ``launch/main.py``:
    ``acquire()`` bumps the term counter (the fence) and publishes the
    lease JSON; ``beat()`` renews at ttl/3 and raises
    :class:`RouterDeposedError` the moment the term moved under us;
    ``adopt()`` is the shadow's takeover bump. ``stale_age()`` measures
    lease staleness on the WATCHER's monotonic clock since the last
    observed stamp change — never by differencing two hosts' wall
    clocks (NTP skew would depose a healthy primary on sight).
    """

    def __init__(self, store, job="fleet", ttl=3.0, router_id=None):
        self.store = store
        self.job = str(job)
        self.ttl = float(ttl)
        self.router_id = str(router_id) if router_id is not None \
            else f"router-{os.getpid()}"
        self.term = 0
        self._prefix = keyspace.fleet_router(self.job)
        self._next = 0.0
        self._lock = threading.Lock()
        # shadow-side staleness state (monotonic since last stamp change)
        self._last_ts = None
        self._fresh_at = None

    def _k(self, leaf):
        return f"{self._prefix}/{leaf}"

    def current_term(self):
        return int(self.store.add(self._k("term"), 0))

    def acquire(self):
        """Take the next term and publish the first lease (primary)."""
        # store round-trip outside the lock: the add is atomic in the
        # store, the lock only guards the local term/throttle fields
        new_term = int(self.store.add(self._k("term"), 1))
        with self._lock:
            self.term = new_term
        self.publish()
        return self.term

    # the shadow's takeover is the same bump — the names document intent
    adopt = acquire

    def publish(self):
        """Renew the lease NOW, with the deposed-term fence."""
        with self._lock:
            term = self.term
            self._next = time.monotonic() + self.ttl / 3.0
        cur = self.current_term()
        if cur != term:
            raise RouterDeposedError(
                f"router lease term moved {term} -> {cur}: a shadow "
                "adopted the front door while this router was presumed "
                "dead")
        self.store.set(self._k("lease"), json.dumps(
            {"term": term, "ts": time.time(), "pid": os.getpid(),
             "router_id": self.router_id}))

    def beat(self):
        """Throttled renewal (ttl/3 cadence): cheap no-op between
        beats, so the dispatch path can call it per submit."""
        if time.monotonic() < self._next:
            return
        self.publish()

    def read(self):
        """-> published lease dict, or None (no primary yet)."""
        key = self._k("lease")
        try:
            if not self.store.check(key):
                return None
            return json.loads(self.store.get(key, timeout=10))
        except Exception:
            return None

    def stale_age(self):
        """Seconds since the lease stamp last CHANGED, on this
        process's monotonic clock (None until a lease is seen)."""
        lease = self.read()
        if lease is None:
            return None
        ts = lease.get("ts")
        now = time.monotonic()
        if ts != self._last_ts or self._fresh_at is None:
            self._last_ts, self._fresh_at = ts, now
        return now - self._fresh_at
