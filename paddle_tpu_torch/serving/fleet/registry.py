"""Engine registry — fleet membership and liveness over the TCPStore.

The port of ``paddle_tpu/serving/fleet/registry.py`` (host Python), the
serving twin of ``elastic.ElasticManager``'s host registry: every engine
replica registers under ``serving/<job>/...`` on the control-plane store
(a plain :class:`TCPStore` or a replicated :class:`FailoverStore` —
registry-scope keys ride the WAL, so a promoted standby already knows
the roster) and heartbeats one JSON record per ``ttl/3`` carrying its
load gauges (queue depth, active slots, KV occupancy, prefix remote
hits). The router discovers engines through the join log (the store has
no key enumeration) and treats a stale heartbeat as engine loss.

The autoscaler's quarantine ledger (an ``elastic.QuarantineList``) and
roster state persist here too, under ``serving/<job>/quarantine`` and
``serving/<job>/autoscale``: registry scope, so a struck-out engine
stays excluded across a store failover.
"""
from __future__ import annotations

import json
import os
import threading
import time
from ...distributed import keyspace

__all__ = ["EngineRegistry"]


class EngineRegistry:
    """Register/heartbeat/discover serving engines on one store."""

    def __init__(self, store, job="fleet", ttl=5.0):
        self.store = store
        self.job = str(job)
        self.ttl = float(ttl)
        self._prefix = keyspace.fleet_registry(self.job)
        self._beats = {}         # engine_id -> (stop event, thread)
        self._join_cache = {}    # join-log idx -> engine_id (immutable)
        # ONE store client, many callers (the heartbeat thread and every
        # router thread reading liveness): the client is not
        # thread-safe, so all ops serialize behind this lock
        self._store_lock = threading.Lock()

    def _k(self, *parts):
        return "/".join((self._prefix,) + parts)

    def _set(self, key, value):
        with self._store_lock:
            return self.store.set(key, value)

    def _get(self, key, timeout=None):
        with self._store_lock:
            return self.store.get(key, timeout=timeout)

    def _add(self, key, n):
        with self._store_lock:
            return self.store.add(key, n)

    def _check(self, key):
        with self._store_lock:
            return self.store.check(key)

    # ------------------------------------------------------ registration
    def _stats_record(self, engine, role, extra=None):
        rec = {"ts": time.time(), "role": role,
               "pid": os.getpid()}
        if engine is not None:
            try:
                s = engine.scheduler
                rec["queue_depth"] = s.queue_depth()
                rec["active_slots"] = len(s.active)
                rec["kv_occupancy_pct"] = round(
                    engine.kv.occupancy_pct(), 2)
                rec["decode_tokens"] = engine._decode_tokens
                share = getattr(engine.prefix, "share", None)
                if share is not None:
                    rec["prefix_remote_hits"] = share.remote_hits
                    rec["prefix_remote_hit_tokens"] = \
                        share.remote_hit_tokens
                    rec["prefix_published_pages"] = share.published
            except Exception:
                pass
        if extra:
            rec.update(extra)
        return rec

    def register(self, engine_id, engine=None, role="any", extra=None,
                 heartbeat=True):
        """Announce one engine and (by default) start its heartbeat
        thread. Records ride the join log so discovery needs no key
        enumeration."""
        eid = str(engine_id)
        self.publish(eid, engine, role, extra)
        idx = self._add(self._k("join_seq"), 1)
        self._set(self._k("join", str(idx)), eid)
        if heartbeat:
            stop = threading.Event()

            def beat():
                while not stop.wait(self.ttl / 3):
                    try:
                        self.publish(eid, engine, role, extra)
                    except Exception:
                        return  # store gone: the fleet sees a stale beat
            t = threading.Thread(target=beat, daemon=True,
                                 name=f"fleet-beat-{eid}")
            t.start()
            self._beats[eid] = (stop, t)
        return eid

    def publish(self, engine_id, engine=None, role="any", extra=None):
        """One heartbeat/stats record (also callable directly for a
        final flush before exit)."""
        self._set(self._k("eng", str(engine_id)),
                  json.dumps(self._stats_record(engine, role, extra)))

    def deregister(self, engine_id):
        eid = str(engine_id)
        beat = self._beats.pop(eid, None)
        if beat is not None:
            beat[0].set()
        try:
            rec = {"ts": 0, "role": "gone"}
            self._set(self._k("eng", eid), json.dumps(rec))
        except Exception:
            pass

    def close(self):
        for eid in list(self._beats):
            self.deregister(eid)

    # ------------------------------------------------------- quarantine
    def save_quarantine(self, quarantine, now=None):
        """Persist the fleet's quarantine ledger (registry scope: the
        JSON rides the WAL to the standby store)."""
        self._set(keyspace.fleet_quarantine(self.job),
                  json.dumps(quarantine.to_dict(now)))

    def load_quarantine(self, quarantine, now=None):
        """Restore ``quarantine`` from the persisted ledger (no-op when
        none was ever saved). Ages re-anchor against ``now`` so a strike
        window survives the wall-clock gap of a failover. -> bool
        (whether a ledger existed)."""
        key = keyspace.fleet_quarantine(self.job)
        try:
            if not self._check(key):
                return False
            state = json.loads(self._get(key, timeout=5))
        except Exception:
            return False
        quarantine.restore(state, now)
        return True

    def save_autoscale(self, state):
        """Persist the autoscaler's roster epoch + scale-event tail
        (registry scope — a promoted standby store still knows the
        fleet's intended size)."""
        self._set(f"{keyspace.fleet_autoscale(self.job)}/state",
                  json.dumps(state))

    def load_autoscale(self):
        """-> persisted autoscaler state dict, or None."""
        key = f"{keyspace.fleet_autoscale(self.job)}/state"
        try:
            if not self._check(key):
                return None
            return json.loads(self._get(key, timeout=5))
        except Exception:
            return None

    # --------------------------------------------------------- discovery
    def joined(self):
        """Every engine id that ever registered, in join order."""
        try:
            n = int(self._add(self._k("join_seq"), 0))
        except Exception:
            return []
        out = []
        for i in range(1, n + 1):
            eid = self._join_cache.get(i)
            if eid is None:
                key = self._k("join", str(i))
                if not self._check(key):
                    continue
                eid = self._get(key).decode()
                self._join_cache[i] = eid
            if eid not in out:
                out.append(eid)
        return out

    def record(self, engine_id):
        """Latest heartbeat record for one engine (None if absent)."""
        key = self._k("eng", str(engine_id))
        try:
            if not self._check(key):
                return None
            return json.loads(self._get(key, timeout=5))
        except Exception:
            return None

    def engines(self, live_only=True):
        """-> {engine_id: record}; ``live_only`` filters on heartbeat
        freshness (within ttl) — the router's liveness verdict."""
        now = time.time()
        out = {}
        for eid in self.joined():
            rec = self.record(eid)
            if rec is None:
                continue
            if live_only and now - float(rec.get("ts", 0)) > self.ttl:
                continue
            out[eid] = rec
        return out
