"""Elastic training — TCPStore-backed membership + scale-aware relaunch:
the port's copy of ``paddle_tpu/distributed/elastic.py`` (the registry's
keys, records and round specs are the JAX package's, so either
package's launcher, agents and workers meet in one registry).

Reference: python/paddle/distributed/fleet/elastic/manager.py:126
(ElasticManager: etcd membership, watch loop :598, scale in/out triggers
relaunch). This environment has no etcd; the native C++ TCPStore
(core/native/tcp_store.cpp) plays the registry: every worker heartbeats
``elastic/host/<name> -> timestamp``; the manager scans for liveness, and a
membership change inside [min_np, max_np] reports a scale event the
launcher turns into a relaunch with the new world size (checkpoint-resume
is the state story, reference recovery model).

Multi-host extension (node-level elastic, ``--nnodes MIN:MAX``): the unit
of membership becomes a whole NODE. Each host runs a
:mod:`~paddle_tpu_torch.distributed.launch.node_agent` that supervises its
local workers and heartbeats a node-scoped record through
:class:`NodeRegistry`; the coordinator publishes *round specs* (world
size, node→rank map, quarantine list) that agents apply by relaunching
their workers with re-rendered env. :class:`QuarantineList` keeps a
sliding window of per-node failures so a flaky host degrades capacity
instead of livelocking the job in relaunch cycles.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .tcp_store import TCPStore
from . import keyspace as ks

__all__ = ["ElasticManager", "ElasticStatus", "worker_from_env",
           "NodeRegistry", "QuarantineList", "render_node_round"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """Membership registry + watcher (reference: ElasticManager).

    Manager side (rank 0 / launcher)::

        em = ElasticManager(job_id, np="2:4", host="127.0.0.1", port=6379,
                            is_master=True)
        em.register(my_name)
        status = em.watch(timeout=...)   # RESTART on scale event

    Worker side: register + background heartbeat only.
    """

    def __init__(self, job_id, np, host="127.0.0.1", port=6379,
                 is_master=False, ttl=10.0, timeout=900):
        self.job_id = job_id
        self.min_np, self.max_np = self._parse_np(np)
        self.store = TCPStore(host=host, port=port, is_master=is_master,
                              world_size=self.max_np, timeout=timeout)
        self.ttl = float(ttl)
        self._prefix = ks.elastic_job(job_id)
        self._name = None
        self._beat_thread = None
        self._stop = threading.Event()
        self._join_cache = {}  # idx -> name; join-log entries are immutable

    @staticmethod
    def _parse_np(np_spec):
        """'N' or 'min:max' (reference manager.py _parse_np)."""
        if isinstance(np_spec, int):
            return np_spec, np_spec
        s = str(np_spec)
        if ":" in s:
            lo, hi = s.split(":")
            return int(lo), int(hi)
        return int(s), int(s)

    # -- membership --
    def register(self, name=None):
        self._name = name or f"{os.uname().nodename}-{os.getpid()}"
        self.store.set(f"{self._prefix}/hosts/{self._name}",
                       str(time.time()))
        # append to the join sequence: the manager discovers members it did
        # not announce (node-join → scale-out) by scanning this log, since
        # the TCPStore has no key enumeration
        idx = self.store.add(f"{self._prefix}/join_seq", 1)
        self.store.set(f"{self._prefix}/join/{idx}", self._name)
        self._stop.clear()
        self._beat_thread = threading.Thread(target=self._beat_loop,
                                             daemon=True)
        self._beat_thread.start()
        return self._name

    def _beat_loop(self):
        while not self._stop.wait(self.ttl / 3):
            try:
                self.store.set(f"{self._prefix}/hosts/{self._name}",
                               str(time.time()))
            except Exception:
                return

    def deregister(self):
        self._stop.set()
        if self._name:
            self.store.set(f"{self._prefix}/hosts/{self._name}", "0")

    def joined_names(self):
        """Every member that ever registered, in join order (the join-seq
        log survives deaths; liveness is the heartbeat's job). Resolved
        entries are cached — the log is append-only and immutable — so
        the launcher's ~5 Hz poll costs one ``add`` round-trip at steady
        state instead of a full rescan; only still-unresolved indices
        (a registrant between its seq bump and its name write, or one
        that died in that window) are re-probed."""
        try:
            n = int(self.store.add(f"{self._prefix}/join_seq", 0))
        except Exception:
            return []
        out = []
        for i in range(1, n + 1):
            name = self._join_cache.get(i)
            if name is None:
                key = f"{self._prefix}/join/{i}"
                if not self.store.check(key):
                    continue
                name = self.store.get(key).decode()
                self._join_cache[i] = name
            out.append(name)
        return out

    def new_joins(self, known):
        """Names that registered but are NOT in ``known`` — the launcher's
        scale-out trigger (a freshly joined node widens the world)."""
        known = set(known)
        return [n for n in self.joined_names() if n not in known]

    def hosts(self):
        """Live members (heartbeat within ttl): the announced roster plus
        any later joiner from the join-seq log."""
        names = self.store.get(f"{self._prefix}/roster").decode() \
            if self.store.check(f"{self._prefix}/roster") else ""
        candidates = list(dict.fromkeys(
            list(filter(None, names.split(","))) + self.joined_names()))
        alive = []
        now = time.time()
        for name in candidates:
            key = f"{self._prefix}/hosts/{name}"
            if not self.store.check(key):
                continue
            try:
                ts = float(self.store.get(key).decode())
            except ValueError:
                continue
            if now - ts <= self.ttl:
                alive.append(name)
        return alive

    def announce(self, names):
        """Manager records the roster it is tracking."""
        self.store.set(f"{self._prefix}/roster", ",".join(names))

    # -- watch loop (manager) --
    def watch(self, interval=1.0, max_wait=None):
        """Block until membership differs from the ANNOUNCED roster or the
        job completes.

        Returns ElasticStatus.RESTART when the live set changed but stays
        within [min_np, max_np]; EXIT when it fell below min_np for longer
        than ttl; COMPLETED when the completion flag is set; HOLD when
        max_wait elapses with no event."""
        try:
            roster = self.store.get(f"{self._prefix}/roster").decode() \
                if self.store.check(f"{self._prefix}/roster") else ""
        except Exception:
            return ElasticStatus.ERROR
        baseline = set(filter(None, roster.split(",")))
        waited = 0.0
        below_since = None
        while True:
            try:
                if self.store.check(f"{self._prefix}/completed"):
                    return ElasticStatus.COMPLETED
                live = set(self.hosts())
            except Exception:
                # dead master: the store's bounded reconnect retries were
                # exhausted — report instead of spinning forever
                return ElasticStatus.ERROR
            if live != baseline:
                if len(live) >= self.min_np:
                    return ElasticStatus.RESTART
                below_since = below_since or time.time()
                if time.time() - below_since > self.ttl:
                    return ElasticStatus.EXIT
            else:
                below_since = None
            time.sleep(interval)
            waited += interval
            if max_wait is not None and waited >= max_wait:
                return ElasticStatus.HOLD

    def complete(self):
        self.store.set(f"{self._prefix}/completed", "1")


# -- worker-side bootstrap (launcher exports the env) --

_env_worker = None
_env_worker_lock = threading.Lock()


def worker_from_env():
    """Register this process with the launcher's elastic registry when
    PADDLE_TPU_ELASTIC_JOB_ID is set (and start the background heartbeat).
    Idempotent; returns the ElasticManager or None outside elastic jobs.
    Called from init_parallel_env so every launcher-managed trainer
    heartbeats without code changes."""
    global _env_worker
    job = os.environ.get("PADDLE_TPU_ELASTIC_JOB_ID")
    store_addr = os.environ.get("PADDLE_TPU_ELASTIC_STORE")
    if not job or not store_addr:
        return None
    with _env_worker_lock:
        if _env_worker is not None:
            return _env_worker
        host, port = store_addr.rsplit(":", 1)
        em = ElasticManager(
            job, os.environ.get("PADDLE_TPU_ELASTIC_NP", "1"),
            host=host, port=int(port),
            ttl=float(os.environ.get("PADDLE_TPU_ELASTIC_TTL", "10")))
        em.register(os.environ.get("PADDLE_TPU_ELASTIC_NAME"))
        _env_worker = em
        return em


# ---------------------------------------------------- node-level registry

class NodeRegistry:
    """Node-scoped rendezvous state over a (failover-capable) store.

    Two planes, both namespaced under ``elastic/<job>/node``:

    - **membership**: agents ``register`` once (append-only join log, same
      shape as ElasticManager's — the TCPStore has no key enumeration)
      and ``beat`` a JSON record every ttl/3 (node id, host, round,
      worker statuses, timestamp). ``live()`` filters by heartbeat age.
    - **rounds**: the coordinator ``publish_round``\\ s a spec (world
      size, node→node_rank map, quarantine list); agents poll
      ``round_no()`` and apply only the NEWEST spec — an agent that
      missed rounds (stalled, partitioned) jumps straight to the latest,
      which is exactly the fencing semantics a zombie node needs.

    The store may be a :class:`~paddle_tpu_torch.distributed.tcp_store.
    FailoverStore`: after a failover the standby is EMPTY, so the join-log
    cache is invalidated whenever the store incarnation moved and callers
    re-register / re-publish through their ``on_failover`` hooks."""

    def __init__(self, store, job_id, ttl=10.0):
        self.store = store
        self.ttl = float(ttl)
        self._prefix = ks.elastic_node(job_id)
        self._join_cache = {}
        self._inc_seen = getattr(store, "incarnation", 0)

    def _maybe_invalidate(self):
        inc = getattr(self.store, "incarnation", 0)
        if inc != self._inc_seen:
            self._join_cache.clear()
            self._inc_seen = inc

    # -- membership (agent side) --
    def register(self, node_id, record):
        """First beat + append to the node join log."""
        self.beat(node_id, record)
        idx = self.store.add(f"{self._prefix}/join_seq", 1)
        self.store.set(f"{self._prefix}/join/{idx}", node_id)

    def beat(self, node_id, record):
        rec = dict(record)
        rec["node"] = node_id
        rec["ts"] = time.time()
        self.store.set(f"{self._prefix}/r/{node_id}",
                       json.dumps(rec).encode())

    # -- membership (shared) --
    def record(self, node_id):
        key = f"{self._prefix}/r/{node_id}"
        try:
            if not self.store.check(key):
                return None
            return json.loads(self.store.get(key).decode())
        except Exception:
            return None

    def joined(self):
        """Every node that ever registered, in join order (cached like
        ElasticManager.joined_names; invalidated on store failover)."""
        self._maybe_invalidate()
        try:
            n = int(self.store.add(f"{self._prefix}/join_seq", 0))
        except Exception:
            return []
        out = []
        for i in range(1, n + 1):
            name = self._join_cache.get(i)
            if name is None:
                key = f"{self._prefix}/join/{i}"
                try:
                    if not self.store.check(key):
                        continue
                    name = self.store.get(key).decode()
                except Exception:
                    continue
                self._join_cache[i] = name
            if name not in out:
                out.append(name)
        return out

    def live(self, node_ids=None, now=None):
        """node_id -> record for every node whose heartbeat is fresh."""
        now = time.time() if now is None else now
        out = {}
        for nid in (self.joined() if node_ids is None else node_ids):
            rec = self.record(nid)
            if rec is not None and now - float(rec.get("ts", 0)) <= self.ttl:
                out[nid] = rec
        return out

    # -- rounds (coordinator publishes, agents poll) --
    def publish_round(self, spec) -> int:
        no = int(self.store.add(f"{self._prefix}/round_seq", 1))
        spec = dict(spec)
        spec["round"] = no
        self.store.set(f"{self._prefix}/round/{no}",
                       json.dumps(spec).encode())
        return no

    def republish_round(self, spec):
        """After a store failover: reinstall the CURRENT round into the
        (empty) standby without bumping the round number — agents seeing
        an unchanged round number keep their workers running, so training
        rides through the control-plane failover untouched."""
        no = int(spec["round"])
        self.store.set(f"{self._prefix}/round/{no}",
                       json.dumps(spec).encode())
        cur = int(self.store.add(f"{self._prefix}/round_seq", 0))
        if cur < no:
            self.store.add(f"{self._prefix}/round_seq", no - cur)

    def round_no(self) -> int:
        try:
            return int(self.store.add(f"{self._prefix}/round_seq", 0))
        except Exception:
            return 0

    def poll(self):
        """``(is_complete, round_no)`` in one pass, RAISING on store
        failure — unlike the defensive readers above. The agent's orphan
        fencing must SEE unreachability: an exception-swallowing poll
        would let a node whose control plane is gone run stale workers
        forever.

        The raise DISTINGUISHES gone from re-homed:
        a clean failover to a standby candidate completes *inside* the
        FailoverStore and this poll returns normally (the caller sees
        ``store.incarnation`` moved); only
        :class:`~paddle_tpu_torch.distributed.tcp_store.
        StoreCandidatesExhausted` — every candidate down for the full
        failover deadline — means the control plane is gone. The agent
        arms its ``PADDLE_TPU_AGENT_ORPHAN_S`` self-fence clock on THAT
        type alone, so a healthy node is never fenced mid-failover."""
        complete = bool(self.store.check(f"{self._prefix}/complete"))
        return complete, int(self.store.add(f"{self._prefix}/round_seq", 0))

    def round(self, no, probe=False):
        """Round spec ``no`` or None. ``probe=True`` checks existence
        first so an ABSENT round returns None immediately instead of
        blocking the full store timeout in ``get`` — the failover
        gap-filler probes an un-replicated standby exactly when stalling
        the coordinator's lease beats would be most damaging."""
        key = f"{self._prefix}/round/{no}"
        try:
            if probe and not self.store.check(key):
                return None
            return json.loads(self.store.get(key).decode())
        except Exception:
            return None

    def announce_complete(self):
        self.store.set(f"{self._prefix}/complete", b"1")

    def is_complete(self) -> bool:
        try:
            return bool(self.store.check(f"{self._prefix}/complete"))
        except Exception:
            return False


def render_node_round(participants, nproc_per_node, master,
                      quarantined=(), store_inc=0):
    """One round spec: the coordinator's single source of the node→rank
    map. ``participants`` order is the registration order, so node_rank 0
    (whose first worker binds the process group's rendezvous store) stays on the
    longest-lived node."""
    participants = list(participants)
    return {
        "nodes": {nid: i for i, nid in enumerate(participants)},
        "nproc": int(nproc_per_node),
        "world": len(participants) * int(nproc_per_node),
        "master": master,
        "quarantined": list(quarantined),
        "store_inc": int(store_inc),
    }


# --------------------------------------------------- flaky-node quarantine

class QuarantineList:
    """Sliding-window failure ledger per node: ``threshold`` blamed
    failures of the SAME node inside ``window_s`` seconds quarantine it —
    the node is excluded from every later rendezvous round, degrading
    capacity instead of livelocking the job in relaunch cycles. Collateral
    deaths (survivors shot by a broken collective) must NOT be recorded
    here; only causal blame (node loss, a real worker failure exit)."""

    def __init__(self, window_s=300.0, threshold=2):
        self.window_s = float(window_s)
        self.threshold = max(1, int(threshold))
        self._failures = {}     # node_id -> [monotonic stamps]
        self._quarantined = {}  # node_id -> stamp quarantined at
        self.hits = 0           # total quarantine events (bench metric)

    def record_failure(self, node_id, now=None) -> bool:
        """Record one blamed failure; True when this pushed the node into
        quarantine (idempotent for already-quarantined nodes)."""
        if node_id in self._quarantined:
            return False
        now = time.monotonic() if now is None else now
        stamps = [t for t in self._failures.get(node_id, [])
                  if now - t <= self.window_s]
        stamps.append(now)
        self._failures[node_id] = stamps
        if len(stamps) >= self.threshold:
            self._quarantined[node_id] = now
            self.hits += 1
            return True
        return False

    def is_quarantined(self, node_id) -> bool:
        return node_id in self._quarantined

    def quarantined(self):
        return sorted(self._quarantined)

    def to_dict(self, now=None):
        """Checkpoint the ledger for the replicated coordinator state.
        Stamps are serialized as AGES (seconds before the checkpoint):
        monotonic-clock readings are meaningless in another process, so
        the shadow re-anchors them onto its own clock at restore."""
        now = time.monotonic() if now is None else now
        return {
            "window_s": self.window_s,
            "threshold": self.threshold,
            "hits": self.hits,
            "quarantined": {nid: now - t
                            for nid, t in self._quarantined.items()},
            "failures": {nid: [now - t for t in ts]
                         for nid, ts in self._failures.items()},
        }

    def restore(self, state, now=None):
        """Adopt a checkpointed ledger (coordinator shadow takeover):
        quarantined nodes stay excluded and in-window failure stamps keep
        counting toward the threshold across the takeover."""
        if not state:
            return self
        now = time.monotonic() if now is None else now
        self.window_s = float(state.get("window_s", self.window_s))
        self.threshold = max(1, int(state.get("threshold",
                                              self.threshold)))
        self.hits = int(state.get("hits", 0))
        self._quarantined = {
            nid: now - float(age)
            for nid, age in (state.get("quarantined") or {}).items()}
        self._failures = {
            nid: [now - float(a) for a in ages]
            for nid, ages in (state.get("failures") or {}).items()}
        return self
