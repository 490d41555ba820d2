"""TCPStore — python binding over the native C++ store: the port's copy
of ``paddle_tpu/distributed/tcp_store.py`` (``TCPStore``,
``FailoverStore``, ``LogShipper``, the native ``Watchdog``,
``sweep_counter`` and the store errors; the wire protocol and the keys
are the JAX package's).

Reference: phi/core/distributed/store/tcp_store.h:121 exposed as
``paddle.distributed.TCPStore``. The C++ implementation lives in
core/native/tcp_store.cpp (built on demand with g++, cached as a .so);
ctypes binds it — no pybind11 dependency. Also exposes the collective
watchdog (CommTaskManager analog, comm_task_manager.cc:153).
"""
from __future__ import annotations

import base64
import ctypes
import itertools
import json
import os
import socket as _socket
import subprocess
import sys
import threading
import time
import uuid

from . import fault as _fault
from . import keyspace as ks

__all__ = ["TCPStore", "FailoverStore", "LogShipper", "Watchdog",
           "StoreTimeoutError", "StoreFencedError",
           "StoreConnectionRefused", "StoreCandidatesExhausted"]


class StoreTimeoutError(RuntimeError):
    """A blocking get() expired — the key never arrived. NOT retried (the
    wait already consumed the full deadline)."""


class StoreConnectionRefused(RuntimeError):
    """A fail-fast connect found nothing listening on the candidate's
    port (ECONNREFUSED). Deliberately NOT a ConnectionError so the
    connect retry loop never backs off on it: refused means the server
    process is GONE (vs. slow or unreachable), and a FailoverStore op
    should rotate to the next candidate immediately — failover latency
    bounded by detection, not by Backoff exhaustion."""


class StoreFencedError(RuntimeError):
    """A replicated mutating op was rejected by the epoch fence: the
    store's fence epoch moved past this writer's pinned epoch, meaning a
    failover promoted a new store lifetime while this writer kept writing
    to the old one. The deposed writer must not silently diverge the
    registry — it re-homes (agents) or abdicates (a deposed
    coordinator), never retries in place."""


class StoreCandidatesExhausted(RuntimeError):
    """Every FailoverStore candidate stayed unreachable for the full
    failover deadline — the control plane is GONE, not mid-failover.
    Distinct from a transient op failure (which re-homes internally and
    succeeds) so callers like the node agent's orphan self-fence can arm
    only on true exhaustion, never during a clean failover."""

_LIB = None
_LIB_LOCK = threading.Lock()


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from ..core.native_build import load_native_lib
        lib = load_native_lib("tcp_store.cpp", "libpd_tcp_store")
        lib.pd_store_server_start.restype = ctypes.c_void_p
        lib.pd_store_server_start.argtypes = [ctypes.c_int]
        lib.pd_store_server_stop.argtypes = [ctypes.c_void_p]
        lib.pd_store_client_connect.restype = ctypes.c_void_p
        lib.pd_store_client_connect.argtypes = [ctypes.c_char_p,
                                                ctypes.c_int, ctypes.c_int]
        lib.pd_store_client_close.argtypes = [ctypes.c_void_p]
        lib.pd_store_set.restype = ctypes.c_int
        lib.pd_store_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int64]
        lib.pd_store_get.restype = ctypes.c_int64
        lib.pd_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_char_p,
                                     ctypes.c_int64]
        lib.pd_store_add.restype = ctypes.c_int64
        lib.pd_store_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64]
        lib.pd_store_check.restype = ctypes.c_int
        lib.pd_store_check.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_store_delete.restype = ctypes.c_int
        lib.pd_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_watchdog_start.restype = ctypes.c_void_p
        lib.pd_watchdog_start.argtypes = [ctypes.c_int64]
        lib.pd_watchdog_start2.restype = ctypes.c_void_p
        lib.pd_watchdog_start2.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.pd_watchdog_beat.argtypes = [ctypes.c_void_p]
        lib.pd_watchdog_tripped.restype = ctypes.c_int
        lib.pd_watchdog_tripped.argtypes = [ctypes.c_void_p]
        lib.pd_watchdog_stop.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class TCPStore:
    """Reference API: paddle.distributed.TCPStore(host, port, is_master,
    world_size, timeout)."""

    def __init__(self, host="127.0.0.1", port=6170, is_master=False,
                 world_size=1, timeout=900, connect_deadline=None,
                 fail_fast_refused=False):
        lib = _load_lib()
        self._lib = lib
        self._server = None
        self._client = None
        self._host = host
        self._port = int(port)
        self._timeout_ms = int(timeout * 1000)
        self._connect_deadline = connect_deadline
        self._fail_fast_refused = bool(fail_fast_refused)
        if is_master:
            self._server = lib.pd_store_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore master failed to bind :{port}")
        try:
            self._connect()
        except Exception:
            if self._server:
                lib.pd_store_server_stop(self._server)
                self._server = None
            raise

    def _connect(self):
        """Connect with exponential backoff + deadline: a worker that comes
        up before the master has bound its port must outwait it instead of
        dying on the first refused connection."""
        deadline = self._connect_deadline
        if deadline is None:
            deadline = min(self._timeout_ms / 1000.0,
                           float(os.environ.get(
                               "PADDLE_TPU_STORE_CONNECT_DEADLINE", "30")))

        def once():
            if self._fail_fast_refused:
                # cheap python-level preflight: ECONNREFUSED means no
                # server is bound — the candidate is DEAD, not slow, so
                # surface a non-retried verdict instead of burning the
                # connect backoff budget against it (failover
                # latency bounded by detection). Anything
                # inconclusive (timeout, unreachable, filtered) falls
                # through to the native connect's own deadline.
                try:
                    _socket.create_connection(
                        (self._host, self._port),
                        timeout=min(deadline, 2.0)).close()
                except ConnectionRefusedError as e:
                    raise StoreConnectionRefused(
                        f"TCPStore {self._host}:{self._port} refused the "
                        "connection (no server bound)") from e
                except OSError:
                    pass
            # the native connect has its own retry-until-timeout loop:
            # bound it by OUR deadline, or one attempt against a dead
            # port blocks for the full store timeout (900s) and a
            # FailoverStore can never rotate to its standby
            c = self._lib.pd_store_client_connect(
                self._host.encode(), self._port,
                min(self._timeout_ms, max(50, int(deadline * 1000))))
            if not c:
                raise ConnectionError(
                    f"TCPStore could not connect "
                    f"{self._host}:{self._port}")
            self._client = c

        try:
            _fault.retry(once, retry_on=(ConnectionError,), attempts=None,
                         base=0.05, cap=1.0, deadline=deadline)
        except ConnectionError as e:
            raise RuntimeError(f"{e} (gave up after {deadline:.0f}s of "
                               "backoff)") from None

    def _drop_connection(self):
        if self._client:
            try:
                self._lib.pd_store_client_close(self._client)
            except Exception:
                pass
            self._client = None

    def _op(self, fn, idempotent=True):
        """Run one store op; on a dropped/failed connection reconnect with
        backoff and retry (bounded). A blocking-get timeout is NOT retried
        — it already consumed its full deadline. Non-idempotent ops (add)
        are never re-issued after a mid-op failure: the server may have
        applied the first attempt and a double-applied add would release a
        barrier early — only the reconnect of an already-dead client is
        retried for those. The injected ``store_drop`` fault severs the
        socket *before* the op is issued, so it exercises exactly that
        safe path."""
        if _fault.maybe_inject("store") == "store_drop":
            self._drop_connection()
        delays = _fault.Backoff(base=0.05, cap=0.5).delays()
        for attempt in range(3):
            if self._client is None:
                self._connect()
            try:
                return fn()
            except StoreTimeoutError:
                raise
            except (RuntimeError, ConnectionError):
                self._drop_connection()
                if not idempotent or attempt == 2:
                    raise
                time.sleep(next(delays, 0.1))

    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()

        def do():
            rc = self._lib.pd_store_set(self._client, key.encode(), data,
                                        len(data))
            if rc != 0:
                raise RuntimeError(f"TCPStore.set({key!r}) failed")

        self._op(do)

    def get(self, key: str, timeout=None) -> bytes:
        """Blocking get. ``timeout`` (seconds) overrides the store-level
        deadline for this one call — e.g. a preemption-bounded barrier."""
        timeout_ms = self._timeout_ms if timeout is None \
            else max(1, int(timeout * 1000))

        def do():
            cap = 1 << 20
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.pd_store_get(self._client, key.encode(),
                                       timeout_ms, buf, cap)
            if n == -3:  # value larger than the fast-path buffer: retry at
                cap = 64 << 20  # the server's max accepted value size
                buf = ctypes.create_string_buffer(cap)
                n = self._lib.pd_store_get(self._client, key.encode(),
                                           timeout_ms, buf, cap)
            if n == -1:
                raise StoreTimeoutError(
                    f"TCPStore.get({key!r}) timed out after "
                    f"{timeout_ms} ms")
            if n < 0:
                raise RuntimeError(f"TCPStore.get({key!r}) failed ({n})")
            return buf.raw[:n]

        return self._op(do)

    def add(self, key: str, amount: int = 1) -> int:
        def do():
            v = self._lib.pd_store_add(self._client, key.encode(), amount)
            if v == -(2 ** 63):
                raise RuntimeError(f"TCPStore.add({key!r}) failed")
            return int(v)

        return self._op(do, idempotent=False)

    def check(self, key: str) -> bool:
        def do():
            rc = self._lib.pd_store_check(self._client, key.encode())
            if rc < 0:
                raise RuntimeError(f"TCPStore.check({key!r}) failed")
            return bool(rc)

        return self._op(do)

    def wait(self, keys, timeout=None):
        keys = [keys] if isinstance(keys, str) else list(keys)
        for k in keys:
            self.get(k)  # blocking get IS the wait

    def delete_key(self, key: str) -> bool:
        return self._op(
            lambda: self._lib.pd_store_delete(self._client,
                                              key.encode()) == 0)

    def barrier(self, name: str, world_size: int, timeout=None):
        """add+wait barrier (reference masterDaemon barrier pattern).
        ``timeout`` bounds the wait (StoreTimeoutError) — a dead peer must
        not hold a preempting rank past the launcher's kill grace."""
        from . import flight_recorder as _fr
        rec = _fr.record_issue("store_barrier", group="store",
                               extra={"name": name})
        n = self.add(f"__barrier/{name}", 1)
        if n >= world_size:
            self.set(f"__barrier/{name}/done", b"1")
        self.get(f"__barrier/{name}/done", timeout=timeout)
        _fr.record_complete(rec)

    def stop_server(self):
        """Stop the in-process master server, leaving clients (including
        this object's own) to fail on their next op. This is how the
        ``store_die`` chaos kind simulates the master node dying while
        every client lives: the coordinator stops the PRIMARY registry
        server and the FailoverStore clients re-home to the standby."""
        if getattr(self, "_server", None):
            self._lib.pd_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            if getattr(self, "_client", None):
                self._lib.pd_store_client_close(self._client)
            if getattr(self, "_server", None):
                self._lib.pd_store_server_stop(self._server)
        except Exception:
            pass


# replicated-mode writer identities: claims (`__wal/claim/<opid>`) make
# non-idempotent ops exactly-once across the failover window, so every
# writer needs an id no other process (or object) shares
_writer_ids = itertools.count()


def _reset_replication_state():
    """Test hook (conftest): fresh writer-id sequence per test so claim
    keys are deterministic and can never collide with a previous test's
    ops against a recycled store port."""
    global _writer_ids
    _writer_ids = itertools.count()


def sweep_counter(eps, key, target, probe_deadline=1.0, timeout=30,
                  exclude=None, name="store-counter-sweep"):
    """Best-effort STONITH sweep: push monotonic counter ``key`` up to
    ``target`` on every candidate in ``eps`` (skipping index
    ``exclude``) from a daemon thread. One copy for both halves of the
    control-plane fencing — the store epoch (:class:`FailoverStore`
    promotion) and the coordinator lease term (shadow takeover) — so a
    fix to the sweep semantics cannot drift between them. Dead or
    partitioned candidates are skipped silently (fail-fast refused
    connect); the partition window is the documented quorum tradeoff."""
    eps = list(eps)

    def sweep():
        for i, (host, port) in enumerate(eps):
            if i == exclude:
                continue
            try:
                s = TCPStore(host, port, is_master=False, timeout=timeout,
                             connect_deadline=probe_deadline,
                             fail_fast_refused=True)
                cur = int(s.add(key, 0))
                if cur < target:
                    s.add(key, target - cur)
            except Exception:
                pass  # dead candidate: nothing to fence

    t = threading.Thread(target=sweep, daemon=True, name=name)
    t.start()
    return t


def _trim_wal_entry(store, seq):
    """GC one aged WAL entry plus its claim/result bookkeeping pair
    (adds carry an opid; nothing else ever deletes the pair). Shared by
    the shipper's trim and the writer's self-trim — the entry is far
    enough in the past that no writer retry or shipper pump can still
    want it."""
    key = ks.wal_entry(seq)
    try:
        if store.check(key):
            entry = json.loads(store.get(key, timeout=5))
            opid = entry.get("id")
            if opid:
                store.delete_key(ks.wal_claim(opid))
                store.delete_key(ks.wal_result(opid))
        store.delete_key(key)
    except Exception:
        pass


class FailoverStore:
    """Warm-standby failover client over an ordered list of TCPStore
    master candidates (``"host:p1,host:p2"`` or a list of endpoints).

    The control plane of a multi-host elastic job must itself be
    survivable: when the node serving the rendezvous registry dies, every
    agent re-homes to the next candidate with Backoff instead of losing
    the job. Ops delegate to the active TCPStore; a connection failure
    that exhausts the inner reconnect retries rotates through the
    remaining candidates (short per-candidate connect deadline, overall
    bound ``PADDLE_TPU_STORE_FAILOVER_DEADLINE``). Each successful
    re-home bumps ``incarnation`` and notifies ``on_failover(store,
    incarnation)`` and the flight recorder, so store-scoped barrier/
    signature keys can never collide across store lifetimes.

    **Log-shipped replication** (on by default with >1
    candidate; ``PADDLE_TPU_STORE_REPLICATION=0`` disables): every
    mutating op on a registry-scope key (anything not ``__``-internal) is
    write-ahead logged on the active store (``__wal/<seq>``, monotonic
    ``__wal/seq``) before it is applied; a :class:`LogShipper` on the
    standby's host tails the log and applies each entry, so a promoted
    standby already holds the round history / membership / join-seq and
    the ``on_failover`` callback becomes a gap-filler for the un-acked
    tail, not a from-scratch rebuild. Non-idempotent ``add`` ops carry a
    claim id: a retry after a mid-op failover (or the shipper racing the
    writer's own gap-fill) adopts the recorded result instead of applying
    twice. Divergence is guarded by an **epoch fence**: writers pin the
    store's ``__fence/epoch`` at connect; a promotion bumps it (and
    best-effort sweeps it onto the deposed candidates), so a writer that
    kept writing to the old lifetime raises :class:`StoreFencedError`
    (ring-marked with the old epoch) instead of silently diverging.
    Registry keys are single-writer by construction (a node's own record,
    the coordinator's rounds), which is what makes WAL-order replay
    exact; ``add`` is commutative so interleaved writers replay clean.

    With a single candidate replication is OFF and every op is the same
    one delegated call as before — a constant-time no-op on the hot path
    (tested structurally). A blocking-get :class:`StoreTimeoutError` is
    NOT a failover trigger: the store answered, the key never arrived."""

    def __init__(self, endpoints, world_size=1, timeout=900,
                 connect_deadline=None, on_failover=None, replicate=None):
        if isinstance(endpoints, str):
            endpoints = [e for e in endpoints.split(",") if e.strip()]
        eps = []
        for ep in endpoints:
            if isinstance(ep, (tuple, list)):
                host, port = ep
            else:
                host, _, port = str(ep).strip().rpartition(":")
            eps.append((host or "127.0.0.1", int(port)))
        if not eps:
            raise ValueError("FailoverStore needs at least one endpoint")
        self._eps = eps
        self._world_size = int(world_size)
        self._timeout = timeout
        self._probe_deadline = connect_deadline if connect_deadline \
            is not None else float(os.environ.get(
                "PADDLE_TPU_STORE_PROBE_DEADLINE", "3"))
        self._on_failover = on_failover
        self._lock = threading.RLock()  # re-entrant: on_failover may issue
        self._idx = 0                   # store ops through this object
        self._incarnation = 0
        # initial connect also rotates: a client that starts AFTER the
        # primary died (a backfill node joining post-failover) must home
        # to whichever candidate is alive, not crash on the first. The
        # first candidate keeps the generous first-connect patience (the
        # master may bind late); later ones get the short probe deadline.
        last = None
        self._store = None
        for idx, (host, port) in enumerate(eps):
            try:
                self._store = TCPStore(
                    host, port, is_master=False, world_size=world_size,
                    timeout=timeout,
                    connect_deadline=None if idx == 0
                    else self._probe_deadline)
                self._idx = idx
                self._incarnation = idx  # starting on a standby adopts
                break                    # its incarnation ordinal
            except Exception as e:
                last = e
        if self._store is None:
            raise last
        # RE-connects inside an op must fail fast so a dead master
        # rotates to the standby instead of stalling the op for the
        # store-wide connect deadline — and a REFUSED reconnect (server
        # process gone) must not even spend that: it surfaces
        # StoreConnectionRefused immediately and the op rotates
        self._store._connect_deadline = self._probe_deadline
        self._store._fail_fast_refused = True
        if replicate is None:
            replicate = len(eps) > 1 and os.environ.get(
                "PADDLE_TPU_STORE_REPLICATION", "1") != "0"
        self._replicate = bool(replicate)
        # pid alone is NOT unique across hosts (or across pid reuse) and
        # a colliding writer id would let the claim protocol adopt some
        # OTHER writer's result — a random component makes the claim
        # namespace globally unique
        self._writer = (f"{uuid.uuid4().hex[:8]}."
                        f"{os.getpid()}.{next(_writer_ids)}")
        self._op_ids = itertools.count(1)
        self._trim_floor = float("inf")   # shipper-cursor floor cache
        self._trim_floor_refresh_at = 0   # next seq to refresh it at
        # optional higher-authority override for the epoch fence (the
        # coordinator wires its lease-term check here; see _check_fence)
        self._fence_resolver = None
        self._epoch = 0
        self._pinned = not self._replicate
        if self._replicate:
            # pin the store lifetime's fence epoch (a counter key, so
            # add(0) is an atomic read); writes from this pin are valid
            # until a promotion moves the epoch past it
            try:
                self._epoch = int(self._store.add(ks.FENCE_EPOCH, 0))
                self._pinned = True
            except Exception:
                pass  # fence pins lazily on the first mutating op

    @property
    def incarnation(self) -> int:
        return self._incarnation

    @property
    def epoch(self) -> int:
        """The fence epoch this writer's mutating ops are pinned to."""
        return self._epoch

    @property
    def replicated(self) -> bool:
        return self._replicate

    @property
    def active_endpoint(self):
        return self._eps[self._idx]

    def _failover_locked(self, err):
        """Rotate to the next reachable candidate (starting after the
        active one) within the failover deadline; bump the incarnation,
        advance the fence epoch on the promoted store (sweeping it onto
        the deposed candidates best-effort) and notify. Raises
        :class:`StoreCandidatesExhausted` when every candidate is down."""
        deadline = time.monotonic() + float(os.environ.get(
            "PADDLE_TPU_STORE_FAILOVER_DEADLINE", "20"))
        n = len(self._eps)
        start = self._idx
        delays = _fault.Backoff(base=0.1, cap=1.0).delays()
        while True:
            for k in range(1, n + 1):
                idx = (start + k) % n
                host, port = self._eps[idx]
                try:
                    store = TCPStore(
                        host, port, is_master=False,
                        world_size=self._world_size, timeout=self._timeout,
                        connect_deadline=self._probe_deadline,
                        fail_fast_refused=True)
                    # round-trip proof, not just a TCP accept: a wedged
                    # host whose server still accepts connects but fails
                    # every op must NOT be promoted — it exhausts the
                    # candidate list instead, which is the verdict the
                    # agent's orphan self-fence arms on
                    store.add(ks.FENCE_EPOCH, 0)
                except Exception:
                    continue
                self._store, self._idx = store, idx
                self._incarnation += 1
                acked = None
                if self._replicate:
                    old_epoch = self._epoch
                    try:
                        self._sync_epoch_after_rehome(store, old_epoch)
                        acked = int(store.add(ks.WAL_ACKED, 0))
                    except Exception as e:
                        print(f"[store] epoch sync on promotion failed: "
                              f"{e}", file=sys.stderr, flush=True)
                    self._fence_sweep(exclude=idx)
                print(f"[store] re-homed to standby {host}:{port} "
                      f"(store incarnation {self._incarnation}"
                      + (f", epoch {self._epoch}, replicated up to "
                         f"seq {acked}" if acked is not None else "")
                      + ")", file=sys.stderr, flush=True)
                from . import flight_recorder as _fr
                _fr.note_store_incarnation(self._incarnation)
                if self._on_failover is not None:
                    try:
                        self._on_failover(self, self._incarnation)
                    except Exception as e:
                        print(f"[store] on_failover callback failed: {e}",
                              file=sys.stderr, flush=True)
                return
            if time.monotonic() >= deadline:
                raise StoreCandidatesExhausted(
                    f"every store candidate unreachable "
                    f"({', '.join(f'{h}:{p}' for h, p in self._eps)})"
                ) from err
            time.sleep(next(delays, 1.0))

    def _sync_epoch_after_rehome(self, store, old_epoch):
        """Advance the promoted store's fence epoch past the lifetime we
        left. The bump is idempotent per transition: the first re-homing
        client claims ``__fence/promo/e<old>`` and applies the delta;
        later clients (same old epoch) wait briefly for it to land, then
        everyone pins the new value. A deposed writer still pinned to
        ``old_epoch`` is rejected by :meth:`_check_fence` from then on."""
        target = old_epoch + 1
        if int(store.add(ks.fence_promo(old_epoch), 1)) == 1:
            cur = int(store.add(ks.FENCE_EPOCH, 0))
            if cur < target:
                store.add(ks.FENCE_EPOCH, target - cur)
        deadline = time.monotonic() + 5.0
        while True:
            cur = int(store.add(ks.FENCE_EPOCH, 0))
            if cur >= target or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        self._epoch = max(cur, target)
        self._pinned = True

    def _fence_sweep(self, exclude):
        """Best-effort STONITH half of the fence: push the new epoch onto
        every OTHER candidate (including the deposed primary, once its
        partition heals) from a daemon thread, so a writer that never
        noticed the failover gets :class:`StoreFencedError` on its next
        mutating op instead of silently diverging a dead lifetime."""
        sweep_counter(self._eps, ks.FENCE_EPOCH, self._epoch,
                      probe_deadline=self._probe_deadline,
                      timeout=self._timeout, exclude=exclude,
                      name="store-fence-sweep")

    def adopt_epoch(self):
        """Pin this writer to the active store's CURRENT fence epoch.
        For a writer that never failed over but whose peers did (a
        shadow coordinator homed on its own standby from construction:
        the agents' re-home bumped the epoch, its own reads kept
        succeeding) — publishing under the stale construction-time pin
        would fence the writer out of the lifetime it now owns."""
        if not self._replicate:
            return self._epoch
        with self._lock:
            self._epoch = int(self._store.add(ks.FENCE_EPOCH, 0))
            self._pinned = True
            return self._epoch

    def rehome(self, err=None):
        """Deliberate re-home: a FENCED writer (an agent whose ops were
        rejected because the cluster moved to a new store lifetime while
        it kept writing to the old one) rejoins the CURRENT lifetime —
        rotate to a live candidate, adopt the current fence epoch (the
        promo transition is idempotent: an already-advanced epoch is
        adopted, not re-bumped) and fire ``on_failover`` so the owner
        re-registers its state. Coordinators must NOT call this — a
        deposed coordinator yields (exit 76); agents are interchangeable
        writers and re-homing them is the documented recovery."""
        with self._lock:
            self._failover_locked(err if err is not None
                                  else RuntimeError("explicit rehome"))

    def _reconnect_active_locked(self) -> bool:
        """One-shot wobble healer: before treating an op failure as a
        candidate loss, try a FRESH connection to the active candidate
        and prove it with a round-trip op. A healthy store whose cached
        client connection broke (socket reset, one slow op) re-serves on
        the new connection with NO promotion, NO incarnation bump and NO
        fence-epoch advance — a transient client-side wobble must never
        depose a live primary and fence every other writer."""
        host, port = self._eps[self._idx]
        try:
            store = TCPStore(host, port, is_master=False,
                             world_size=self._world_size,
                             timeout=self._timeout,
                             connect_deadline=self._probe_deadline,
                             fail_fast_refused=True)
            store.add(ks.FENCE_EPOCH, 0)  # round-trip proof
        except Exception:
            return False
        store._connect_deadline = self._probe_deadline
        self._store = store
        print(f"[store] reconnected to active {host}:{port} (transient "
              "op failure; no failover)", file=sys.stderr, flush=True)
        return True

    def _op(self, fn):
        with self._lock:
            last = None
            reconnect_left = 1
            for _ in range(len(self._eps) + 2):
                try:
                    return fn(self._store)
                except (StoreTimeoutError, StoreFencedError):
                    # answered-but-empty and deposed-writer are verdicts,
                    # not connectivity failures: rotating would either
                    # waste the consumed deadline or let a fenced writer
                    # sneak back in under a freshly pinned epoch
                    raise
                except (RuntimeError, ConnectionError, OSError) as e:
                    last = e
                    if reconnect_left and self._reconnect_active_locked():
                        reconnect_left = 0
                        continue
                    reconnect_left = 0
                    self._failover_locked(e)
            raise last

    # ---- replicated write-ahead log ------------------------------------
    def _wal_scoped(self, key) -> bool:
        """Only registry-scope keys ride the WAL: ``__``-internal keys
        (the WAL itself, fence, barriers) must never recurse into it."""
        return self._replicate and not key.startswith("__")

    def _check_fence(self, s):
        cur = int(s.add(ks.FENCE_EPOCH, 0))
        if not self._pinned:
            # the connect-time pin never landed (store was unreachable at
            # construction): adopt the CURRENT epoch on the first
            # mutating op — this writer never wrote under an older
            # lifetime, so there is nothing to fence it for
            self._epoch, self._pinned = cur, True
            return
        if cur > self._epoch:
            if self._fence_resolver is not None:
                # a writer whose AUTHORITY is fenced at a higher level
                # (the coordinator's lease term) may out-rank the store
                # epoch: the shadow that deposed a live primary sits on
                # its own standby when the agents re-home onto it and
                # bump the epoch — it never moved, still holds the term,
                # and must adopt the new epoch instead of deposing
                # ITSELF out of the lifetime it owns. The resolver is
                # consulted per event and must re-verify the authority
                # (term read), so a genuinely deposed coordinator still
                # raises.
                try:
                    keep = bool(self._fence_resolver())
                except Exception:
                    keep = False
                if keep:
                    print(f"[store] fence epoch moved {self._epoch} -> "
                          f"{cur} under writer {self._writer}, which "
                          "still holds its coordinator term: adopting "
                          "the new epoch", file=sys.stderr, flush=True)
                    self._epoch = cur
                    return
            from . import flight_recorder as _fr
            _fr.note_fenced("store_fenced", self._epoch, cur,
                            detail=f"writer {self._writer}")
            raise StoreFencedError(
                f"write rejected: store fence epoch moved "
                f"{self._epoch} -> {cur} (this writer was deposed by a "
                "failover it never saw)")

    # entries older than this are self-trimmed by the WRITER; larger
    # than the shipper's _TRIM_KEEP so a live shipper's own (cursor-
    # gated) trim always runs first and the writer only ever collects
    # what the shipper confirmed or what no shipper exists to want
    _WRITER_TRIM_KEEP = 4096

    def _wal_append(self, s, entry):
        entry["e"] = self._epoch
        seq = int(s.add(ks.WAL_SEQ, 1))
        s.set(ks.wal_entry(seq), json.dumps(entry).encode())
        self._wal_self_trim(s, seq)
        return seq

    def _wal_self_trim(self, s, seq):
        """Bound the WAL even when nothing consumes it. A LogShipper
        trims the primary's log as it ships, but two documented
        topologies have a WAL with NO consumer — the standby candidate
        lives on a host that runs no shipper (its bind failed here), and
        the post-takeover promoted store (the shadow stopped its
        shippers on adoption). Without a bound, every heartbeat `set`
        and `add` grows the active server's memory for the life of the
        job. The writer therefore GCs the entry ``_WRITER_TRIM_KEEP``
        ops behind its own append — gated on the shipper cursors
        (``__wal/cursor/<idx>``, refreshed every 64 appends) when any
        exist, so a live-but-lagging shipper is never gapped; with no
        cursor published there is no consumer and the trim is
        unconditional."""
        old = seq - self._WRITER_TRIM_KEEP
        if old <= 0:
            return
        if seq >= self._trim_floor_refresh_at:
            self._trim_floor_refresh_at = seq + 64
            floor = float("inf")
            try:
                for i in range(1, len(self._eps)):
                    k = ks.wal_cursor(i)
                    if s.check(k):
                        floor = min(floor, int(s.get(k, timeout=5)))
            except Exception:
                # a cursor we failed to READ may still exist — hold the
                # trim for this window (floor 0 = GC nothing) instead of
                # treating the hiccup as "no shipper" and gapping a
                # live-but-lagging standby
                floor = 0
            self._trim_floor = floor
        if old <= self._trim_floor:
            _trim_wal_entry(s, old)

    def set(self, key, value):
        if not self._wal_scoped(key):
            return self._op(lambda s: s.set(key, value))
        data = value if isinstance(value, bytes) else str(value).encode()

        def do(s):
            self._check_fence(s)
            self._wal_append(s, {
                "op": "set", "k": key,
                "v": base64.b64encode(data).decode()})
            s.set(key, data)

        return self._op(do)

    def get(self, key, timeout=None):
        return self._op(lambda s: s.get(key, timeout=timeout))

    def add(self, key, amount=1, _opid=None):
        # amount 0 is the idiomatic atomic READ of a counter key — no
        # mutation, so no WAL/fence round-trips on the poll hot path
        if amount == 0 or not self._wal_scoped(key):
            return self._op(lambda s: s.add(key, amount))
        opid = _opid or f"{self._writer}.{next(self._op_ids)}"

        def do(s):
            self._check_fence(s)
            if int(s.add(ks.wal_claim(opid), 1)) > 1:
                # this op was already claimed — an earlier attempt the
                # ack got lost for, or the shipper replayed it onto the
                # promoted standby: adopt the recorded result, never
                # apply twice (the exactly-once half of the fence)
                raw = None
                try:
                    raw = s.get(ks.wal_result(opid),
                                timeout=5).decode()
                except StoreTimeoutError:
                    pass
                if raw is None:
                    # claim orphaned BEFORE the pre-apply marker below:
                    # the increment definitely never ran (it comes after
                    # the marker) — safe to run the op from scratch. A
                    # duplicate WAL append for this opid is harmless:
                    # the shipper's claim dedupe applies it once.
                    print(f"[store] adopting orphaned claim {opid} "
                          f"for {key!r}: applying", file=sys.stderr,
                          flush=True)
                elif raw == "?":
                    # the earlier attempt died INSIDE the two-op window
                    # around the increment: whether it landed is
                    # unknowable from here, and both replaying and
                    # dropping would be a silent lie — surface a verdict
                    # (StoreTimeoutError is never retried by _op)
                    raise StoreTimeoutError(
                        f"outcome of replicated add {opid} on {key!r} "
                        "unknown: the first attempt died mid-apply")
                else:
                    return int(raw)
            self._wal_append(s, {"op": "add", "k": key,
                                 "n": int(amount), "id": opid})
            # pre-apply marker: shrinks the ambiguous retry window to
            # exactly the increment op — absent result = never applied,
            # "?" = unknown, value = applied
            s.set(ks.wal_result(opid), "?")
            v = int(s.add(key, amount))
            s.set(ks.wal_result(opid), str(v))
            return v

        return self._op(do)

    def check(self, key):
        return self._op(lambda s: s.check(key))

    def delete_key(self, key):
        if not self._wal_scoped(key):
            return self._op(lambda s: s.delete_key(key))

        def do(s):
            self._check_fence(s)
            self._wal_append(s, {"op": "del", "k": key})
            return s.delete_key(key)

        return self._op(do)

    def wait(self, keys, timeout=None):
        return self._op(lambda s: s.wait(keys, timeout=timeout))

    def barrier(self, name, world_size, timeout=None):
        return self._op(lambda s: s.barrier(name, world_size,
                                            timeout=timeout))


class LogShipper:
    """Tail the primary's write-ahead op log onto a standby candidate.

    Runs on the host that serves the standby store (the shadow
    coordinator in a real pod; the single coordinator in the
    single-machine pod simulation): every ``poll_s`` it reads the
    primary's ``__wal/seq`` head, applies each new entry to the standby
    (sets verbatim, adds through the claim protocol so the writer's own
    post-failover gap-fill can never double-apply), mirrors the entry
    into the standby's OWN WAL (cascading candidates keep working),
    advances the standby's ``__wal/acked`` cursor, and mirrors the
    primary's fence epoch. Replication lag (head - acked) is exported as
    the ``store_replication_lag`` gauge through the registry.

    Fencing on replay: an entry stamped with an epoch OLDER than the
    standby's current fence epoch is a deposed primary's late write — it
    is skipped and ring-marked (``wal_replay_fenced``) with the old
    epoch, never applied. The cooperative ``wal_torn@replication`` chaos
    kind tears exactly one application (truncated set payload / dropped
    add), proving the ``on_failover`` gap-filler heals an un-replicated
    tail.

    ``ship_once()`` is the synchronous pump (tests drive it
    deterministically); ``start()`` runs it on a daemon thread with
    backoff across primary outages until ``stop()``."""

    _TRIM_KEEP = 1024  # shipped entries older than this are GC'd off the
    #                    primary so a long run's WAL stays bounded
    _HOLE_GRACE_WINDOW = 64  # holes this close to the head get the
    #                          in-flight-append grace; older ones are
    #                          writer-trimmed entries, skipped instantly

    def __init__(self, primary, standby, poll_s=0.25, world_size=1,
                 timeout=120, standby_index=1, peer_indices=()):
        def _ep(x):
            host, _, port = str(x).rpartition(":")
            return host or "127.0.0.1", int(port)

        self._primary_ep = _ep(primary)
        self._standby_ep = _ep(standby)
        # multi-standby trim safety: each shipper publishes its acked
        # cursor on the primary (``__wal/cursor/<idx>``) and only trims
        # entries every KNOWN peer has also shipped — otherwise a fast
        # shipper would GC entries a slower standby still needs, turning
        # them into silent holes. Peers that never published a cursor are
        # ignored (their host's bind failed, no shipper exists there);
        # a peer that published once and then stalls holds the trim —
        # bounded WAL growth is the price of never gapping a candidate.
        self._standby_index = int(standby_index)
        self._peer_indices = [int(i) for i in peer_indices
                              if int(i) != int(standby_index)]
        self._poll_s = float(poll_s)
        self._world = int(world_size)
        self._timeout = timeout
        self._probe = float(os.environ.get(
            "PADDLE_TPU_STORE_PROBE_DEADLINE", "3"))
        self._prim = None
        self._stand = None
        self._stop = threading.Event()
        self._thread = None
        self.shipped_total = 0
        self.torn_total = 0

    def _client(self, attr, ep):
        c = getattr(self, attr)
        if c is None:
            host, port = ep
            c = TCPStore(host, port, is_master=False,
                         world_size=self._world, timeout=self._timeout,
                         connect_deadline=self._probe)
            setattr(self, attr, c)
        return c

    def _apply(self, stand, entry, torn):
        op = entry.get("op")
        epoch = int(entry.get("e", 0))
        cur = int(stand.add(ks.FENCE_EPOCH, 0))
        if epoch < cur:
            from . import flight_recorder as _fr
            _fr.note_fenced("wal_replay_fenced", epoch, cur,
                            detail=entry.get("k"))
            print(f"[store] shipper rejected WAL entry for "
                  f"{entry.get('k')!r}: epoch {epoch} < fence {cur} "
                  "(deposed primary's late write)", file=sys.stderr,
                  flush=True)
            return
        if op == "set":
            data = base64.b64decode(entry.get("v", ""))
            if torn:
                data = data[:len(data) // 2]
            stand.set(entry["k"], data)
        elif op == "add":
            if torn:
                return  # the ship is lost mid-air: the add never lands
            opid = entry.get("id")
            if int(stand.add(ks.wal_claim(opid), 1)) == 1:
                # same pre-apply "?" marker as FailoverStore.add: if THIS
                # process dies between the increment and the result
                # write, the writer's orphaned-claim recovery must see
                # "unknown", not "never applied" — absent-result =
                # safe-to-rerun is an invariant both appliers share
                stand.set(ks.wal_result(opid), "?")
                v = int(stand.add(entry["k"], int(entry.get("n", 1))))
                stand.set(ks.wal_result(opid), str(v))
            # else: the writer already gap-filled this op on the standby
        elif op == "del":
            stand.delete_key(entry["k"])
        # mirror into the standby's own WAL so a SECOND shipper (standby
        # -> tertiary) keeps a multi-candidate chain replicated — and
        # trim the mirror on the same window, or a multi-day job grows
        # the standby (the host that must stay healthy for failover)
        # without bound
        seq = int(stand.add(ks.WAL_SEQ, 1))
        stand.set(ks.wal_entry(seq), json.dumps(entry).encode())
        if seq > self._TRIM_KEEP:
            self._trim_entry(stand, seq - self._TRIM_KEEP)

    def _trim_entry(self, store, seq):
        _trim_wal_entry(store, seq)

    def ship_once(self) -> int:
        """Pump one replication round; returns entries processed. Raises
        when the primary is unreachable (the thread loop backs off; a
        dead primary means the standby is about to be promoted anyway)."""
        try:
            prim = self._client("_prim", self._primary_ep)
        except Exception:
            self._prim = None
            raise
        stand = self._client("_stand", self._standby_ep)
        try:
            # mirror the fence epoch first: late entries from a deposed
            # lifetime must find the fence already advanced
            pe = int(prim.add(ks.FENCE_EPOCH, 0))
            se = int(stand.add(ks.FENCE_EPOCH, 0))
            if se < pe:
                stand.add(ks.FENCE_EPOCH, pe - se)
            acked = int(stand.add(ks.WAL_ACKED, 0))
            head = int(prim.add(ks.WAL_SEQ, 0))
        except Exception:
            self._prim = None
            raise
        shipped = torn_n = 0
        peer_floor = None
        for seq in range(acked + 1, head + 1):
            key = ks.wal_entry(seq)
            try:
                if not prim.check(key):
                    if seq <= head - self._HOLE_GRACE_WINDOW:
                        # far behind the head: a writer-self-trimmed
                        # entry (a shipper started late against a
                        # long-running primary), not an in-flight
                        # append — skip WITHOUT the 1s grace, or a
                        # 100k-op catch-up stalls replication for
                        # hours while everyone believes it is on
                        acked = int(stand.add(ks.WAL_ACKED, 1))
                        continue
                    # seq bumped but entry not yet written (writer mid-
                    # append, or it died in that window): grace, then
                    # skip the hole — the cursor must keep moving. The
                    # grace covers any realistic stall between the
                    # writer's two append ops; a write landing even
                    # later is a real (if remote) replication hole, so
                    # it is ring-marked for post-mortems and healed by
                    # the on_failover gap-filler after a promotion.
                    for _ in range(5):
                        time.sleep(0.2)
                        if prim.check(key):
                            break
                    if not prim.check(key):
                        from . import flight_recorder as _fr
                        rec = _fr.get_recorder()
                        if rec is not None:
                            rec.complete(rec.issue(
                                "wal_hole_skipped", group="step",
                                extra={"wal_seq": seq}))
                        acked = int(stand.add(ks.WAL_ACKED, 1))
                        continue
                entry = json.loads(prim.get(key, timeout=5))
            except (ValueError, StoreTimeoutError):
                acked = int(stand.add(ks.WAL_ACKED, 1))
                continue  # torn/corrupt source entry: skip, never stall
            torn = _fault.maybe_inject("replication") == "wal_torn"
            self._apply(stand, entry, torn)
            acked = int(stand.add(ks.WAL_ACKED, 1))
            shipped += 1
            torn_n += int(torn)
            if peer_floor is None:  # once per round: cursors only move
                peer_floor = self._peer_trim_floor(prim)  # between rounds
            if seq > self._TRIM_KEEP \
                    and seq - self._TRIM_KEEP <= min(acked, peer_floor):
                self._trim_entry(prim, seq - self._TRIM_KEEP)
        if shipped:
            try:
                prim.set(ks.wal_cursor(self._standby_index),
                         str(acked))
            except Exception:
                pass  # cursor is advisory; primary may be dying
        self.shipped_total += shipped
        self.torn_total += torn_n
        from ..observability import metrics as _obs
        _obs.observe_replication(head, acked, shipped=shipped,
                                 torn=torn_n)
        return shipped

    def _peer_trim_floor(self, prim) -> float:
        """Lowest acked cursor among the KNOWN peer shippers: entries at
        or below ``min(floor, own acked) - _TRIM_KEEP`` are safe to GC.
        With no peers (the common single-standby pair) the floor is
        unbounded and our own cursor alone governs the trim."""
        floor = float("inf")
        for i in self._peer_indices:
            try:
                key = ks.wal_cursor(i)
                if prim.check(key):
                    floor = min(floor, int(prim.get(key, timeout=5)))
            except Exception:
                # an unreadable cursor may still exist: hold the TRIM
                # (floor 0) for this round rather than gapping the peer
                # — shipping itself is unaffected, only the GC waits
                floor = 0
        return floor

    def _loop(self):
        delays = _fault.Backoff(base=0.2, cap=2.0).delays()
        while not self._stop.is_set():
            try:
                self.ship_once()
                delays = _fault.Backoff(base=0.2, cap=2.0).delays()
                self._stop.wait(self._poll_s)
            except Exception:
                # primary down (mid-failover or gone): back off; if it
                # never returns the standby gets promoted and this
                # shipper is stopped by its owner
                self._stop.wait(next(delays, 2.0))

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="store-log-shipper")
        self._thread.start()

    def stop(self, timeout=5.0):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)


class Watchdog:
    """Collective watchdog (reference: CommTaskManager,
    comm_task_manager.cc:153): trip if no heartbeat within timeout."""

    def __init__(self, timeout_seconds=1800.0, abort_on_trip=False):
        """abort_on_trip: on timeout the native thread kills the process
        (_exit(17)) — a hung collective blocks the controller thread, so
        in-process recovery is impossible; the launcher restart loop +
        checkpoint resume is the recovery path (reference:
        comm_task_manager.cc:153 abort semantics)."""
        self._lib = _load_lib()
        self._h = self._lib.pd_watchdog_start2(
            int(timeout_seconds * 1000), 1 if abort_on_trip else 0)

    def beat(self):
        self._lib.pd_watchdog_beat(self._h)

    @property
    def tripped(self) -> bool:
        return bool(self._lib.pd_watchdog_tripped(self._h))

    def stop(self):
        if self._h:
            self._lib.pd_watchdog_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
