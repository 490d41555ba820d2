"""Panel exchange — the dlinalg communication substrate.

Panels move through a small publish/fetch surface instead of eager
collectives on purpose: a collective participated in by a rank that
takes a SIGKILL mid-exchange deadlocks or poisons every peer, while a
store-keyed panel is immutable once published — survivors keep
fetching, a relaunched world re-publishes identical bytes under a new
incarnation scope, and a promoted standby store still holds the
in-flight panels because ``dlinalg/...`` keys are registry scope
(WAL-replicated, see ``distributed/keyspace.py``).

Two implementations share the surface:

* :class:`LocalExchange` — in-process, thread-safe; world 1 and the
  fast-tier simulated-SPMD tests (each rank on a thread).
* :class:`StoreExchange` — TCPStore/FailoverStore backed; every key is
  built from the ``dlinalg_*`` keyspace functions through the ``_k``
  funnel (SK rules).

Both honor an optional ``poll`` callable invoked while a fetch waits —
the sweep solver points it at the preemption flag so a SIGTERM'd rank
blocked on a dead peer's panel still drains to exit 75 inside the
launcher's kill grace.
"""
from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["ExchangeTimeout", "LocalExchange", "StoreExchange"]


class ExchangeTimeout(TimeoutError):
    pass


def _pack(arr) -> bytes:
    arr = np.ascontiguousarray(arr)
    head = f"{arr.dtype.str}|{','.join(str(d) for d in arr.shape)}|"
    return head.encode() + arr.tobytes()


def _unpack(raw: bytes):
    i1 = raw.index(b"|")
    i2 = raw.index(b"|", i1 + 1)
    dtype = np.dtype(raw[:i1].decode())
    shape = tuple(int(x) for x in raw[i1 + 1:i2].decode().split(",") if x)
    return np.frombuffer(raw[i2 + 1:], dtype=dtype).reshape(shape).copy()


class _ExchangeBase:
    """Gather/reduce built on publish/fetch. Summation is in RANK ORDER
    so every participant reduces to bit-identical f64 — the solver's
    bit-identical-resume contract rests on this determinism."""

    poll = None  # optional callable; may raise to abort a blocked wait

    def gather(self, tag, rank, world, arr, timeout=120.0):
        self.publish(f"{tag}/g{rank}", arr)
        return [self.fetch(f"{tag}/g{r}", timeout=timeout)
                for r in range(world)]

    def reduce_sum(self, tag, rank, world, arr, timeout=120.0):
        parts = self.gather(tag, rank, world, arr, timeout=timeout)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def _poll(self):
        if self.poll is not None:
            self.poll()


class LocalExchange(_ExchangeBase):
    """In-process exchange: one shared instance, any number of simulated
    ranks (threads). ``fetch`` blocks on a condition variable until the
    key is published."""

    def __init__(self, poll=None):
        self.poll = poll
        self._cond = threading.Condition()
        self._data = {}

    def publish(self, key, arr):
        val = np.array(arr, copy=True)
        with self._cond:
            self._data[key] = val
            self._cond.notify_all()

    def fetch(self, key, timeout=120.0):
        deadline = time.monotonic() + timeout
        with self._cond:
            while key not in self._data:
                self._poll()
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ExchangeTimeout(f"panel {key!r} never published")
                self._cond.wait(min(0.05, left))
            return self._data[key].copy()

    def barrier(self, name, world, timeout=120.0):
        k = ("bar", name)
        with self._cond:
            self._data[k] = self._data.get(k, 0) + 1
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._data.get(k, 0) < world:
                self._poll()
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ExchangeTimeout(f"barrier {name!r} incomplete")
                self._cond.wait(min(0.05, left))


class StoreExchange(_ExchangeBase):
    """TCPStore/FailoverStore-backed exchange. Panel payloads live under
    ``keyspace.dlinalg_panels(job)``, synchronisation under
    ``keyspace.dlinalg_solver(job)`` — callers scope tags by
    incarnation/sweep so an elastic relaunch never meets a stale key.

    Fetches wait in short store slices (``chunk_timeout``) so the
    ``poll`` hook runs even while the store blocks on an absent key.
    """

    def __init__(self, store, job, poll=None, chunk_timeout=2.0):
        from .. import keyspace
        self._store = store
        self._panels = keyspace.dlinalg_panels(job)
        self._solver = keyspace.dlinalg_solver(job)
        self.poll = poll
        self._chunk = float(chunk_timeout)

    def _k(self, leaf):
        return f"{self._panels}/{leaf}"

    def _sk(self, leaf):
        return f"{self._solver}/{leaf}"

    def publish(self, key, arr):
        self._store.set(self._k(key), _pack(arr))

    def fetch(self, key, timeout=120.0):
        from ..tcp_store import StoreTimeoutError
        k = self._k(key)
        deadline = time.monotonic() + timeout
        while True:
            self._poll()
            left = deadline - time.monotonic()
            if left <= 0:
                raise ExchangeTimeout(f"panel {key!r} never published")
            try:
                self._store.wait([k], timeout=min(self._chunk, left))
                break
            except StoreTimeoutError:
                continue
        return _unpack(self._store.get(k))

    def barrier(self, name, world, timeout=120.0):
        self._store.barrier(self._sk(f"bar/{name}"), world, timeout=timeout)
