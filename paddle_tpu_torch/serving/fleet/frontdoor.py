"""The durable front door — a replicated serving router over the store.

The port of ``paddle_tpu/serving/fleet/frontdoor.py`` (host Python).
:class:`~.router.FleetRouter` holds the exactly-once machinery (ledger
journaling, lease fencing, takeover adoption); this module packages it as
a primary/shadow PROCESS pair, as ``launch/main.py`` packages the
coordinator:

* :class:`RouterClient` — the client side of the front-door protocol.
  Submissions ride an ``in_seq`` counter + ``in/<n>`` records under
  :func:`~paddle_tpu_torch.distributed.keyspace.fleet_router` (the
  counter-log idiom of the store-RPC engine protocol); results come back
  through the LEDGER, not a private reply key — the journal is the one
  source of truth, so a client survives a router swap without noticing:
  it polls ``req/<rid>``, surfaces the cursor's new tokens, and
  resubmits the SAME rid if the record goes quiet (a duplicate
  submission attaches, replays, or dedupes; it never generates twice).
* :func:`serve_router` — the routing loop: tail the submission log,
  dispatch through the router (ledger-journaled), beat the lease, run
  the hedge/ledger sweep. Carries the ``route`` chaos site:
  ``router_die`` SIGKILLs the process mid-dispatch (the shadow adopts),
  ``router_stall`` freezes the loop while the process lives (the lease
  goes stale, the shadow adopts, and the stalled primary's next beat
  hits the term fence).
* :func:`main` — CLI. ``--role primary`` acquires the lease and serves;
  ``--role shadow`` watches the lease's staleness on ITS OWN monotonic
  clock, then adopts: term bump (fences the deposed primary), fresh
  engine handles (their pollers replay the store-RPC history from seq
  0), ledger adoption (re-attach live legs off the persisted cursors,
  re-dispatch orphans), and only then starts routing. A deposed router
  exits ``EXIT_DEPOSED`` (76), as a deposed coordinator does.

Router process::

    python -m paddle_tpu_torch.serving.fleet.frontdoor \
        --store 127.0.0.1:6200 --job fleet --role primary \
        [--engines e0,e1] [--ttl 1.0]

It builds no model and touches no device: the engines are
:mod:`.remote` processes.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from collections import deque

from ...distributed import fault as _fault
from ...distributed import keyspace
from ...observability import tracing as _trc
from .ledger import (RequestLedger, RouterDeposedError, RouterLease,
                     TERMINAL_STATES, rebuild_error)
from .router import FleetRouter, FleetSaturated

__all__ = ["RouterClient", "serve_router", "main"]


class RouterClient:
    """Submit requests to whichever router holds the lease, and read
    results straight off the durable ledger.

    The client never learns which process routed it: submissions append
    to the shared wire log, results come from the journal. ``rid`` is
    the client's exactly-once key — pick it once per logical request
    and retry freely."""

    def __init__(self, store, job="fleet", poll_s=0.03,
                 resubmit_after=2.0):
        self.store = store
        self.job = str(job)
        self.poll_s = float(poll_s)
        # resubmit the rid after this long with NO record change: long
        # enough to ride out a takeover, short enough that a request
        # lost with a dead router's in-memory retry queue still lands
        self.resubmit_after = float(resubmit_after)
        self._prefix = keyspace.fleet_router(self.job)
        self._ledger_prefix = keyspace.fleet_ledger(self.job)
        self._lock = threading.Lock()
        self._sent = {}          # rid -> wire msg (for resubmission)

    def submit(self, rid, prompt_ids, max_new_tokens=16,
               eos_token_id=None, temperature=0.0, top_k=None,
               engine=None):
        """Enqueue one request under the client-chosen ``rid``.
        Calling this twice with the same rid is safe by design.
        ``engine=`` pins the request to one engine id (tests and warm
        paths); the trace context is minted HERE — the true front of
        the waterfall — and rides the wire msg so router/engine spans
        land under the same trace id."""
        trace = _trc.mint_context()   # None when tracing is off
        t0 = time.time() if trace is not None else 0.0
        msg = {"rid": str(rid), "prompt": [int(t) for t in prompt_ids],
               "max_new_tokens": int(max_new_tokens),
               "eos_token_id": eos_token_id,
               "temperature": temperature, "top_k": top_k}
        if engine is not None:
            msg["engine"] = str(engine)
        if trace is not None:
            msg["trace"] = trace
        with self._lock:
            self._sent[str(rid)] = msg
        self._enqueue(msg)
        if trace is not None:
            _trc.req_event(trace, "client_submit", t0,
                           time.time() - t0,
                           args={"rid": str(rid),
                                 "prompt_tokens": len(msg["prompt"])})
        return str(rid)

    def _enqueue(self, msg):
        seq = int(self.store.add(f"{self._prefix}/in_seq", 1))
        self.store.set(f"{self._prefix}/in/{seq}", json.dumps(msg))

    def result(self, rid, timeout=60.0, on_token=None):
        """Block until ``rid`` reaches a terminal record; surface each
        cursor advance through ``on_token(token, fin)`` as it lands.
        Returns the full token list, or raises the recorded typed
        error. Resubmits the same rid whenever the record goes quiet —
        across a router failover this is what re-engages the new
        primary for a request the old one never journaled."""
        rid = str(rid)
        key = f"{self._ledger_prefix}/req/{rid}"
        deadline = time.monotonic() + float(timeout)
        surfaced = 0
        last_change = time.monotonic()
        last_raw = None
        while True:
            raw = None
            try:
                if self.store.check(key):
                    raw = self.store.get(key, timeout=10)
            except Exception:
                raw = None
            if raw is not None and raw != last_raw:
                last_raw = raw
                last_change = time.monotonic()
                rec = json.loads(raw)
                toks = rec.get("tokens") or []
                term = rec.get("state") in TERMINAL_STATES
                err = rec.get("error")
                if on_token is not None:
                    for i in range(surfaced, len(toks)):
                        try:
                            on_token(int(toks[i]),
                                     term and err is None
                                     and i == len(toks) - 1)
                        except Exception:
                            pass
                surfaced = max(surfaced, len(toks))
                if term:
                    e = rebuild_error(err)
                    if e is not None:
                        raise e
                    return [int(t) for t in toks]
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(
                    f"request {rid!r} not terminal after {timeout}s")
            if now - last_change > self.resubmit_after:
                last_change = now
                with self._lock:
                    msg = self._sent.get(rid)
                if msg is not None:
                    try:
                        self._enqueue(msg)
                    except Exception:
                        pass
            time.sleep(self.poll_s)

    def generate(self, rid, prompt_ids, timeout=60.0, on_token=None,
                 **kw):
        """``submit`` + ``result`` in one call."""
        self.submit(rid, prompt_ids, **kw)
        return self.result(rid, timeout=timeout, on_token=on_token)


def serve_router(router, store, job="fleet", poll_s=0.03,
                 idle_timeout=None):
    """Route until the ``stop`` key appears (or ``idle_timeout`` passes
    with no traffic). Raises :class:`RouterDeposedError` the moment the
    lease term moves — the caller maps it to ``EXIT_DEPOSED``.

    The ``route`` chaos site fires once per DISPATCHED request (not per
    poll tick), so ``router_die@route:N`` deterministically kills the
    Nth routed request mid-burst."""
    prefix = keyspace.fleet_router(job)
    fleet_stop = f"{keyspace.fleet_registry(job)}/stop"
    consumed = 0
    retry = deque()              # saturated submissions await capacity
    tick = 0
    last_traffic = time.monotonic()
    last_sweep = 0.0
    while True:
        tick += 1
        if tick % 5 == 1 and (store.check(f"{prefix}/stop")
                              or store.check(fleet_stop)):
            return
        if idle_timeout is not None \
                and time.monotonic() - last_traffic > idle_timeout:
            return
        # the lease beat is the fence: a deposed router finds out here
        # (or inside submit's own _check_lease) and must stop routing
        if router.lease is not None:
            try:
                router.lease.beat()
            except RouterDeposedError:
                router.fence()
                raise
        head = int(store.add(f"{prefix}/in_seq", 0))
        while consumed < head:
            consumed += 1
            try:
                msg = json.loads(store.get(f"{prefix}/in/{consumed}",
                                           timeout=10))
            except Exception:
                continue  # torn submission: the client resubmits
            last_traffic = time.monotonic()
            retry.append(msg)
        for _ in range(len(retry)):
            msg = retry.popleft()
            k = _fault.maybe_inject("route")
            if k == "router_die":
                print(f"ROUTER_DIE {time.time():.6f}", flush=True)
                print("[fleet] injected router_die: SIGKILL self (the "
                      "shadow router adopts the ledger)",
                      file=sys.stderr, flush=True)
                sys.stdout.flush()
                sys.stderr.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            try:
                router.submit(msg["prompt"],
                              max_new_tokens=int(
                                  msg.get("max_new_tokens", 16)),
                              eos_token_id=msg.get("eos_token_id"),
                              temperature=float(
                                  msg.get("temperature", 0.0)),
                              top_k=msg.get("top_k"), block=False,
                              request_id=msg.get("rid"),
                              engine=msg.get("engine"),
                              trace=msg.get("trace"))
            except FleetSaturated:
                retry.append(msg)   # every queue full: retry next tick
            except RouterDeposedError:
                raise
            except Exception:
                continue            # malformed submission: drop it
        now = time.monotonic()
        if now - last_sweep > 0.25:
            last_sweep = now
            try:
                # hedges + the ledger's batched cursor writes
                router.hedge_sweep()
            except Exception:
                pass
        time.sleep(poll_s)


def _build_handles(router, store_factory, registry, job, engine_ids):
    """Fresh RemoteEngineHandles for the given (or discovered) engine
    ids. Built at SERVE time on purpose: a fresh handle's poller
    replays the store-RPC stream/out history from seq 0, which is what
    re-attachment after a takeover feeds on.

    Handles are built with ``defer_poll=True``: the caller starts the
    pollers (``start_polling``) only AFTER ledger adoption has attached
    every inherited rid — a poller racing the attach would consume the
    early history records while their rid is still unknown and drop
    those tokens."""
    from .remote import RemoteEngineHandle
    recs = registry.engines(live_only=True)
    ids = engine_ids or sorted(recs)
    for eid in ids:
        role = (recs.get(eid) or {}).get("role", "any")
        router.add_engine(None, handle=RemoteEngineHandle(
            store_factory, eid, job=job, registry=registry, role=role,
            defer_poll=True))
    return ids


def main(argv=None):
    """Front-door process entry (primary or shadow)."""
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.fleet.frontdoor")
    p.add_argument("--store", required=True, help="host:port")
    p.add_argument("--job", default="fleet")
    p.add_argument("--role", default="primary",
                   choices=["primary", "shadow"])
    p.add_argument("--engines", default="",
                   help="comma-separated engine ids "
                        "(default: discover live engines)")
    p.add_argument("--ttl", type=float, default=2.0,
                   help="router lease ttl (beat at ttl/3)")
    p.add_argument("--grace", type=float, default=None,
                   help="shadow adopts after the lease is stale this "
                        "long (default 3*ttl)")
    p.add_argument("--hedge-after", type=float, default=None)
    p.add_argument("--poll", type=float, default=0.03)
    p.add_argument("--idle-timeout", type=float, default=300.0)
    args = p.parse_args(argv)

    from ...distributed.tcp_store import TCPStore
    from .registry import EngineRegistry

    host, _, port = args.store.rpartition(":")
    host, port = host or "127.0.0.1", int(port)

    def store_factory():
        return TCPStore(host, port, is_master=False)

    store = store_factory()
    registry = EngineRegistry(store_factory(), job=args.job)
    ledger = RequestLedger(store_factory(), job=args.job)
    lease = RouterLease(store_factory(), job=args.job, ttl=args.ttl,
                        router_id=f"{args.role}-{os.getpid()}")
    router = FleetRouter(hedge_after_s=args.hedge_after, ledger=ledger,
                         lease=lease)
    engine_ids = [e for e in args.engines.split(",") if e]
    prefix = keyspace.fleet_router(args.job)
    fleet_stop = f"{keyspace.fleet_registry(args.job)}/stop"

    if args.role == "shadow":
        grace = args.grace if args.grace is not None else 3 * args.ttl
        print(f"[fleet] shadow router watching (job={args.job}, "
              f"grace={grace:.2f}s)", flush=True)
        while True:
            if store.check(f"{prefix}/stop") or store.check(fleet_stop):
                print("[fleet] shadow router stopped (never adopted)",
                      flush=True)
                return 0
            age = lease.stale_age()
            if age is not None and age > grace:
                break
            time.sleep(max(args.ttl / 3.0, 0.05))
        t0 = time.monotonic()
        term = lease.adopt()
        _build_handles(router, store_factory, registry, args.job,
                       engine_ids)
        adopted = router.adopt_from_ledger()
        # pollers start only now: every adopted rid is registered, so
        # the history replay surfaces each request's full tail exactly
        # once (see _build_handles)
        for h in router.handles().values():
            h.start_polling()
        adopt_s = time.monotonic() - t0
        router.metrics.on_router_failover(adopt_s)
        print(f"ROUTER_ADOPTED term={term} adopt_s={adopt_s:.3f} "
              f"adopted={adopted} replayed={router.requests_replayed} "
              f"wall={time.time():.6f}", flush=True)
    else:
        term = lease.acquire()
        _build_handles(router, store_factory, registry, args.job,
                       engine_ids)
        for h in router.handles().values():
            h.start_polling()   # nothing to adopt: start immediately
        print(f"ROUTER_PRIMARY term={term} wall={time.time():.6f}",
              flush=True)

    try:
        serve_router(router, store, job=args.job, poll_s=args.poll,
                     idle_timeout=args.idle_timeout)
    except RouterDeposedError as e:
        print(f"ROUTER_DEPOSED term={lease.term} wall={time.time():.6f}",
              flush=True)
        print(f"[fleet] router deposed: {e} "
              f"({_fault.describe_exit(_fault.EXIT_DEPOSED)})",
              file=sys.stderr, flush=True)
        return _fault.EXIT_DEPOSED
    finally:
        # detach, never close: closing a RemoteEngineHandle stops its
        # ENGINE, and this router exiting (deposed or stopped) must not
        # take the fleet down with it
        for h in router.handles().values():
            try:
                h.detach()
            except Exception:
                pass
    print(f"[fleet] router stopped (term={lease.term})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
