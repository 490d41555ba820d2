"""Fleet router — one serving front end over N ``ServingEngine`` replicas.

The port of ``paddle_tpu/serving/fleet/router.py`` (host Python). Callers
talk to ONE :class:`FleetRouter`; behind it N engines (in-process
replicas, or store-RPC remotes through :mod:`.remote`) share the load:

* **session affinity** — requests whose prompt opens with the same full
  first page (or an explicit ``session=`` key) stick to the engine that
  already holds those pages, so the prefix cache hits locally instead of
  paying a cross-engine import per request;
* **least-loaded balancing** — candidates are ordered by queue depth +
  active slots, KV occupancy breaking ties;
* **backpressure propagation** — an engine's ``QueueFull`` rotates to
  the next candidate; when EVERY engine is saturated the caller gets
  :class:`FleetSaturated` (a ``QueueFull``) after the submit timeout;
* **health + re-dispatch** — an engine that crashes (serve-loop error),
  closes, or begins a graceful shutdown is drained from rotation; its
  failed legs re-dispatch to healthy engines carrying the tokens already
  emitted (the continuation re-prefills ``prompt + generated``, so
  greedy decode is token-identical);
* **hedged stragglers** — with ``hedge_after_s`` set, ``hedge_sweep()``
  duplicates a quiet request's leg on a second engine; the first
  finisher wins, the loser is ABORTED — slot and pages freed silently,
  its waiters never fired — and the duplicate's tokens surface only on
  promotion, never interleaved;
* **prefetch on affinity spill** — when a sticky session lands on a NEW
  engine (its affine replica was too deep), the router pushes the
  prompt's shared prefix pages there ahead of the prefill through the
  page-share transport (:meth:`~..engine.ServingEngine.prefetch_prefix`,
  on a thread of its own), turning the spill's cold miss into a remote
  hit;
* **prefill/decode disaggregation** — engines registered with
  ``role="prefill"`` hand completed prefills to ``role="decode"``
  engines through :func:`.disagg.migrate_request` (KV page migration;
  the machinery ``remove_engine(migrate=True)`` uses for planned engine
  loss);
* **the durable front door** — with a :class:`~.ledger.RequestLedger`
  every request's lifecycle is journaled (client request ids are
  exactly-once keys) and a :class:`~.ledger.RouterLease` fences this
  router against a shadow's takeover (:meth:`FleetRouter.
  adopt_from_ledger`).

Liveness can also ride the store registry
(:class:`.registry.EngineRegistry`): handles built from registry records
(remote engines) report health from heartbeats.
"""
from __future__ import annotations

import itertools
import threading
import time

from ...observability import tracing as _trc
from ..metrics import ServingMetrics
from ..scheduler import (EngineClosed, EngineShuttingDown,
                         GenerationRequest, QueueFull)
from . import disagg as _disagg
from .ledger import TERMINAL_STATES, RouterDeposedError, rebuild_error

__all__ = ["FleetRouter", "FleetRequest", "FleetSaturated",
           "LocalEngineHandle"]


class FleetSaturated(QueueFull):
    """Every healthy engine's admission queue is full — fleet-wide
    backpressure. Retryable by the caller (it is a ``QueueFull``)."""


_fid = itertools.count()


class FleetRequest:
    """The caller's handle to one fleet-routed generation.

    Mirrors :class:`~..scheduler.GenerationRequest`'s caller surface
    (``result``/``done``/``ttft_s``/``inter_token_s`` plus the fields
    ``load.summarize_requests`` reads), while the engine-side legs behind
    it may be re-dispatched across engines or migrated between them —
    ``engine_ids`` records the itinerary.
    """

    def __init__(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                 temperature=0.0, top_k=None, on_token=None,
                 request_id=None, trace=None):
        # client-supplied ids are the exactly-once idempotency key: the
        # same id resubmitted reaches the same request through the
        # ledger, never a second generation
        self.request_id = str(request_id) if request_id is not None \
            else f"fleet-{next(_fid)}"
        # distributed trace context: minted at the front door
        # (or by the router when it IS the front door), journaled with
        # the ledger record, copied onto every engine leg. None when
        # tracing is off — the hot-path hooks gate on this attribute.
        self.trace = trace
        self._hedged = False       # ever hedged (tail-sampling verdict)
        self.prompt_ids = [int(t) for t in prompt_ids]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = top_k
        self.on_token = on_token
        self.generated: list = []
        self.token_times: list = []
        self.state = "waiting"
        self.error = None
        self.engine_id = None
        self.engine_ids: list = []       # every engine this request rode
        self.redispatches = 0
        self.migrations = 0
        self.queue_wait_s = 0.0
        self.evictions = 0
        self.t_submit = time.perf_counter()
        self.t_first_token = None
        self.t_done = None
        self._done = threading.Event()
        self._leg = None
        self._hedge = None         # duplicate leg racing a straggler
        # serializes token surfacing against hedge promotion: the splice
        # in _promote_hedge must not interleave with a primary leg's
        # concurrent _leg_token append; the in-flight migration target
        # and the ledger cursor are claimed under it too.
        self._tok_lock = threading.Lock()
        self._migrating_to = None  # dst engine of an in-flight migration
        self._ledger_cursor = 0    # tokens already journaled
        self._ledger_done = False  # terminal record written

    # ---- engine-leg plumbing (router-internal) -------------------------
    def _attach(self, leg, engine_id):
        self._leg = leg
        self.engine_id = engine_id
        if not self.engine_ids or self.engine_ids[-1] != engine_id:
            self.engine_ids.append(engine_id)
        self.state = "active"

    def _leg_token(self, leg, token, fin):
        with self._tok_lock:
            # only the PRIMARY leg surfaces tokens live — a hedge
            # duplicate's tokens accumulate engine-side and surface in
            # one splice if it wins (surfacing both would interleave two
            # token streams into one callback sequence)
            if leg is not self._leg:
                return
            now = time.perf_counter()
            if self.t_first_token is None:
                self.t_first_token = now
            self.token_times.append(now)
            self.generated.append(int(token))
            n = len(self.generated)
        if self.trace is not None:
            # per-token stream delivery: the instant this token surfaced
            # to the caller's stream in the router process
            _trc.req_event(self.trace, "stream_token", time.time(), 0.0,
                           args={"i": n, "fin": bool(fin)})
        cb = self.on_token
        if cb is not None:
            try:
                cb(self, int(token), bool(fin))
            except Exception:
                pass

    def _absorb(self, leg):
        """Fold a finished/abandoned leg's accounting into the fleet
        totals (tokens already arrived through ``_leg_token``)."""
        self.queue_wait_s += leg.queue_wait_s
        self.evictions += leg.evictions

    def _finish(self, error=None):
        if self._done.is_set():
            return
        self.state = "failed" if error is not None else "finished"
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()

    # ---- caller surface -------------------------------------------------
    def done(self):
        return self._done.is_set()

    def result(self, timeout=60.0):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done in {timeout}s "
                f"(state={self.state}, engine={self.engine_id})")
        if self.error is not None:
            raise self.error
        return list(self.generated)

    def ttft_s(self):
        return (self.t_first_token - self.t_submit) \
            if self.t_first_token else None

    def inter_token_s(self):
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]


class LocalEngineHandle:
    """Router-side view of one in-process :class:`ServingEngine`."""

    remote = False

    def find_leg(self, rid):
        """Locate a live engine-side request by its id (router shadow
        takeover re-attach; local legs carry int GenerationRequest
        ids). None when the leg already finished or never arrived."""
        s = self.engine.scheduler
        for req in list(s.active.values()) + list(s.waiting):
            if str(req.request_id) == str(rid):
                return req
        return None

    def __init__(self, engine, engine_id, role="any"):
        self.engine = engine
        self.engine_id = str(engine_id)
        self.role = role
        self.forced_down = False
        # router-side in-flight count: incremented at dispatch,
        # decremented at leg completion/migration. Engine-reported
        # loads lag (remote heartbeats especially) — during a burst the
        # router's own unacknowledged traffic is the freshest signal.
        self.pending = 0

    def healthy(self):
        e = self.engine
        return not (self.forced_down or e._closed or e._draining
                    or e._loop_error is not None)

    def load(self):
        s = self.engine.scheduler
        return s.queue_depth() + len(s.active)

    def occupancy(self):
        return self.engine.kv.occupancy_pct()

    def submit(self, leg):
        """Non-blocking admission (the router owns retry-elsewhere)."""
        leg._handle_id = self.engine_id
        return self.engine.submit_request(leg, block=False)

    def abort(self, leg):
        """Silently cancel one leg (hedge loser). True when the leg was
        actually cancelled — its ``on_done`` will never fire."""
        return self.engine.abort_request(leg)

    def start(self):
        self.engine.start()

    def close(self):
        self.engine.close()


class FleetRouter:
    """Dispatch over engine handles with affinity, balancing, health."""

    # sticky-session map cap: beyond this the oldest entries age out
    # (LRU — refreshing a session moves it to the tail), so a stream of
    # unique prompts can't grow the dispatch tier without bound
    MAX_AFFINITY = 4096

    def __init__(self, max_redispatch=3, registry=None,
                 affinity_spill=4, hedge_after_s=None, ledger=None,
                 lease=None):
        self._handles = {}
        self._affinity = {}        # head key -> engine_id (LRU order)
        self._lock = threading.Lock()
        self.max_redispatch = int(max_redispatch)
        # affinity yields when the affine engine is this many requests
        # MORE loaded than the lightest candidate: a hot session must
        # spill to a second engine (where cross-engine prefix sharing
        # picks up the head) instead of dogpiling one replica
        self.affinity_spill = int(affinity_spill)
        # a request quiet (no token) for this long is a straggler:
        # hedge_sweep() duplicates its leg on a second engine. None
        # disables hedging (the sweep still prunes finished requests).
        self.hedge_after_s = None if hedge_after_s is None \
            else float(hedge_after_s)
        self.registry = registry
        # durable front door: the ledger journals every
        # request lifecycle through the replicated store; the lease
        # fences this router against a shadow takeover. Both optional —
        # a ledger-less router keeps its state in this process only.
        self._ledger = ledger
        self.lease = lease
        self._fenced = False
        self.page_size = None
        self.cfg = None            # first engine's model config (loadgen)
        self._inflight = {}        # request_id -> FleetRequest (live)
        # prefetch runs on a side thread by default so the dispatch path
        # never waits on a store round-trip; tests flip it synchronous
        self._prefetch_async = True
        # fleet-level counters (stats())
        self.dispatched = 0
        self.redispatched = 0
        self.migrations = 0
        self.saturated = 0
        self.affinity_hits = 0
        self.hedges_fired = 0
        self.hedges_won = 0
        self.aborts = 0
        self.prefetch_pages = 0
        self.requests_replayed = 0   # terminal ids answered off the journal
        self.requests_attached = 0   # in-flight ids attached to live legs
        self.requests_adopted = 0    # takeover adoptions from the ledger
        # unlabeled fleet-level frontend: hedge/abort counters belong to
        # the DISPATCH tier, not to any one engine's labeled families
        self.metrics = ServingMetrics(prefix_enabled=False)

    # ------------------------------------------------------------ roster
    def add_engine(self, engine, engine_id=None, role="any", handle=None):
        """Register one engine replica. ``role``: "any" (prefill AND
        decode), "prefill" or "decode" (disaggregated fleets). Pass a
        prebuilt ``handle`` for remote engines."""
        if handle is None:
            engine_id = engine_id if engine_id is not None \
                else (engine.engine_id or f"e{len(self._handles)}")
            handle = LocalEngineHandle(engine, engine_id, role=role)
        with self._lock:
            if handle.engine_id in self._handles:
                raise ValueError(
                    f"engine id {handle.engine_id!r} already registered")
            self._handles[handle.engine_id] = handle
        eng = getattr(handle, "engine", None)
        if eng is not None:
            if self.page_size is None:
                self.page_size = eng.page_size
            if self.cfg is None:
                self.cfg = eng.cfg
        elif self.page_size is None:
            self.page_size = getattr(handle, "page_size", None)
            self.cfg = getattr(handle, "cfg", None)
        if self.registry is not None and eng is not None:
            self.registry.register(handle.engine_id, engine=eng,
                                   role=role)
        return handle

    def handles(self):
        with self._lock:
            return dict(self._handles)

    def engine(self, engine_id):
        return self._handles[engine_id].engine

    # --------------------------------------------------------- selection
    def _head_key(self, prompt, session=None):
        if session is not None:
            return ("s", session)
        ps = self.page_size or 0
        if ps and len(prompt) > ps:
            # only a FULL first page can ever be prefix-shared (the
            # cache indexes full pages; the hit cap leaves the last
            # token computed), so shorter prompts have no affinity
            return ("p", tuple(prompt[:ps]))
        return None

    def _candidates(self, head=None, stage="prefill", exclude=(),
                    pin=None):
        with self._lock:
            hs = [h for h in self._handles.values()
                  if h.engine_id not in exclude]
        if pin is not None:
            return [h for h in hs if h.engine_id == pin and h.healthy()]
        roles = ("any", "prefill") if stage == "prefill" \
            else ("any", "decode")
        hs = [h for h in hs if h.healthy() and h.role in roles]
        # the effective load blends the engine's own report with the
        # router's in-flight count: reported numbers lag by a heartbeat,
        # and during an arrival burst every stale 0 would tie-break to
        # the same engine
        loads = {h.engine_id: max(h.load(), h.pending) for h in hs}
        hs.sort(key=lambda h: (loads[h.engine_id], h.occupancy(),
                               h.engine_id))
        if head is not None and hs:
            aff = self._affinity.get(head)
            lightest = loads[hs[0].engine_id]
            for i, h in enumerate(hs):
                if h.engine_id == aff:
                    # prefer the page-holding engine — but spill once it
                    # is affinity_spill requests deeper than the
                    # lightest replica (the session's next requests
                    # prefix-hit remotely there instead of queueing here)
                    if i and loads[aff] <= lightest + self.affinity_spill:
                        hs.insert(0, hs.pop(i))
                    break
        return hs

    def _has_decode_pool(self):
        with self._lock:
            return any(h.role == "decode" for h in self._handles.values())

    # ------------------------------------------------------------ submit
    def submit(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
               temperature=0.0, top_k=None, on_token=None, block=True,
               timeout=10.0, session=None, engine=None, request_id=None,
               trace=None):
        """Same surface as ``ServingEngine.submit`` (so the Poisson
        loadgen drives a fleet unchanged), plus ``session=`` (explicit
        affinity key), ``engine=`` (pin to one engine id — tests and
        cross-engine warm paths) and ``request_id=`` (the
        client's exactly-once idempotency key: a terminal id
        replays the recorded result without touching an engine, an
        in-flight id attaches to the live request). ->
        :class:`FleetRequest`."""
        self._check_lease()
        if self._ledger is not None and request_id is not None:
            fr = self._resubmit(str(request_id), on_token)
            if fr is not None:
                return fr
        if trace is None:
            # the router is the front door here: mint the trace context
            # itself (None when tracing is off — one call, no allocation)
            trace = _trc.mint_context()
        fr = FleetRequest(prompt_ids, max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id,
                          temperature=temperature, top_k=top_k,
                          on_token=on_token, request_id=request_id,
                          trace=trace)
        if self._ledger is not None:
            # journal admission BEFORE the first placement: the record
            # is the idempotency anchor a retry (or a shadow) finds
            t_led = time.time() if trace is not None else 0.0
            try:
                self._ledger.accept(fr)
            except Exception:
                pass
            if trace is not None:
                _trc.req_event(trace, "ledger_accept", t_led,
                               time.time() - t_led,
                               args={"rid": fr.request_id})
        deadline = time.perf_counter() + (float(timeout) if block else 0.0)
        first = True
        t_route = time.time() if trace is not None else 0.0
        while True:
            if self._dispatch(fr, session=session, pin=engine):
                if trace is not None:
                    dur = time.time() - t_route
                    _trc.req_event(trace, "route", t_route, dur,
                                   args={"engine": fr.engine_id})
                    self.metrics.on_phase("route", dur)
                if not fr.done():
                    with self._lock:
                        self._inflight[fr.request_id] = fr
                return fr
            self.saturated += bool(first)
            first = False
            if time.perf_counter() >= deadline:
                raise FleetSaturated(
                    "every engine's admission queue is full "
                    f"({len(self._handles)} engine(s))")
            time.sleep(0.005)

    # ------------------------------------------------ exactly-once ledger
    def _check_lease(self):
        """Dispatch-path fence: a deposed router must stop dispatching.
        Between beats (ttl/3 cadence) this is one monotonic compare —
        the term re-read only happens on the beat itself."""
        if self._fenced:
            raise RouterDeposedError(
                "router fenced: a shadow holds the front-door lease")
        lease = self.lease
        if lease is None:
            return
        try:
            lease.beat()
        except RouterDeposedError:
            self.fence()
            raise

    def fence(self):
        """Stop dispatching permanently (deposed). Front-door processes
        map this to the named exit ``EXIT_DEPOSED`` (76) — the same
        yield-don't-split-brain contract as a deposed coordinator."""
        self._fenced = True

    def _resubmit(self, rid, on_token):
        """Idempotent resubmission: the same request id reaches the
        same request. -> FleetRequest, or None (novel id: caller
        dispatches fresh)."""
        with self._lock:
            live = self._inflight.get(rid)
        if live is not None:
            # attach to the live leg — the original stream keeps its
            # on_token; a second callback would double-deliver tokens
            self.requests_attached += 1
            return live
        rec = self._ledger.lookup(rid)
        if rec is None:
            return None
        if rec.get("state") in TERMINAL_STATES:
            return self._replay_terminal(rec, on_token)
        # non-terminal record with no live request: this incarnation
        # never saw it (shadow-takeover edge, or a saturated submit the
        # client retried) — adopt it off the journal now
        return self._adopt_record(rec, on_token=on_token)

    def _replay_terminal(self, rec, on_token=None):
        """Rebuild a finished request from its terminal record:
        byte-identical tokens (or the same typed error), no engine
        touched."""
        fr = FleetRequest(rec["prompt"],
                          max_new_tokens=rec.get("max_new_tokens", 16),
                          eos_token_id=rec.get("eos_token_id"),
                          temperature=rec.get("temperature", 0.0),
                          top_k=rec.get("top_k"), on_token=on_token,
                          request_id=rec["rid"],
                          trace=rec.get("trace"))
        toks = [int(t) for t in rec.get("tokens", [])]
        err = rebuild_error(rec.get("error"))
        fr.engine_id = rec.get("engine_id")
        fr.engine_ids = list(rec.get("engine_ids") or [])
        fr.queue_wait_s = float(rec.get("queue_wait_s", 0.0))
        fr.evictions = int(rec.get("evictions", 0))
        now = time.perf_counter()
        fr.generated = list(toks)
        fr.token_times = [now] * len(toks)
        if toks:
            fr.t_first_token = now
        fr._ledger_cursor = len(toks)
        fr._ledger_done = True    # the record IS the journal: no rewrite
        if on_token is not None:
            for i, t in enumerate(toks):
                try:
                    on_token(fr, int(t),
                             err is None and i == len(toks) - 1)
                except Exception:
                    pass
        if fr.trace is not None:
            _trc.req_event(fr.trace, "ledger_replay", time.time(), 0.0,
                           args={"rid": fr.request_id})
        fr._finish(err)
        self.requests_replayed += 1
        self.metrics.on_router_replay()
        return fr

    def _adopt_record(self, rec, on_token=None):
        """Reconstruct one non-terminal ledger record into a live
        request: re-attach to the engine-side leg when its engine
        survived, else re-dispatch a continuation carrying the surfaced
        tokens (greedy token-identical, the existing re-dispatch
        contract)."""
        rid = rec["rid"]
        fr = FleetRequest(rec["prompt"],
                          max_new_tokens=rec.get("max_new_tokens", 16),
                          eos_token_id=rec.get("eos_token_id"),
                          temperature=rec.get("temperature", 0.0),
                          top_k=rec.get("top_k"), on_token=on_token,
                          request_id=rid, trace=rec.get("trace"))
        toks = [int(t) for t in rec.get("tokens", [])]
        now = time.perf_counter()
        # tokens[:cursor] were already surfaced to the client by the
        # deposed router — pre-seed them so only the unstreamed tail
        # re-fires callbacks (no duplicate tokens)
        fr.generated = list(toks)
        fr.token_times = [now] * len(toks)
        if toks:
            fr.t_first_token = now
        fr.engine_ids = list(rec.get("engine_ids") or [])
        fr._ledger_cursor = len(toks)
        with self._lock:
            already = self._inflight.get(rid)
            if already is not None:
                return already    # raced another adopter: theirs wins
            self._inflight[rid] = fr
        eid = rec.get("engine_id")
        leg_rid = rec.get("leg_rid")
        h = self._handles.get(eid) if eid is not None else None
        attached = False
        if rec.get("state") in ("dispatched", "streaming") \
                and h is not None and leg_rid is not None:
            try:
                attached = self._reattach(fr, h, leg_rid,
                                          skip=len(toks))
            except Exception:
                attached = False
        if not attached:
            # its engine died with the router (or the leg never
            # landed): fresh continuation leg on a healthy engine
            deadline = time.perf_counter() + 1.0
            while not self._dispatch(fr):
                if time.perf_counter() >= deadline:
                    self._finish_fr(fr, FleetSaturated(
                        "ledger adoption found no engine with queue "
                        "space"))
                    break
                time.sleep(0.02)
        self.requests_adopted += 1
        return fr

    def _reattach(self, fr, h, leg_rid, skip=0):
        """Adopt the engine-side leg of a takeover-inherited request.
        Remote: register the wire rid with the handle — its poller's
        history replay rebuilds the token list, surfacing only tokens
        beyond ``skip`` (the persisted cursor). Local: re-point the
        live GenerationRequest's callbacks under the engine step lock
        and replay the unstreamed tail. -> bool (attached)."""
        try:
            if not h.healthy():
                return False
        except Exception:
            return False
        if getattr(h, "remote", False):
            leg = h.attach(leg_rid, fr.prompt_ids,
                           on_token=fr._leg_token,
                           on_done=self._on_leg_done, fleet=fr,
                           skip=skip)
            with self._lock:
                leg._pending_done = False
                h.pending += 1
            fr._attach(leg, h.engine_id)
            return True
        eng = getattr(h, "engine", None)
        if eng is None or not hasattr(h, "find_leg"):
            return False
        leg = h.find_leg(leg_rid)
        if leg is None:
            return False           # finished engine-side: re-dispatch
        # _step_lock -> router lock is the established order (the
        # migrate hook set it); holding it freezes emission while the
        # callbacks swing over, so no token is lost or doubled
        with eng._step_lock:
            tail = [int(t) for t in leg.generated[skip:]]
            leg.on_token = fr._leg_token
            leg.on_done = self._on_leg_done
            leg._fleet = fr
            leg._handle_id = h.engine_id
            with self._lock:
                leg._pending_done = False
                h.pending += 1
            fr._attach(leg, h.engine_id)
            for i, t in enumerate(tail):
                fr._leg_token(leg, t, False)
        return True

    def adopt_from_ledger(self):
        """Shadow takeover: reconstruct the front door from the journal
        — every non-terminal record becomes a live request again,
        re-attached to its engine's live leg (unstreamed tail replayed
        off the persisted cursor) or re-dispatched when its engine died
        too. The roster must already be added (from the
        ``EngineRegistry``); affinity rebuilds lazily from traffic.
        -> number of requests adopted."""
        led = self._ledger
        if led is None:
            return 0
        before = self.requests_adopted
        for rec in led.inflight_records():
            self._adopt_record(rec)
        return self.requests_adopted - before

    def ledger_sweep(self):
        """Batch the surfaced-token cursors into the journal: ONE store
        write per request that emitted tokens since the last sweep —
        never per token, so the token path stays store-free between
        lifecycle transitions. Rides ``hedge_sweep`` (the autoscaler
        tick) or the front-door loop."""
        led = self._ledger
        if led is None:
            return 0
        with self._lock:
            frs = list(self._inflight.values())
        wrote = 0
        for fr in frs:
            if fr.done():
                continue
            with fr._tok_lock:
                toks = [int(t) for t in fr.generated]
            if len(toks) <= fr._ledger_cursor:
                continue
            leg = fr._leg
            leg_rid = getattr(leg, "request_id", None) \
                if leg is not None else None
            try:
                led.streaming(fr, toks, leg_rid=leg_rid)
                fr._ledger_cursor = len(toks)
                wrote += 1
            except Exception:
                pass
        return wrote

    def _ledger_dispatched(self, fr, engine_id, leg):
        led = self._ledger
        if led is None or fr._ledger_done:
            return
        try:
            led.dispatched(fr, engine_id,
                           leg_rid=getattr(leg, "request_id", None))
        except Exception:
            pass

    def _finish_fr(self, fr, error=None):
        """Every terminal path funnels here: finish the caller's
        handle, journal the durable result-of-record, then untrack —
        in that order, so a retry arriving mid-finish finds either the
        live request or the terminal record, never neither."""
        fr._finish(error)
        led = self._ledger
        if led is not None and not fr._ledger_done:
            fr._ledger_done = True
            try:
                led.terminal(fr)
            except Exception:
                pass
        ctx = fr.trace
        if ctx is not None:
            _trc.req_event(ctx, "fleet_done", time.time(), 0.0,
                           args={"rid": fr.request_id,
                                 "state": fr.state,
                                 "engines": list(fr.engine_ids),
                                 "hedged": fr._hedged})
            # the router owns the request end-to-end, so ITS terminal is
            # the tail-sampling decision point: retain the trace when
            # the request was interesting (error/hedge/evict/migrate),
            # slow, or explicitly sampled
            _trc.finish_request(
                ctx, dur_s=(fr.t_done - fr.t_submit)
                if fr.t_done is not None else None,
                error=error is not None, hedged=fr._hedged,
                evicted=fr.evictions > 0, migrated=fr.migrations > 0)
        self._untrack(fr)

    def _dispatch(self, fr, session=None, pin=None, exclude=()):
        """One placement attempt over the candidate order. -> bool."""
        prompt = fr.prompt_ids + fr.generated
        remaining = fr.max_new_tokens - len(fr.generated)
        if remaining <= 0:       # redispatch raced the last token
            self._finish_fr(fr)
            return True
        head = self._head_key(prompt, session)
        disagg = self._has_decode_pool()
        for h in self._candidates(head=head, stage="prefill",
                                  exclude=exclude, pin=pin):
            leg = GenerationRequest(
                prompt, max_new_tokens=remaining,
                eos_token_id=fr.eos_token_id,
                temperature=fr.temperature, top_k=fr.top_k,
                on_token=fr._leg_token,
                on_done=self._on_leg_done, trace=fr.trace)
            leg._fleet = fr
            if disagg and h.role == "prefill":
                leg.migrate_hook = self._migrate_after_prefill
            # attach AND count BEFORE submitting: a fast engine thread
            # can finish the leg (and fire on_done, which decrements
            # pending) before this thread returns from submit — both
            # sides of the bookkeeping must already be in place
            fr._leg = leg
            with self._lock:
                leg._pending_done = False   # fresh latch per attempt
                h.pending += 1
            try:
                # a remote handle substitutes its own wire-side leg —
                # the returned object is the one that will finish
                leg = h.submit(leg) or leg
            except (QueueFull, EngineClosed):
                # raced a full queue / shutdown: next candidate
                self._dec_pending(leg, h)
                continue
            with self._lock:
                prev_aff = self._affinity.get(head) \
                    if head is not None else None
                if head is not None:
                    if prev_aff == h.engine_id:
                        self.affinity_hits += 1
                    self._affinity.pop(head, None)    # move to LRU tail
                    self._affinity[head] = h.engine_id
                    while len(self._affinity) > self.MAX_AFFINITY:
                        del self._affinity[next(iter(self._affinity))]
                self.dispatched += 1
            fr._attach(leg, h.engine_id)
            if fr.trace is not None:
                _trc.req_event(fr.trace, "dispatch", time.time(), 0.0,
                               args={"engine": h.engine_id,
                                     "redispatches": fr.redispatches})
            self._ledger_dispatched(fr, h.engine_id, leg)
            if prev_aff is not None and prev_aff != h.engine_id:
                # affinity SPILL: the session's pages live on prev_aff —
                # push the shared prefix here before the prefill runs
                self._prefetch_spill(h, prompt)
            return True
        return False

    # ----------------------------------------------------- leg lifecycle
    def _dec_pending(self, leg, handle=None):
        """Decrement the dispatching handle's in-flight count EXACTLY
        once per leg attempt. Completion, abort, and re-dispatch can all
        race to this on different threads — the per-leg latch (reset at
        each dispatch attempt) makes the loser a no-op instead of a
        double decrement that understates load forever."""
        with self._lock:
            if getattr(leg, "_pending_done", False):
                return
            leg._pending_done = True
            h = handle
            if h is None:
                hid = getattr(leg, "_handle_id", None)
                h = self._handles.get(hid) if hid is not None else None
            if h is not None and h.pending > 0:
                h.pending -= 1

    def _untrack(self, fr):
        with self._lock:
            self._inflight.pop(fr.request_id, None)

    def _on_leg_done(self, leg):
        if leg.state != "migrating":
            self._dec_pending(leg)
        fr = getattr(leg, "_fleet", None)
        if fr is None or fr.done():
            return
        if leg.state == "migrating":
            return  # moved engines, not finished
        if getattr(leg, "_hedge_base", None) is not None:
            self._hedge_done(fr, leg)
            return
        if leg is not fr._leg:
            return  # stale leg (already replaced by a promotion)
        fr._absorb(leg)
        if leg.error is None:
            with self._lock:
                hleg = fr._hedge
                fr._hedge = None
            self._finish_fr(fr)
            if hleg is not None:
                if fr.trace is not None:
                    _trc.req_event(
                        fr.trace, "hedge_lost", time.time(), 0.0,
                        args={"winner": fr.engine_id,
                              "loser": getattr(hleg, "_handle_id",
                                               None)})
                self._abort_leg(hleg)   # the duplicate lost the race
            return
        with self._lock:
            has_hedge = fr._hedge is not None
        if has_hedge:
            # the primary died but its duplicate is still running with
            # the full continuation — let the hedge carry the request
            # instead of burning a re-dispatch on a third engine
            fr._leg = None
            return
        self._redispatch_or_fail(fr, leg.error)

    def _redispatch_or_fail(self, fr, err):
        handle = self._handles.get(fr.engine_id)
        retryable = isinstance(err, (EngineShuttingDown, EngineClosed,
                                     QueueFull)) \
            or (handle is not None and not handle.healthy())
        if not retryable or fr.redispatches >= self.max_redispatch:
            self._finish_fr(fr, err)
            return
        fr.redispatches += 1
        self.redispatched += 1
        # retry-elsewhere with the tokens already emitted carried in the
        # continuation prompt; the retry window is SHORT because this
        # runs inline on whatever thread delivered the completion (an
        # engine serve thread, a remote handle's poller, a drain loop) —
        # blocking it starves every other completion behind it
        deadline = time.perf_counter() + 1.0
        while not self._dispatch(fr, exclude=(fr.engine_id,)):
            if time.perf_counter() >= deadline:
                self._finish_fr(fr, FleetSaturated(
                    "re-dispatch found no engine with queue space"))
                return
            time.sleep(0.02)

    # ------------------------------------------------------------ hedging
    def hedge_sweep(self, now=None):
        """One pass over in-flight requests: prune the finished, hedge
        the stragglers (quiet longer than ``hedge_after_s``). Returns the
        number of hedges fired. Called from the autoscaler tick; tests
        and headless routers call it directly."""
        if now is None:
            now = time.perf_counter()
        fired = 0
        with self._lock:
            frs = list(self._inflight.values())
        for fr in frs:
            if fr.done():
                self._untrack(fr)
                continue
            if self.hedge_after_s is None or fr._hedge is not None \
                    or fr._leg is None:
                continue
            last = fr.token_times[-1] if fr.token_times else fr.t_submit
            if now - last < self.hedge_after_s:
                continue
            if self._hedge(fr):
                fired += 1
        # the ledger's cursor batching rides the same tick: one store
        # write per request that streamed since the last sweep
        self.ledger_sweep()
        return fired

    def _hedge(self, fr):
        """Duplicate ``fr``'s leg on a second engine. -> bool (fired)."""
        with fr._tok_lock:
            base = len(fr.generated)
            cont = fr.prompt_ids + fr.generated
            # a disaggregation migration in flight moves the leg to
            # _migrating_to (set under this same lock): a hedge placed
            # THERE would duplicate the leg on its own engine, and one
            # keyed only on the stale pre-migration engine_id could do
            # the same a tick later — exclude both
            migrating_to = fr._migrating_to
        remaining = fr.max_new_tokens - base
        if remaining <= 0:
            return False
        exclude = tuple(e for e in (fr.engine_id, migrating_to)
                        if e is not None)
        for h in self._candidates(stage="prefill", exclude=exclude):
            hleg = GenerationRequest(
                cont, max_new_tokens=remaining,
                eos_token_id=fr.eos_token_id,
                temperature=fr.temperature, top_k=fr.top_k,
                on_token=fr._leg_token,    # dropped until promotion
                on_done=self._on_leg_done, trace=fr.trace)
            hleg._fleet = fr
            hleg._hedge_base = base
            with self._lock:
                if fr._hedge is not None or fr.done():
                    return False
                hleg._pending_done = False
                h.pending += 1
                fr._hedge = hleg
            try:
                hleg = h.submit(hleg) or hleg
            except (QueueFull, EngineClosed):
                self._dec_pending(hleg, h)
                with self._lock:
                    fr._hedge = None
                continue
            with self._lock:
                fr._hedge = hleg   # remote handles substitute wire legs
            self.hedges_fired += 1
            self.metrics.on_hedge_fired()
            fr._hedged = True      # hedged traces are always retained
            if fr.trace is not None:
                _trc.req_event(fr.trace, "hedge_fired", time.time(), 0.0,
                               args={"engine": h.engine_id,
                                     "base_tokens": base})
            return True
        return False

    def _hedge_done(self, fr, hleg):
        with self._lock:
            if hleg is not fr._hedge:
                return             # superseded hedge — nothing to do
            fr._hedge = None
            primary = fr._leg
            if hleg.error is None:
                # freeze the primary's surfacing BEFORE the splice: any
                # token it emits from here on hits the identity guard
                fr._leg = None
        if fr.done():
            return
        if hleg.error is not None:
            # the hedge lost by failing; if the primary already died
            # waiting on it, fall back to the normal re-dispatch path
            if primary is None:
                self._redispatch_or_fail(fr, hleg.error)
            return
        self._promote_hedge(fr, hleg)
        self.hedges_won += 1
        self.metrics.on_hedge_won()
        if fr.trace is not None:
            _trc.req_event(fr.trace, "hedge_won", time.time(), 0.0,
                           args={"winner": getattr(hleg, "_handle_id",
                                                   fr.engine_id),
                                 "loser": getattr(primary, "_handle_id",
                                                  None)})
        if primary is not None:
            self._abort_leg(primary)   # the original lost the race

    def _promote_hedge(self, fr, hleg):
        """The duplicate finished first: splice its tokens over the
        primary's tail (greedy decode makes them identical where they
        overlap) and finish the fleet request."""
        base = hleg._hedge_base
        with fr._tok_lock:
            surfaced = len(fr.generated) - base   # primary tokens beyond
            tail = [int(t) for t in hleg.generated[surfaced:]]
            fr.generated[base:] = [int(t) for t in hleg.generated]
            now = time.perf_counter()
            for _ in tail:
                if fr.t_first_token is None:
                    fr.t_first_token = now
                fr.token_times.append(now)
        if fr.trace is not None and tail:
            # the splice IS the delivery instant for a hedge winner's
            # tokens — they surface to the caller all at once here, not
            # through _leg_token
            t_now = time.time()
            for i in range(len(tail)):
                _trc.req_event(fr.trace, "stream_token", t_now, 0.0,
                               args={"i": base + surfaced + i + 1,
                                     "fin": i == len(tail) - 1,
                                     "spliced": True})
        cb = fr.on_token
        if cb is not None:
            for i, t in enumerate(tail):
                try:
                    cb(fr, t, i == len(tail) - 1)
                except Exception:
                    pass
        fr._attach(hleg, getattr(hleg, "_handle_id", fr.engine_id))
        fr._absorb(hleg)
        self._finish_fr(fr)

    def _abort_leg(self, leg):
        """Silently cancel a hedge loser: its slot + pages free, its
        ``on_done`` never fires — the aborter owns the pending
        decrement. MUST run outside ``self._lock``: the engine abort
        takes ``_step_lock``, and the migrate hook already establishes
        the ``_step_lock -> router lock`` order."""
        hid = getattr(leg, "_handle_id", None)
        h = self._handles.get(hid) if hid is not None else None
        if h is None or not hasattr(h, "abort"):
            return
        try:
            cancelled = bool(h.abort(leg))
        except Exception:
            cancelled = False
        if cancelled:
            self._dec_pending(leg)
            self.aborts += 1
            self.metrics.on_abort()
            ctx = getattr(leg, "trace", None)
            if ctx is not None:
                _trc.req_event(ctx, "leg_abort", time.time(), 0.0,
                               args={"engine": hid})

    def _prefetch_spill(self, handle, prompt):
        """Pull the prompt's shared prefix pages onto ``handle``'s
        engine (page-share import) so the spilled session's prefill
        prefix-hits locally instead of missing cold."""
        eng = getattr(handle, "engine", None)
        if eng is None or getattr(eng.prefix, "share", None) is None:
            return

        def run():
            try:
                n = eng.prefetch_prefix(prompt)
            except Exception:
                return
            if n:
                with self._lock:
                    self.prefetch_pages += n
        if self._prefetch_async:
            threading.Thread(target=run, daemon=True,
                             name="fleet-prefetch").start()
        else:
            run()

    def _migrate_after_prefill(self, src_engine, leg):
        """``migrate_hook`` body: the prompt completed on a prefill
        engine — move the KV pages to the least-loaded decode engine.
        False (= stay) when no decode engine can take it."""
        fr = getattr(leg, "_fleet", None)
        cands = self._candidates(stage="decode",
                                 exclude=(getattr(fr, "engine_id", None)
                                          or src_engine.engine_id,))
        cands = [c for c in cands if c.role == "decode"
                 and getattr(c, "engine", None) is not None]
        for dst in cands:
            if fr is not None:
                # publish the target BEFORE the pages move (under the
                # same lock the hedge path reads): a hedge fired during
                # the migration must not land on dst — it would race
                # the arriving leg on its own engine. Cleared only
                # AFTER _attach repoints engine_id at dst, so the
                # exclusion never gaps.
                with fr._tok_lock:
                    fr._migrating_to = dst.engine_id
            try:
                try:
                    outcome = _disagg.migrate_request(
                        src_engine, dst.engine, leg)
                except _disagg.MigrationFailed:
                    continue  # a detached leg retries the next candidate
                if outcome == "skipped":
                    return False
                self._move_pending(leg, dst)
                self.migrations += 1
                if fr is not None:
                    fr.migrations += 1
                    fr._attach(leg, dst.engine_id)
                return True
            finally:
                if fr is not None:
                    with fr._tok_lock:
                        fr._migrating_to = None
        if leg.state == "migrating":
            # every candidate refused AFTER a failed attempt detached
            # the leg from the source — it must not dangle in no
            # engine: requeue on the source (recompute locally), or
            # fail with a typed error as the last resort
            try:
                src_engine.readmit_request(leg)
            except Exception as e:
                leg.finish(e)
            return False
        return False

    def _move_pending(self, leg, dst_handle):
        """Re-home the in-flight accounting of a migrated leg. A leg the
        router never dispatched (direct engine use swept up by a drain)
        has no pending count to move — and must not gain one: nothing
        would ever decrement it."""
        if getattr(leg, "_handle_id", None) is None:
            return
        with self._lock:
            old = self._handles.get(leg._handle_id)
            if old is not None and old.pending > 0:
                old.pending -= 1
            dst_handle.pending += 1
        leg._handle_id = dst_handle.engine_id

    # ----------------------------------------------------- engine drain
    def remove_engine(self, engine_id, migrate=True):
        """Take one engine out of rotation (planned loss, upgrade,
        graceful shutdown): queued requests fail with the retryable
        ``EngineShuttingDown`` and re-dispatch through ``on_done``;
        in-flight requests migrate their pages to healthy engines when
        ``migrate=True`` (recompute fallback built in), else drain
        through the engine's own close (re-dispatch recomputes). Returns
        ``{request_id: outcome}`` for the migrated set."""
        h = self._handles.get(engine_id)
        if h is None:
            raise KeyError(f"unknown engine {engine_id!r}")
        h.forced_down = True
        with self._lock:
            # dead engine ids must not linger as affinity targets (they
            # would defeat every future affinity check for those heads)
            for k in [k for k, v in self._affinity.items()
                      if v == engine_id]:
                del self._affinity[k]
        eng = getattr(h, "engine", None)
        out = {}
        if eng is None:
            return out
        queued = eng.scheduler.begin_shutdown()
        for req in queued:
            eng.metrics.on_finish(req)
        if migrate:
            def pick(req):
                for c in self._candidates(stage="decode",
                                          exclude=(engine_id,)):
                    if getattr(c, "engine", None) is not None:
                        return c.engine
                return None

            def moved(req, dst_engine, outcome):
                fr = getattr(req, "_fleet", None)
                dst_h = next(
                    (h for h in self.handles().values()
                     if getattr(h, "engine", None) is dst_engine), None)
                if dst_h is not None:
                    self._move_pending(req, dst_h)
                self.migrations += 1
                if fr is not None:
                    fr.migrations += 1
                    fr._attach(req, dst_h.engine_id if dst_h is not None
                               else dst_engine.engine_id)

            out = _disagg.drain_active(eng, pick, on_moved=moved)
        eng.close()
        if self.registry is not None:
            try:
                self.registry.deregister(engine_id)
            except Exception:
                pass
        return out

    def mark_unhealthy(self, engine_id):
        h = self._handles.get(engine_id)
        if h is not None:
            h.forced_down = True

    def drop_engine(self, engine_id):
        """Reap an ALREADY-DEAD engine from the roster (crashed serve
        loop, lost process): no drain, no migration — its legs have
        already failed through ``on_done`` re-dispatch. The graceful
        path is ``remove_engine``."""
        with self._lock:
            h = self._handles.pop(engine_id, None)
            for k in [k for k, v in self._affinity.items()
                      if v == engine_id]:
                del self._affinity[k]
        if h is None:
            return False
        h.forced_down = True
        if self.registry is not None:
            try:
                self.registry.deregister(engine_id)
            except Exception:
                pass
        return True

    # ------------------------------------------------------------ helpers
    def start(self):
        for h in self.handles().values():
            h.start()

    def close(self):
        for h in self.handles().values():
            try:
                h.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self):
        with self._lock:
            hs = dict(self._handles)
        return {
            "engines": {eid: {"healthy": h.healthy(), "role": h.role,
                              "load": h.load(), "pending": h.pending}
                        for eid, h in hs.items()},
            "dispatched": self.dispatched,
            "redispatched": self.redispatched,
            "migrations": self.migrations,
            "saturated": self.saturated,
            "affinity_hits": self.affinity_hits,
            "affinity_sessions": len(self._affinity),
            "hedges_fired": self.hedges_fired,
            "hedges_won": self.hedges_won,
            "aborts": self.aborts,
            "prefetch_pages": self.prefetch_pages,
            "inflight": len(self._inflight),
            "requests_replayed": self.requests_replayed,
            "requests_attached": self.requests_attached,
            "requests_adopted": self.requests_adopted,
            "fenced": self._fenced,
        }
