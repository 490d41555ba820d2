"""Continuous-batching scheduler — admit/evict/finish between rounds.

The port of ``paddle_tpu/serving/scheduler.py`` (host-side, no device
code): iteration-level scheduling over ``max_slots`` slots that the engine
re-points at requests between rounds.

* **admit** — waiting requests take a free slot when the page pool can
  hold their prompt (a prefix-cache hit takes its shared head by
  reference); admission runs every round, so a request arriving mid-stream
  joins the next round without stalling in-flight rows.
* **evict** — when an in-flight request needs its next page and the pool
  is dry, the most-recently-admitted active request is preempted: its
  pages are freed and it returns to the FRONT of the queue with
  ``prompt + generated-so-far`` as its new prompt (recompute on readmit;
  greedy decode makes the continuation token-identical).
* **finish** — eos / token budget frees pages + slot immediately, and
  fires the request's ``on_done`` once.
* **fleet hooks** — :meth:`~ContinuousBatchingScheduler.admit_prepared`
  (a migrated request whose KV is already written joins the decode batch
  directly), :meth:`~ContinuousBatchingScheduler.release_for_migration`,
  :meth:`~ContinuousBatchingScheduler.abort_request` (free slot + pages,
  fire nothing) and :meth:`~ContinuousBatchingScheduler.readmit`.
* **graceful shutdown** — :meth:`~ContinuousBatchingScheduler.
  begin_shutdown` fails only the QUEUED requests with the named
  :class:`EngineShuttingDown` and keeps the in-flight ones for the drain.

Backpressure: the waiting queue is bounded; ``submit`` blocks (or raises
:class:`QueueFull`) when producers outrun the engine. With tracing on
(:mod:`..observability.tracing`), each request carries a trace context and
its lifecycle events (enqueue, queue_wait, prefix_hit, evicted, readmit,
aborted, prefill, decode, request_done) land in its trace; off, every
hook is one ``req.trace is not None`` check.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

from ..observability import tracing as _trc
from .kv_cache import OutOfPages, pages_for

__all__ = ["GenerationRequest", "ContinuousBatchingScheduler",
           "QueueFull", "EngineClosed", "OutOfSlots"]


class QueueFull(RuntimeError):
    """Admission queue at capacity (open-loop producer outran the engine)."""


class OutOfSlots(RuntimeError):
    """No free decode slot for a direct admission (fleet page migration
    adopting a request bypasses the queue; the caller falls back to
    recompute-on-readmit)."""


class EngineClosed(RuntimeError):
    """Submitted to / waited on an engine that has been closed."""


class EngineShuttingDown(EngineClosed):
    """The engine began a graceful shutdown (SIGTERM drain): admission is
    closed and queued requests are failed with THIS status — a named,
    retryable verdict the caller can route to another replica — while
    in-flight decodes drain up to the deadline. Distinct from the bare
    :class:`EngineClosed` a hard ``close()`` hands out."""


_rid = itertools.count()
# Fallback request-id namespace: in a fleet, two engine PROCESSES each
# minting rids from a bare per-process counter would alias (same rid on
# two engines corrupts merged traces, metrics labels and ledger keys).
# The pid-derived high component keeps the fallback an int — rng() folds
# request_id into its seed arithmetic — while making cross-process
# collision impossible for live pids (mod the 2^20 namespace).
_RID_NS = (os.getpid() & 0xFFFFF) << 20


class GenerationRequest:
    """One streaming generation request.

    ``on_token(req, token, finished)`` fires from the engine thread for
    every generated token (callback errors are swallowed — a slow/broken
    consumer must not stall the decode loop). ``result()`` blocks for the
    full generated-token list.
    """

    def __init__(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                 temperature=0.0, top_k=None, seed=0, on_token=None,
                 request_id=None, on_done=None, trace=None):
        self.request_id = request_id if request_id is not None \
            else (_RID_NS + next(_rid))
        # distributed trace context ({"tid", "ps"} dict, or None): minted
        # at the front door / scheduler submit, propagated over the fleet
        # wire. None whenever tracing is off — every hot-path hook gates
        # on this one attribute, which is what keeps tracing-off
        # structurally free (no allocation, no call).
        self.trace = trace
        self.prompt_ids = [int(t) for t in prompt_ids]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = top_k
        self.seed = int(seed)
        self.on_token = on_token
        # fires once, at the terminal state (fleet router: re-dispatch a
        # retryable failure to another engine without polling result())
        self.on_done = on_done
        # fleet migration hook: set by the router on prefill-designated
        # engines — called from _finish_prompt when the prompt completes
        # but the token budget has more to go (see disagg.migrate_request)
        self.migrate_hook = None
        self.generated: list[int] = []
        self.state = "waiting"   # waiting|prefilling|active|finished|failed
        self.error = None
        self.slot = None
        self.pages: list[int] = []
        self.num_cached = 0          # tokens currently in the KV pool
        self.prefix_hit_tokens = 0   # prompt head served from the cache
        self.evictions = 0
        self.t_submit = time.perf_counter()
        self.t_enqueue = self.t_submit   # reset on eviction; the total
        # across re-admissions accumulates in queue_wait_s (an evicted
        # request's pre-eviction queue time must not vanish from the tail)
        self.queue_wait_s = 0.0
        self.t_admit = None
        self.t_first_token = None
        self.t_done = None
        self.token_times: list[float] = []
        self._done = threading.Event()
        self._rng = None

    # ---- engine-side helpers -------------------------------------------
    def effective_prompt(self):
        """Prompt for (re-)prefill: original prompt plus everything already
        generated (an evicted request recomputes its own context)."""
        return self.prompt_ids + self.generated

    def rng(self):
        if self._rng is None:
            import numpy as np
            self._rng = np.random.RandomState(
                (self.seed + self.request_id) % (2 ** 31))
        return self._rng

    def emit(self, token):
        now = time.perf_counter()
        if self.t_first_token is None:
            self.t_first_token = now
        self.token_times.append(now)
        self.generated.append(int(token))
        cb = self.on_token
        if cb is not None:
            try:
                cb(self, int(token), self.hit_stop())
            except Exception:
                pass

    def finish(self, error=None):
        self.state = "failed" if error is not None else "finished"
        self.error = error
        self.t_done = time.perf_counter()
        if self.trace is not None:
            self._trace_terminal(error)
        self._done.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass  # a broken observer must not stall the engine

    def _trace_terminal(self, error):
        """Lifecycle spans at the terminal state plus (for a request this
        process owns outright) the tail-sampling verdict. Fleet legs
        carry ``_fleet`` and leave the verdict to the router, which alone
        knows about hedging and the end-to-end latency. Durations are
        perf_counter deltas anchored backward from the wall clock the
        trace buffer stamps."""
        ctx, now = self.trace, time.time()
        if self.t_admit is not None and self.t_first_token is not None:
            back = self.t_done - self.t_admit
            _trc.req_event(ctx, "prefill", now - back,
                           self.t_first_token - self.t_admit,
                           args={"prompt": len(self.prompt_ids),
                                 "prefix_hit": self.prefix_hit_tokens})
        if self.t_first_token is not None:
            dur = self.t_done - self.t_first_token
            _trc.req_event(ctx, "decode", now - dur, dur,
                           args={"tokens": len(self.generated)})
        _trc.req_event(ctx, "request_done", now, 0.0,
                       args={"rid": str(self.request_id),
                             "state": self.state,
                             "evictions": self.evictions})
        if getattr(self, "_fleet", None) is None:
            _trc.finish_request(ctx, dur_s=self.t_done - self.t_submit,
                                error=error is not None,
                                evicted=self.evictions > 0)

    def hit_stop(self):
        """Generation-complete test: token budget or eos."""
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and self.generated
                and self.generated[-1] == int(self.eos_token_id))

    # ---- caller-side surface -------------------------------------------
    def done(self):
        return self._done.is_set()

    def result(self, timeout=60.0):
        """-> the generated token list (prompt excluded); raises on
        failure/timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done in {timeout}s "
                f"(state={self.state})")
        if self.error is not None:
            raise self.error
        return list(self.generated)

    def ttft_s(self):
        return (self.t_first_token - self.t_submit) \
            if self.t_first_token else None

    def inter_token_s(self):
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]


class ContinuousBatchingScheduler:
    """Owns the waiting queue, the slot map, and page accounting."""

    def __init__(self, allocator, max_slots, page_size, max_seq_len,
                 max_queue=256, prefix_cache=None):
        self.allocator = allocator
        self.prefix_cache = prefix_cache
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_seq_len = int(max_seq_len)
        self.max_queue = int(max_queue)
        self.waiting: deque = deque()
        self.active: dict[int, GenerationRequest] = {}
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._closed = False
        self._shutting_down = False
        self.total_evictions = 0

    # ---- producer side --------------------------------------------------
    def submit(self, req, block=True, timeout=10.0):
        total = len(req.prompt_ids) + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(req.prompt_ids)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        if pages_for(total, self.page_size) > self.allocator.capacity:
            raise ValueError(
                f"request needs {pages_for(total, self.page_size)} pages; "
                f"pool has {self.allocator.capacity} — it could never run")
        with self._space:
            if self._closed:
                raise self._closed_error()
            if len(self.waiting) >= self.max_queue and block:
                deadline = time.perf_counter() + timeout
                while len(self.waiting) >= self.max_queue \
                        and not self._closed:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._space.wait(left)
                if self._closed:
                    raise self._closed_error()
            if len(self.waiting) >= self.max_queue:
                raise QueueFull(
                    f"waiting queue at capacity ({self.max_queue})")
            self.waiting.append(req)
        if req.trace is None:
            # single funnel for engine-local traces: a request arriving
            # without a fleet-minted context gets its own (None when
            # tracing is off — one call, no allocation)
            req.trace = _trc.mint_context()
        if req.trace is not None:
            _trc.req_event(req.trace, "enqueue", time.time(), 0.0,
                           args={"rid": str(req.request_id),
                                 "depth": len(self.waiting)})
        return req

    def queue_depth(self):
        with self._lock:
            return len(self.waiting)

    # ---- engine side (single engine thread) -----------------------------
    def schedule(self):
        """Admission pass: -> requests newly admitted this step (pages +
        slot assigned; the engine prefills them). Never evicts on behalf
        of a waiting request — in-flight work has priority."""
        admitted = []
        while self._free_slots:
            with self._lock:
                if not self.waiting:
                    break
                req = self.waiting[0]
            # prefix lookup + page accounting OUTSIDE the lock: producers
            # block on this very lock in submit(), and a lookup may be
            # slow (a fleet-wide prefix index is a store round-trip).
            # Pages/slots are engine-thread-owned, so only the deque
            # needs the lock.
            prompt = req.effective_prompt()
            shared, n_shared = [], 0
            if self.prefix_cache is not None:
                # prefix-cache hit: the shared head's pages are taken
                # by reference (no prefill compute, no page writes) —
                # only the tail needs private pages
                shared, n_shared = self.prefix_cache.lookup(prompt)
            need = pages_for(len(prompt) + 1, self.page_size) \
                - len(shared)
            if not self.allocator.can_alloc(need):
                if shared:    # un-ref the speculative hit
                    self.allocator.free(shared)
                break
            with self._lock:
                if not self.waiting or self.waiting[0] is not req:
                    # a readmission (eviction / migration fallback, maybe
                    # from another engine's thread) jumped the queue head
                    # while the lock was dropped: un-ref and re-examine
                    if shared:
                        self.allocator.free(shared)
                    continue
                self.waiting.popleft()
                self._space.notify_all()
            req.pages = shared + self.allocator.alloc(need)
            req.num_cached = n_shared
            req.prefix_hit_tokens = n_shared
            if self.prefix_cache is not None and req.evictions == 0:
                # request-level hit/miss: first admission only — a
                # readmission re-hitting its own cached head would
                # double-count the request in the hit rate
                self.prefix_cache.record(n_shared)
            req.slot = self._free_slots.pop()
            req.state = "active"
            req.t_admit = time.perf_counter()
            req.queue_wait_s += req.t_admit - req.t_enqueue
            self.active[req.slot] = req
            admitted.append(req)
            if req.trace is not None:
                self._trace_admit(req)
        return admitted

    def _trace_admit(self, req):
        """queue_wait span (anchored backward from now) + prefix-hit
        marker for one just-admitted request."""
        now = time.time()
        wait = req.t_admit - req.t_enqueue
        _trc.req_event(req.trace, "queue_wait", now - wait, wait,
                       args={"slot": req.slot,
                             "evictions": req.evictions})
        if req.prefix_hit_tokens:
            _trc.req_event(req.trace, "prefix_hit", now, 0.0,
                           args={"tokens": req.prefix_hit_tokens})

    def ensure_decode_capacity(self):
        """Before a decode step: every active request writing token
        ``num_cached`` needs page ``num_cached // page_size``. Grow block
        tables, evicting the most-recently-admitted active request when
        the pool is dry. -> (grown, evicted) request lists."""
        grown, evicted = [], []
        # oldest first: under pressure the senior requests grab pages
        # before the juniors (who are also the eviction victims)
        for req in sorted(self.active.values(),
                          key=lambda r: r.t_admit or 0.0):
            if req.state != "active":
                continue
            while req.num_cached // self.page_size >= len(req.pages):
                try:
                    req.pages += self.allocator.alloc(1)
                    grown.append(req)
                except OutOfPages:
                    victim = self._pick_victim(exclude=req)
                    if victim is None:
                        # only this request is left: nothing to reclaim —
                        # evict IT (it re-prefills once pages free up)
                        self._evict(req)
                        evicted.append(req)
                        break
                    self._evict(victim)
                    evicted.append(victim)
        return grown, evicted

    def _pick_victim(self, exclude=None):
        cands = [r for r in self.active.values()
                 if r is not exclude and r.state == "active"]
        if not cands:
            return None
        return max(cands, key=lambda r: r.t_admit or 0.0)

    def _evict(self, req):
        self._release(req)
        req.evictions += 1
        self.total_evictions += 1
        if req.trace is not None:
            _trc.req_event(req.trace, "evicted", time.time(), 0.0,
                           args={"evictions": req.evictions,
                                 "generated": len(req.generated)})
        self.readmit(req)

    def readmit(self, req):
        """Re-queue an already-released request at the FRONT of the
        waiting queue with its context reset — it re-prefills its
        ``effective_prompt()`` on admission (greedy continuation is
        token-identical). The eviction path and the fleet's
        recompute-on-migrate fallback share this one copy."""
        req.state = "waiting"
        req.num_cached = 0
        req.t_enqueue = time.perf_counter()
        if req.trace is not None:
            _trc.req_event(req.trace, "readmit", time.time(), 0.0,
                           args={"generated": len(req.generated)})
        with self._lock:
            self.waiting.appendleft(req)

    def admit_prepared(self, req):
        """Adopt a request whose pages are ALREADY allocated and whose KV
        is already written into this engine's pools (fleet page
        migration): take a free slot and join the decode batch directly —
        no queue, no prefill. Raises :class:`OutOfSlots` when every slot
        is taken (the caller falls back to :meth:`readmit`)."""
        with self._lock:
            if self._closed:
                raise self._closed_error()
            if not self._free_slots:
                raise OutOfSlots(
                    f"all {self.max_slots} slots busy — migrated request "
                    "must recompute from the queue instead")
            req.slot = self._free_slots.pop()
        req.state = "active"
        req.t_admit = time.perf_counter()
        self.active[req.slot] = req

    def release_for_migration(self, req):
        """Free a migrating request's slot + pages WITHOUT finishing it:
        the request object itself moves to another engine, and its
        waiters keep waiting on the same done event."""
        self._release(req)
        req.state = "migrating"

    def abort_request(self, req):
        """Cancel one leg SILENTLY: free its slot + pages (wherever it
        is — queued, prefilling or active) without firing its waiters or
        ``on_done``. The loser of a hedged (duplicated) request: the
        caller owns the request's done event through a different winning
        leg, so the loser must simply vanish from this engine.
        Returns False when the request already reached a terminal state
        (its ``on_done`` fired / will fire normally)."""
        if req.state in ("finished", "failed", "migrating", "aborted"):
            return False
        with self._lock:
            try:
                self.waiting.remove(req)
                self._space.notify_all()
            except ValueError:
                pass
        self._release(req)
        req.state = "aborted"
        ctx = req.trace
        if ctx is not None:
            _trc.req_event(ctx, "aborted", time.time(), 0.0,
                           args={"generated": len(req.generated)})
            if getattr(req, "_fleet", None) is None:
                # a locally-owned abort is its own terminal state; fleet
                # legs leave the verdict to the fleet's router
                _trc.finish_request(ctx, aborted=True)
        return True

    def _release(self, req):
        if req.pages:
            self.allocator.free(req.pages)
            req.pages = []
        if req.slot is not None:
            del self.active[req.slot]
            self._free_slots.append(req.slot)
            req.slot = None

    def finish(self, req, error=None):
        self._release(req)
        req.finish(error)

    def complete_step(self, tokens_by_slot):
        """Account one decode step: ``{slot: token}`` for every slot that
        was active when the step launched. -> finished requests."""
        done = []
        for slot, token in tokens_by_slot.items():
            req = self.active.get(slot)
            if req is None or req.state != "active":
                continue
            req.num_cached += 1      # this step wrote the input token's KV
            req.emit(token)
            if req.hit_stop():
                self.finish(req)
                done.append(req)
        return done

    def has_work(self):
        with self._lock:
            return bool(self.waiting) or bool(self.active)

    def _closed_error(self):
        return EngineShuttingDown("engine is shutting down") \
            if self._shutting_down else EngineClosed("engine is closed")

    def begin_shutdown(self, error=None):
        """Graceful half of teardown: stop admitting (later submits raise
        :class:`EngineShuttingDown`), fail every QUEUED request with that
        named status, keep the in-flight ones — the engine drains them
        with further decode steps up to its deadline, then ``close()``\\ s
        whatever remains. Returns the failed queued requests (the caller
        records their terminal metrics — they must not vanish from the
        flushed counters)."""
        err = error or EngineShuttingDown(
            "engine is shutting down: request was queued, not started — "
            "safe to retry on another replica")
        with self._space:
            self._closed = True
            self._shutting_down = True
            waiting = list(self.waiting)
            self.waiting.clear()
            self._space.notify_all()
        now = time.perf_counter()
        for req in waiting:
            # a rejected-at-queue request's whole life was queue wait:
            # close out the pending segment so the cumulative-wait
            # histogram sample observed at its terminal state is honest
            req.queue_wait_s += now - req.t_enqueue
            req.finish(err)
        return waiting

    def close(self, error=None):
        """Fail everything still queued or in flight (engine teardown)."""
        err = error or self._closed_error()
        with self._space:
            self._closed = True
            waiting = list(self.waiting)
            self.waiting.clear()
            self._space.notify_all()
        for req in waiting:
            req.finish(err)
        for req in list(self.active.values()):
            self._release(req)
            req.finish(err)
