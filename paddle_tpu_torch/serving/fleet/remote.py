"""Store-RPC serving — drive a remote ``ServingEngine`` over the TCPStore.

The port of ``paddle_tpu/serving/fleet/remote.py`` (host Python): each
engine replica runs in its own process (its own pools, on its own card
or beside others on one) and serves a small RPC protocol over the
control-plane store — the transport the registry, the page-share index
and the elastic rendezvous already ride, so a fleet needs ONE listening
port.

Protocol (keys under ``serving/<job>/eng/<eid>/``):

* ``in_seq`` counter + ``in/<seq>`` JSON — submissions (the router's
  client handle appends; the engine process tails). A record with
  ``"abort": true`` cancels the named request silently — slot and pages
  free, no completion published;
* ``out_seq`` counter + ``out/<seq>`` JSON — completions (tokens or a
  typed, retryability-preserving error: ``QueueFull`` /
  ``EngineShuttingDown`` / ``EngineClosed`` rebuild client-side so the
  router's retry-elsewhere logic treats remote engines as local ones);
* ``stream/tok_seq`` counter + ``stream/tok/<n>`` JSON — incremental
  token batches: every poll tick the server flushes the tokens emitted
  since the last tick as ONE record ``{"items": [[rid, [tokens...],
  fin], ...]}``, so the client's ``on_token`` and TTFT reflect real
  emission time. Completions replay only the tokens the stream has not
  already surfaced, so the two channels compose without duplicates;
* ``stop`` — graceful server exit (drain + final stats publish).

A retried submission of a live or finished rid is deduped by the server
(one engine-side leg; a finished one republishes its recorded result).

Engine process::

    python -m paddle_tpu_torch.serving.fleet.remote --store 127.0.0.1:6200 \
        --engine-id e0 --job fleet --seed 0 [--role any] [--share] \
        [--device cuda] [--dtype bfloat16]

``--device`` (default ``cuda``) and ``--dtype`` (default ``float32``, the
JAX package's model dtype) are the port's own: its models take a device
and a dtype. Per-engine TTFT/ITL tails come from the engine process's
own labeled metrics JSONL (``--metrics-dir``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from ...distributed import keyspace
from ...observability import tracing as _trc
from ..scheduler import (EngineClosed, EngineShuttingDown,
                         GenerationRequest, QueueFull)

__all__ = ["serve_over_store", "RemoteEngineHandle", "main"]

_ERRORS = {"QueueFull": QueueFull,
           "EngineShuttingDown": EngineShuttingDown,
           "EngineClosed": EngineClosed}


def _result_record(rid, req=None, error=None):
    if error is None and req is not None and req.error is not None:
        error = req.error
    rec = {"rid": rid,
           "tokens": list(req.generated) if req is not None else [],
           "error": None}
    if error is not None:
        rec["error"] = {"type": type(error).__name__, "msg": str(error)}
    if req is not None:
        rec["queue_wait_s"] = req.queue_wait_s
        rec["evictions"] = req.evictions
        ttft = req.ttft_s()
        if ttft is not None:
            rec["ttft_s"] = ttft
    return rec


def serve_over_store(engine, store, engine_id, job="fleet",
                     registry=None, role="any", poll_s=0.04,
                     idle_timeout=None):
    """Serve one engine until the ``stop`` key appears (or
    ``idle_timeout`` seconds pass with no traffic). The engine must be
    ``start()``ed; completions are published from this thread only (one
    store client, one writer). Every store op this loop makes steals
    host time from the engine's serve thread, so the polls are lean: one
    ``in_seq`` read per tick, the stop keys every few ticks."""
    prefix = keyspace.fleet_engine_rpc(job, engine_id)
    stream_prefix = keyspace.fleet_engine_stream(job, engine_id)
    fleet_stop = f"{keyspace.fleet_registry(job)}/stop"
    done_lock = threading.Lock()
    done_queue = []          # results ready to publish
    tok_lock = threading.Lock()
    tok_buf = []             # (rid, token, fin) since the last flush
    inflight = {}            # rid -> engine-side request (abort target)
    # server-side idempotency: a client whose submit timed out retries
    # the SAME rid — without this cache the retry record would spawn a
    # second GenerationRequest and the engine would generate twice.
    # Bounded FIFO: old entries age out, and a rid old enough to have
    # aged out is also old enough to be answered by the durable ledger.
    finished = {}            # rid -> published result record
    _FINISHED_CAP = 512

    def _remember(rid, rec):
        # caller holds done_lock
        finished[rid] = rec
        while len(finished) > _FINISHED_CAP:
            del finished[next(iter(finished))]

    def on_done(req):
        inflight.pop(req._rid, None)
        with done_lock:
            rec = _result_record(req._rid, req)
            _remember(req._rid, rec)
            done_queue.append(rec)

    def on_token(req, token, fin):
        with tok_lock:
            tok_buf.append((req._rid, int(token), bool(fin)))

    consumed = 0
    tick = 0
    last_traffic = time.monotonic()
    last_publish = 0.0
    while True:
        tick += 1
        if tick % 5 == 1 and (store.check(f"{prefix}/stop")
                              or store.check(fleet_stop)):
            break
        if idle_timeout is not None \
                and time.monotonic() - last_traffic > idle_timeout:
            break
        head = int(store.add(f"{prefix}/in_seq", 0))
        while consumed < head:
            consumed += 1
            try:
                msg = json.loads(store.get(f"{prefix}/in/{consumed}",
                                           timeout=10))
            except Exception:
                continue  # torn submission: the client will time out
            last_traffic = time.monotonic()
            rid = msg["rid"]
            if msg.get("abort"):
                req = inflight.pop(rid, None)
                if req is not None:
                    try:
                        engine.abort_request(req)
                    except Exception:
                        pass
                continue
            if rid in inflight:
                continue     # duplicate of a live request: one leg only
            with done_lock:
                replay = finished.get(rid)
                if replay is not None:
                    # retry of a finished rid: republish the recorded
                    # result instead of generating again
                    done_queue.append(replay)
            if replay is not None:
                continue
            try:
                # trace context off the wire: the SAME trace id the
                # router journaled, so this process's spans merge into
                # the one cross-process waterfall. None when the
                # submitter traced nothing.
                trace = msg.get("trace")
                req = GenerationRequest(
                    msg["prompt"],
                    max_new_tokens=int(msg.get("max_new_tokens", 16)),
                    eos_token_id=msg.get("eos_token_id"),
                    temperature=float(msg.get("temperature", 0.0)),
                    top_k=msg.get("top_k"), on_token=on_token,
                    on_done=on_done, trace=trace)
                req._rid = rid
                if trace is not None:
                    _trc.req_event(trace, "rpc_submit", time.time(),
                                   0.0, args={"rid": rid,
                                              "engine": engine_id})
                inflight[rid] = req
                engine.submit_request(req, block=False)
            except Exception as e:
                inflight.pop(rid, None)
                with done_lock:
                    rec = _result_record(rid, error=e)
                    _remember(rid, rec)
                    done_queue.append(rec)
        # per-token streaming: flush everything emitted since the last
        # tick as ONE batched record — a store write per tick, not per
        # token (and none at all on an idle tick)
        with tok_lock:
            toks, tok_buf[:] = list(tok_buf), []
        if toks:
            last_traffic = time.monotonic()
            by_rid, order, fins = {}, [], {}
            for rid, t, fin in toks:
                if rid not in by_rid:
                    by_rid[rid] = []
                    order.append(rid)
                by_rid[rid].append(t)
                fins[rid] = fin
            rec = {"items": [[r, by_rid[r], fins[r]] for r in order]}
            seq = int(store.add(f"{stream_prefix}/tok_seq", 1))
            store.set(f"{stream_prefix}/tok/{seq}", json.dumps(rec))
            tr = _trc._TR if _trc._loaded else _trc._load()
            if tr is not None:
                now = time.time()
                for r in order:
                    req = inflight.get(r)
                    ctx = getattr(req, "trace", None) \
                        if req is not None else None
                    if ctx is not None:
                        _trc.req_event(ctx, "stream_flush", now, 0.0,
                                       args={"tokens": len(by_rid[r]),
                                             "seq": seq})
        with done_lock:
            ready, done_queue[:] = list(done_queue), []
        for rec in ready:
            last_traffic = time.monotonic()
            seq = int(store.add(f"{prefix}/out_seq", 1))
            store.set(f"{prefix}/out/{seq}", json.dumps(rec))
        # load-stats refresh rides this loop THROTTLED (the registry's
        # own heartbeat thread already proves liveness at ttl/3; a
        # publish per poll tick would burn a store write every 20ms per
        # engine — measurable CPU on a small fleet host)
        now = time.monotonic()
        if registry is not None and now - last_publish > 0.25:
            last_publish = now
            try:
                registry.publish(engine_id, engine, role)
            except Exception:
                pass
        time.sleep(poll_s)


class _RemoteLeg:
    """Duck-typed stand-in for the engine-side GenerationRequest: the
    router treats it exactly like a local leg (state/error/on_done/
    accounting), completed by the handle's poller thread."""

    def __init__(self, rid, prompt, on_token=None, on_done=None,
                 skip=0):
        self.request_id = rid
        self.prompt_ids = list(prompt)
        self.generated = []
        self.state = "active"
        self.error = None
        self.queue_wait_s = 0.0
        self.evictions = 0
        self.on_token = on_token
        self.on_done = on_done
        self.migrate_hook = None
        self.trace = None        # propagated from the router leg
        # takeover re-attachment: a fresh handle's poller
        # replays the engine's stream history from seq 0 — the first
        # ``skip`` tokens were already surfaced to the client by the
        # deposed router (the ledger's persisted cursor), so they
        # rebuild ``generated`` silently; only the unstreamed tail
        # fires callbacks. Zero for normal submissions.
        self._skip = int(skip)

    def _stream(self, tokens, fin):
        """Adopt one incremental token batch from the stream channel
        (poller thread): surfaces through ``on_token`` immediately, so
        the fleet caller's TTFT/ITL reflect real emission time."""
        cb = self.on_token
        for i, t in enumerate(tokens):
            self.generated.append(int(t))
            if cb is not None and len(self.generated) > self._skip:
                try:
                    cb(self, int(t), bool(fin) and i == len(tokens) - 1)
                except Exception:
                    pass

    def _complete(self, rec):
        err = rec.get("error")
        tokens = [int(t) for t in rec.get("tokens", [])]
        # the stream channel already surfaced self.generated[:start] —
        # replay ONLY the tail the stream has not delivered yet (zero
        # when streaming kept up; everything when the server predates
        # the stream keys or the record raced ahead of the last batch).
        # A re-attached leg additionally skips its pre-takeover cursor.
        start = max(len(self.generated), self._skip)
        self.generated = tokens
        self.queue_wait_s = float(rec.get("queue_wait_s", 0.0))
        self.evictions = int(rec.get("evictions", 0))
        cb = self.on_token
        if cb is not None:
            # replay emitted tokens even on a retryable failure: the
            # router's re-dispatch carries the continuation prompt from
            # fr.generated, which only this callback populates — a
            # drained engine's 30 emitted tokens must not be recomputed
            # (final=True only on a clean finish)
            for i in range(start, len(tokens)):
                try:
                    cb(self, tokens[i],
                       err is None and i == len(tokens) - 1)
                except Exception:
                    pass
        if err is not None:
            cls = _ERRORS.get(err.get("type"), RuntimeError)
            self.error = cls(err.get("msg", "remote engine error"))
            self.state = "failed"
        else:
            self.state = "finished"
        done = self.on_done
        if done is not None:
            try:
                done(self)
            except Exception:
                pass


class RemoteEngineHandle:
    """Router-side handle to one store-served engine process.

    ``store_factory`` builds a fresh store client per internal thread
    (the native client is not shared across threads). Health/load come
    from the registry heartbeat — a dead engine process shows up as a
    stale beat, and its in-flight legs fail by client timeout, which the
    router re-dispatches."""

    remote = True
    engine = None

    def __init__(self, store_factory, engine_id, job="fleet",
                 registry=None, role="any", poll_s=0.04,
                 record_ttl=0.2, defer_poll=False):
        self.engine_id = str(engine_id)
        self.role = role
        self.job = job
        self.registry = registry
        self.forced_down = False
        self.pending = 0                # router-side in-flight count
        self._rec_cache = (0.0, None)   # (fetched_at, record)
        self._rec_ttl = float(record_ttl)
        self._prefix = keyspace.fleet_engine_rpc(job, self.engine_id)
        self._stream_prefix = keyspace.fleet_engine_stream(
            job, self.engine_id)
        self._submit_store = store_factory()
        self._poll_store = store_factory()
        self._poll_s = float(poll_s)
        self._pending = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll_loop,
                                        daemon=True,
                                        name=f"fleet-remote-{engine_id}")
        # a takeover must ``attach()`` every adopted rid
        # BEFORE the poller replays the stream/out history — a poller
        # racing ahead drops the early stream records (rid unknown yet)
        # and the completion's tail replay then double-fires the rest.
        # defer_poll=True holds the replay until start_polling().
        if not defer_poll:
            self._thread.start()

    def start_polling(self):
        """Start the deferred history replay (after takeover attach)."""
        if not self._thread.is_alive():
            try:
                self._thread.start()
            except RuntimeError:
                pass   # already started once

    # ---- router handle surface -----------------------------------------
    def healthy(self):
        if self.forced_down:
            return False
        rec = self._record()
        return rec is not None and rec.get("role") != "gone"

    def load(self):
        rec = self._record() or {}
        return int(rec.get("queue_depth", 0)) \
            + int(rec.get("active_slots", 0))

    def occupancy(self):
        rec = self._record() or {}
        return float(rec.get("kv_occupancy_pct", 0.0))

    def _record(self):
        if self.registry is None:
            return {"role": self.role}
        ts, rec = self._rec_cache
        now = time.monotonic()
        if now - ts < self._rec_ttl:
            return rec
        rec = self.registry.engines().get(self.engine_id)
        self._rec_cache = (now, rec)
        return rec

    def submit(self, leg):
        """Ship one router leg (a GenerationRequest OR a prebuilt
        _RemoteLeg-shaped object) to the engine process."""
        # the wire rid is STABLE per leg object: a retry after a submit
        # timeout re-enqueues the same rid, and the server's finished
        # cache / inflight check dedupes it instead of generating twice
        rid = getattr(leg, "_wire_rid", None)
        if rid is None:
            rid = f"{self.engine_id}-{id(leg)}-{time.monotonic_ns()}"
            leg._wire_rid = rid
        remote = _RemoteLeg(rid, leg.prompt_ids,
                            on_token=leg.on_token, on_done=leg.on_done)
        remote._wire_rid = rid
        remote._handle_id = self.engine_id
        fl = getattr(leg, "_fleet", None)
        remote._fleet = fl
        # re-point the fleet request at the wire-side leg that will
        # actually stream/finish — in the SAME slot the original leg
        # held (a hedge duplicate must never displace the primary)
        if getattr(leg, "_hedge_base", None) is not None:
            remote._hedge_base = leg._hedge_base
            if fl is not None and fl._hedge is leg:
                fl._hedge = remote
        elif fl is not None and fl._leg is leg:
            fl._leg = remote
        msg = {"rid": rid, "prompt": list(leg.prompt_ids),
               "max_new_tokens": leg.max_new_tokens,
               "eos_token_id": leg.eos_token_id,
               "temperature": leg.temperature, "top_k": leg.top_k}
        trace = getattr(leg, "trace", None)
        if trace is not None:
            # the trace context crosses the store-RPC wire: the engine
            # process stamps its spans under the SAME trace id
            remote.trace = trace
            msg["trace"] = trace
        with self._lock:
            self._pending[rid] = remote
        seq = int(self._submit_store.add(f"{self._prefix}/in_seq", 1))
        self._submit_store.set(f"{self._prefix}/in/{seq}",
                               json.dumps(msg))
        return remote

    def attach(self, rid, prompt, on_token=None, on_done=None,
               fleet=None, skip=0):
        """Adopt an in-flight wire leg after a router takeover: register
        the DEPOSED router's wire rid with this handle so
        the poller's history replay (stream from seq 0, then the
        completion) rebuilds the token list — surfacing only tokens
        beyond ``skip``, the ledger's persisted cursor. No store write:
        the engine process never learns the router changed."""
        remote = _RemoteLeg(rid, prompt, on_token=on_token,
                            on_done=on_done, skip=skip)
        remote._handle_id = self.engine_id
        remote._fleet = fleet
        remote._wire_rid = rid
        with self._lock:
            self._pending[rid] = remote
        return remote

    def abort(self, leg):
        """Silently cancel one in-flight leg (hedge loser). Dropping the
        rid from ``_pending`` FIRST makes any late completion or stream
        record for it a no-op — the caller owns the pending decrement
        exactly when this returns True."""
        rid = leg.request_id
        with self._lock:
            if self._pending.pop(rid, None) is None:
                return False   # already completed: on_done owns it
        try:
            seq = int(self._submit_store.add(f"{self._prefix}/in_seq",
                                             1))
            self._submit_store.set(
                f"{self._prefix}/in/{seq}",
                json.dumps({"rid": rid, "abort": True}))
        except Exception:
            pass   # the engine still frees it at completion
        leg.state = "aborted"
        return True

    def start(self):
        pass  # the engine process runs its own serve loop

    def detach(self):
        """Stop this handle's poller WITHOUT stopping the engine
        process: a deposed or retiring router must leave the fleet
        running for whoever routes next."""
        self._stop.set()

    def close(self):
        self._stop.set()
        try:
            self._submit_store.set(f"{self._prefix}/stop", b"1")
        except Exception:
            pass

    # ---- completion poller ---------------------------------------------
    def _poll_loop(self):
        consumed = 0
        tok_consumed = 0
        tick = 0
        stale = 0
        while not self._stop.is_set():
            tick += 1
            try:
                # token stream FIRST: within one tick a leg's streamed
                # tokens surface before its completion, so the
                # completion's replay tail is empty in the common case
                thead = int(self._poll_store.add(
                    f"{self._stream_prefix}/tok_seq", 0))
                while tok_consumed < thead:
                    tok_consumed += 1
                    rec = json.loads(self._poll_store.get(
                        f"{self._stream_prefix}/tok/{tok_consumed}",
                        timeout=10))
                    for rid, tokens, fin in rec.get("items", []):
                        with self._lock:
                            leg = self._pending.get(rid)
                        if leg is not None:
                            leg._stream(tokens, fin)
                head = int(self._poll_store.add(
                    f"{self._prefix}/out_seq", 0))
                while consumed < head:
                    consumed += 1
                    rec = json.loads(self._poll_store.get(
                        f"{self._prefix}/out/{consumed}", timeout=10))
                    with self._lock:
                        leg = self._pending.pop(rec.get("rid"), None)
                    if leg is not None:
                        leg._complete(rec)
            except Exception:
                pass  # store hiccup: retry next tick
            # engine-loss sweep: a killed worker process publishes
            # nothing, so its in-flight legs would wait forever — when
            # the registry heartbeat goes stale for several consecutive
            # checks, fail them with the retryable EngineClosed verdict
            # (the router's on_done re-dispatch picks them up)
            if self.registry is not None and tick % 25 == 0 \
                    and self._pending:
                stale = 0 if self.healthy() else stale + 1
                if stale >= 3:
                    stale = 0
                    with self._lock:
                        legs, self._pending = \
                            list(self._pending.values()), {}
                    err = {"type": "EngineClosed",
                           "msg": f"remote engine {self.engine_id} "
                                  "lost (heartbeat stale)"}
                    for leg in legs:
                        leg._complete({"rid": leg.request_id,
                                       "tokens": leg.generated,
                                       "error": err})
            self._stop.wait(self._poll_s)


def main(argv=None):
    """Engine-process entry: build the (seeded, fleet-identical) model,
    serve it over the store, publish labeled metrics."""
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.fleet.remote")
    p.add_argument("--store", required=True, help="host:port")
    p.add_argument("--engine-id", required=True)
    p.add_argument("--job", default="fleet")
    p.add_argument("--role", default="any",
                   choices=["any", "prefill", "decode"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab", type=int, default=4096)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=None)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--page", type=int, default=8)
    p.add_argument("--pool", type=int, default=96)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--share", action="store_true",
                   help="cross-engine prefix-page sharing via the store")
    p.add_argument("--metrics-dir", default=None)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--ttl", type=float, default=5.0)
    p.add_argument("--idle-timeout", type=float, default=300.0)
    p.add_argument("--trace-dir", default=None,
                   help="enable request tracing; export "
                        "trace.<engine-id>.json here")
    p.add_argument("--trace-sample", type=float, default=None,
                   help="tail-sampling keep rate (PADDLE_TPU_TRACE_"
                        "SAMPLE) for uninteresting traces")
    p.add_argument("--trace-slow-ms", type=float, default=None,
                   help="keep traces slower than this e2e threshold")
    p.add_argument("--device", default="cuda",
                   help="the model's and the KV pools' device")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "float16"],
                   help="the model's and the KV pools' dtype")
    args = p.parse_args(argv)

    import torch

    from ...distributed.tcp_store import TCPStore
    from ...models import GPTConfig, GPTForCausalLM
    from ...observability import metrics as obsm
    from ..engine import ServingEngine
    from .page_share import PageShareClient
    from .registry import EngineRegistry

    host, _, port = args.store.rpartition(":")
    store = TCPStore(host or "127.0.0.1", int(port), is_master=False)
    reg = None
    if args.metrics_dir:
        reg = obsm.enable(out_dir=args.metrics_dir, interval_s=0,
                          rank=args.rank)
    tracing = None
    if args.trace_dir:
        # sampling knobs must be in the environment BEFORE start(): the
        # buffer resolves them once, at construction
        if args.trace_sample is not None:
            os.environ["PADDLE_TPU_TRACE_SAMPLE"] = \
                str(args.trace_sample)
        if args.trace_slow_ms is not None:
            os.environ["PADDLE_TPU_TRACE_SLOW_MS"] = \
                str(args.trace_slow_ms)
        from ...observability import tracing
        tracing.start(path=os.path.join(
            args.trace_dir, f"trace.{args.engine_id}.json"),
            rank=args.rank)

    cfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                    num_layers=args.layers, num_heads=args.heads,
                    num_kv_heads=args.kv_heads, max_seq_len=args.seq,
                    dropout=0.0)
    model = GPTForCausalLM(cfg, device=args.device,
                           dtype=getattr(torch, args.dtype),
                           seed=args.seed)
    model.eval()
    share = None
    if args.share:
        share = PageShareClient(TCPStore(host or "127.0.0.1", int(port)),
                                args.engine_id, job=args.job)
    eng = ServingEngine(model, page_size=args.page, num_pages=args.pool,
                        max_slots=args.slots, prefill_chunk=args.chunk,
                        engine_id=args.engine_id, page_share=share,
                        registry=reg)
    eng.warm_ragged()
    eng.generate([1, 2, 3], max_new_tokens=2)  # warm the short tail too
    eng.start()

    registry = EngineRegistry(TCPStore(host or "127.0.0.1", int(port)),
                              job=args.job, ttl=args.ttl)
    registry.register(args.engine_id, engine=eng, role=args.role)
    print(f"[fleet] engine {args.engine_id} serving "
          f"(job={args.job}, role={args.role})", flush=True)
    try:
        serve_over_store(eng, store, args.engine_id, job=args.job,
                         registry=registry, role=args.role,
                         idle_timeout=args.idle_timeout)
    finally:
        try:
            eng.shutdown(drain_s=10.0)
        except Exception:
            pass
        registry.publish(args.engine_id, eng, args.role)  # final stats
        registry.close()
        if reg is not None:
            reg.flush()
        if tracing is not None:
            tracing.stop()   # export trace.<engine-id>.json
    print(f"[fleet] engine {args.engine_id} stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
