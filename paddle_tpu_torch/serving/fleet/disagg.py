"""Prefill/decode disaggregation — KV page migration between engines.

The port of ``paddle_tpu/serving/fleet/disagg.py``. A fleet runs
prefill-designated and decode-designated engines and moves a request's KV
pages from one to the other when its prompt completes; the same
extraction → transfer → ``write_prefill`` → block-table-rebind machinery
doubles as the drain path: draining a live engine migrates its in-flight
requests instead of recomputing them.

One migration is:

1. **extract** — :meth:`ServingEngine.snapshot_kv` gathers the request's
   ``num_cached`` written tokens per layer into host tensors (a read-only
   gather; shared prefix pages keep their other readers);
2. **release** — :meth:`ServingEngine.release_request` frees the source
   slot + pages *without* finishing the request (the same
   ``GenerationRequest`` object moves — its waiters, streaming callbacks
   and timestamps ride along);
3. **adopt** — :meth:`ServingEngine.adopt_request` allocates pages on
   the target, writes the payload into its pools, and joins the decode
   batch directly: the continuation consumes ``generated[-1]`` at
   position ``num_cached``, exactly the round the source would have run
   next, so greedy decode is token-identical across the move;
4. **fallback** — if the target pool/batch is full
   (``OutOfPages``/``OutOfSlots``), the request re-queues at the
   target's front and recomputes its ``effective_prompt()`` on
   admission — the eviction-readmission contract, still
   token-identical.
"""
from __future__ import annotations

import sys
import time

from ...observability import tracing as _trc
from ..kv_cache import OutOfPages
from ..scheduler import EngineClosed, OutOfSlots

__all__ = ["migrate_request", "MigrationFailed"]


class MigrationFailed(RuntimeError):
    """Neither the migrate nor the recompute path could place the request
    on the target engine (it is closed or saturated beyond readmission).
    The caller places it elsewhere."""


def migrate_request(src, dst, req):
    """Move one in-flight request from ``src`` to ``dst``.

    Returns ``"migrated"`` (pages moved), ``"recompute"`` (target had no
    room for a direct adopt; the request re-prefills from the queue) or
    ``"skipped"`` (the request reached a terminal state first). Raises
    :class:`MigrationFailed` when the target cannot take it at all. The
    request object itself moves — callers keep their handle.
    """
    ctx = getattr(req, "trace", None)
    t0 = time.time() if ctx is not None else 0.0
    with src._step_lock:
        if req.state == "migrating":
            # a PRIOR migrate attempt already detached it from the
            # source and then failed on its target — this retry goes
            # straight to placement (the pages are gone; recompute)
            payload = None
        elif req.state not in ("active", "prefilling"):
            return "skipped"
        elif req.state == "prefilling" or req.num_cached == 0:
            # nothing written yet: a recompute on the target is strictly
            # cheaper than moving zero pages
            src.release_request(req)
            payload = None
        else:
            payload = src.snapshot_kv(req)
            src.release_request(req)
        # a migration is ONE prefill->decode (or drain) move: the hook
        # must not re-fire on the target — a recompute-placed request
        # completing its re-prefill on a decode engine would otherwise
        # migrate AGAIN (ping-pong), and two decode engines migrating
        # toward each other would deadlock their serve threads (each
        # holds its own step lock while taking the other's)
        req.migrate_hook = None
    def _span(outcome, tokens):
        if ctx is None:
            return
        now = time.time()
        _trc.req_event(ctx, "kv_migrate", t0, now - t0,
                       args={"outcome": outcome, "tokens": tokens,
                             "src": getattr(src, "engine_id", None),
                             "dst": getattr(dst, "engine_id", None)})
        m = getattr(dst, "metrics", None)
        if m is not None:
            m.on_phase("migrate", now - t0)

    if payload is not None:
        ks, vs, length = payload
        try:
            dst.adopt_request(req, ks, vs, length)
            _span("migrated", int(length))
            return "migrated"
        except (OutOfPages, OutOfSlots):
            pass  # fall through to the recompute queue
        except EngineClosed as e:
            raise MigrationFailed(
                f"target engine refused adoption: {e}") from e
    try:
        dst.readmit_request(req)
        _span("recompute", 0)
        return "recompute"
    except EngineClosed as e:
        raise MigrationFailed(
            f"target engine refused readmission: {e}") from e


def drain_active(src, pick_target, on_moved=None):
    """Migrate every in-flight request off ``src`` (engine drain /
    planned loss): ``pick_target(req)`` names the destination engine per
    request (None = give up on that request). Returns
    ``{request_id: outcome}``; requests that cannot be placed are left to
    the source's own close/shutdown path."""
    out = {}
    for req in list(src.scheduler.active.values()):
        dst = pick_target(req)
        if dst is None:
            continue
        try:
            out[req.request_id] = migrate_request(src, dst, req)
        except MigrationFailed as e:
            print(f"[fleet] migration of request {req.request_id} "
                  f"failed: {e}", file=sys.stderr, flush=True)
            if req.state == "migrating":
                # already detached from the source and NO engine took
                # it: a request in limbo must fail loudly ("tokens or
                # one typed error"), not time out — unless the source
                # can requeue it for its own drain window
                try:
                    src.readmit_request(req)
                    out[req.request_id] = "readmitted_source"
                except Exception:
                    req.finish(e)
                    out[req.request_id] = "failed"
            continue
        if on_moved is not None:
            try:
                on_moved(req, dst, out[req.request_id])
            except Exception:
                pass
    return out
