"""Continuous-batching serving engine: one ragged launch per round.

The port of the ragged path of ``paddle_tpu/serving/engine.py``. A
:class:`ServingEngine` wraps the port's ``GPTForCausalLM`` and runs it as a
concurrent serving loop over a paged KV cache on the model's device:

* every scheduler round is ONE flat-token forward: single-token decode
  rows, budgeted prefill chunks (``prefill_chunk`` tokens, at most
  ``prefill_token_budget`` per round) and prefix-hit prompt tails flatten
  into a ``[total_tokens]`` stream with per-row metadata
  (``row_starts``/``row_lens``/``kv_lens``/block tables); the model
  scatters each token's K/V into its page and runs ragged paged attention
  (the hand-written CUDA kernel on the card) in the same forward. Only
  ``total_tokens`` is padded, up the power-of-two schedule of
  :func:`~.ragged_attention.pad_total_tokens`, with the same flat layout
  as the JAX engine token for token;
* **prefix caching** (on by default): full prompt pages are indexed in a
  page-granular trie; a hit takes the shared head by refcounted reference
  and only the tail runs;
* between rounds the :class:`~.scheduler.ContinuousBatchingScheduler`
  finishes / evicts / admits, so a request arriving mid-stream joins the
  next round without stalling in-flight rows.

The host fetches the round's next tokens once per round. The bucketed
fallback, the A/B backend gate, mesh sharding, graceful SIGTERM shutdown,
request tracing and the fleet hooks of the JAX engine are not ported yet.
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from .kv_cache import PagedKVCache, pages_for
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .ragged_attention import pad_total_tokens as _pad_total_tokens
from .scheduler import (ContinuousBatchingScheduler, EngineClosed,
                        GenerationRequest)

__all__ = ["ServingEngine"]


def _select_token(logits_row, req):
    """Host-side sampling for one request: greedy at temperature 0, else
    temperature + optional top-k from the request's own seeded RNG."""
    if req.temperature <= 0.0:
        return int(np.argmax(logits_row))
    z = logits_row.astype(np.float64) / max(req.temperature, 1e-6)
    if req.top_k is not None:
        kth = np.partition(z, -int(req.top_k))[-int(req.top_k)]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(req.rng().choice(len(p), p=p))


class ServingEngine:
    """Continuous-batching inference over a paged KV cache.

    Synchronous use (tests, batch jobs)::

        eng = ServingEngine(model, page_size=16, num_pages=64, max_slots=4)
        tokens = eng.generate([1, 2, 3], max_new_tokens=8)

    Concurrent serving (streaming callbacks + backpressure)::

        with ServingEngine(model, ...) as eng:
            eng.start()
            req = eng.submit(prompt, on_token=lambda r, t, fin: push(t))
            req.result(timeout=30)

    The engine runs where the model lives (``model.device``).
    """

    def __init__(self, model, page_size=16, num_pages=64, max_slots=4,
                 max_queue=256, registry=None, prefill_chunk=None,
                 prefill_token_budget=None, prefix_cache=True,
                 engine_id=None):
        cfg = model.config
        self.model = model
        self.model.eval()
        self.cfg = cfg
        self.device = model.device
        self.engine_id = engine_id
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_pages = pages_for(cfg.max_seq_len, self.page_size)
        H = cfg.num_heads
        KVH = cfg.num_kv_heads
        Dh = cfg.hidden_size // H
        # GQA pools carry only the KV heads
        self.kv = PagedKVCache(cfg.num_layers, int(num_pages),
                               self.page_size, KVH, Dh, dtype=model.dtype,
                               device=self.device)
        self.num_kv_heads = KVH
        self.prefix = PrefixCache(self.kv.allocator, self.page_size) \
            if prefix_cache else None
        self.scheduler = ContinuousBatchingScheduler(
            self.kv.allocator, self.max_slots, self.page_size,
            cfg.max_seq_len, max_queue=max_queue,
            prefix_cache=self.prefix)
        self.metrics = ServingMetrics(registry=registry,
                                      prefix_enabled=self.prefix
                                      is not None, engine=engine_id)
        # chunked prefill: split prompts into prefill_chunk-token chunks
        # and take at most prefill_token_budget chunk-tokens per round, so
        # a long prompt never stalls in-flight decodes
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if prefill_token_budget and self.prefill_chunk is None:
            raise ValueError(
                "prefill_token_budget only bounds CHUNKED prefill — pass "
                "prefill_chunk= as well")
        self._prefill_budget = int(prefill_token_budget) \
            if prefill_token_budget else (self.prefill_chunk or 0)
        self._prefilling: list = []     # FIFO of mid-prefill requests
        self._ragged_shapes: set = set()  # token pads this engine has run
        self._steps = 0
        self._decode_tokens = 0
        self._chunk_tokens = 0
        self.capture_logits = None   # tests: a list collects per-round
        # [max_slots, V] decode logits (forces a host fetch)
        self._peak_occupancy = 0.0
        self._thread = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._closed = False
        self._loop_error = None  # terminal serve-loop crash (unhealthy)
        # serializes scheduler rounds against warm_ragged from another
        # thread; re-entrant so the serve loop's own step nests freely
        self._step_lock = threading.RLock()

    # -------------------------------------------------------- ragged round
    def _ragged_fn(self, tokens, row_starts, row_lens, kv_lens, bt):
        """ONE forward for the whole round: embed the flat token stream
        at per-token positions, scatter every row's K/V into its pages, run
        ragged paged attention, and -> ``(next_tokens [R], row_logits
        [R, V])`` for each row's LAST token (a decode row's next token, a
        completing prefill row's first token; unused rows clip to garbage
        the host ignores). The host metadata moves to the device in one
        copy."""
        T, R = tokens.shape[0], row_starts.shape[0]
        flat = np.concatenate([tokens, row_starts, row_lens, kv_lens,
                               bt.reshape(-1)]).astype(np.int32)
        with torch.no_grad():
            dev = torch.from_numpy(flat).to(self.device)
            tok = dev[:T]
            rs, rl, kl = (dev[T + i * R:T + (i + 1) * R] for i in range(3))
            bt_d = dev[T + 3 * R:].view(R, -1)
            caches = [{"ragged": True, "k_pool": self.kv.k[i],
                       "v_pool": self.kv.v[i], "block_tables": bt_d,
                       "row_starts": rs, "row_lens": rl, "kv_lens": kl}
                      for i in range(self.cfg.num_layers)]
            logits = self.model(tok[None], caches=caches)
            last = (rs + rl - 1).clamp(0, T - 1).long()
            row_logits = logits[0, last]
            nxt = row_logits.argmax(dim=-1)
        return nxt, row_logits

    def warm_ragged(self, max_tokens=None):
        """Run the round once at every token pad up to ``max_tokens``, so
        the first real round of each pad pays no first-launch cost (Triton
        compiles its kernel and the CUDA library loads at first use). The
        default covers the engine's worst-case round: every slot decoding
        plus one prefill budget of chunk tokens when chunking is on, or
        every slot carrying a whole max-length prompt when it is off. The
        warm launches carry zero valid rows: every token is padding, so the
        writes land on the scrap page and no request state is touched.
        -> the list of pads run."""
        if max_tokens is None:
            if self.prefill_chunk is not None:
                rows = max(1, self._prefill_budget // self.prefill_chunk)
                max_tokens = self.max_slots + rows * self.prefill_chunk
            else:
                max_tokens = self.max_slots * self.cfg.max_seq_len
        max_tokens = min(int(max_tokens),
                         self.max_slots * self.cfg.max_seq_len)
        pads, t = [], 1
        while True:
            p = _pad_total_tokens(t)
            pads.append(p)
            if p >= max_tokens:
                break
            t = p + 1
        R = self.max_slots
        with self._step_lock:
            for p in pads:
                if p in self._ragged_shapes:
                    continue
                self._ragged_shapes.add(p)
                self._ragged_fn(np.zeros(p, np.int32),
                                np.full(R, p, np.int32),
                                np.zeros(R, np.int32), np.zeros(R, np.int32),
                                np.zeros((R, self.max_pages), np.int32))
        return pads

    def _step_ragged(self):
        """One ragged scheduler round: admit, grow/evict, then assemble
        decode rows + prefill chunks (budget-bounded FIFO) into ONE flat
        launch. -> decode tokens emitted."""
        admitted = self.scheduler.schedule()
        for req in admitted:
            self.metrics.on_admit(req)
            req.state = "prefilling"
            self._prefilling.append(req)
        _, evicted = self.scheduler.ensure_decode_capacity()
        for req in evicted:
            self.metrics.on_evict(req)
        self._prefilling = [r for r in self._prefilling
                            if r.state == "prefilling"]
        decode_rows = sorted(
            (r for r in self.scheduler.active.values()
             if r.state == "active"), key=lambda r: r.slot)
        # prefill rows: FIFO, at most budget // chunk rows per round each
        # contributing one chunk; unchunked mode takes every pending row's
        # whole remaining tail
        if self.prefill_chunk is not None:
            n_rows = max(1, self._prefill_budget // self.prefill_chunk)
            prefill_rows = self._prefilling[:n_rows]
        else:
            prefill_rows = list(self._prefilling)
        plan = [(req, 1, req.generated[-1:]) for req in decode_rows]
        prompts = {}
        for req in prefill_rows:
            p = req.effective_prompt()
            prompts[req.request_id] = p
            take = len(p) - req.num_cached
            if self.prefill_chunk is not None:
                take = min(take, self.prefill_chunk)
            plan.append((req, take,
                         p[req.num_cached:req.num_cached + take]))
        if not plan:
            return 0
        R, maxp = self.max_slots, self.max_pages
        total = sum(take for _, take, _ in plan)
        T = _pad_total_tokens(total)
        tokens = np.zeros(T, np.int32)
        row_starts = np.full(R, T, np.int32)   # unused rows: sentinel T
        row_lens = np.zeros(R, np.int32)
        kv_lens = np.zeros(R, np.int32)
        bt = np.zeros((R, maxp), np.int32)
        cursor = 0
        for i, (req, take, seg) in enumerate(plan):
            tokens[cursor:cursor + take] = seg
            row_starts[i] = cursor
            row_lens[i] = take
            kv_lens[i] = req.num_cached + take
            bt[i, :len(req.pages)] = req.pages
            cursor += take
        self._ragged_shapes.add(T)
        nxt, row_logits = self._ragged_fn(tokens, row_starts, row_lens,
                                          kv_lens, bt)
        completing = [req for req, take, _ in plan[len(decode_rows):]
                      if req.num_cached + take
                      >= len(prompts[req.request_id])]
        any_sampling = any(r.temperature > 0.0
                           for r in decode_rows + completing)
        # the ONE host fetch of the round: next tokens (plus the logit
        # rows only when sampling or capturing)
        nxt = nxt.tolist()
        logits_np = row_logits.float().cpu().numpy() \
            if (any_sampling or self.capture_logits is not None) else None
        if self.capture_logits is not None and decode_rows:
            cap = np.zeros((self.max_slots,) + logits_np.shape[1:],
                           logits_np.dtype)
            for i, req in enumerate(decode_rows):
                cap[req.slot] = logits_np[i]
            self.capture_logits.append(
                (dict((r.slot, r.request_id) for r in decode_rows), cap))
        # decode rows: account through the scheduler (num_cached advance,
        # emit, finish)
        by_slot = {}
        for i, req in enumerate(decode_rows):
            if req.temperature > 0.0:
                by_slot[req.slot] = _select_token(logits_np[i], req)
            else:
                by_slot[req.slot] = int(nxt[i])
        finished = self.scheduler.complete_step(by_slot)
        for req in decode_rows:
            tt = req.token_times
            self.metrics.on_token(
                req, tt[-1] - tt[-2] if len(tt) >= 2 else None)
        for req in finished:
            self.metrics.on_finish(req)
        # prefill rows: advance the cursor; a row whose prompt completed
        # emits its first token this round and decodes from the next
        spent = 0
        for j, (req, take, _) in enumerate(plan[len(decode_rows):]):
            i = len(decode_rows) + j
            prompt = prompts[req.request_id]
            req.num_cached += take
            spent += take
            if req.num_cached < len(prompt):
                continue
            tok = _select_token(logits_np[i], req) \
                if req.temperature > 0.0 else int(nxt[i])
            self._finish_prompt(req, prompt, tok)
        if spent:
            self._chunk_tokens += spent
            self.metrics.on_prefill_chunk(spent)
        self._decode_tokens += len(by_slot)
        return len(by_slot)

    def _finish_prompt(self, req, prompt, tok):
        """Prompt completion: emit the first generated token (TTFT ends
        here), flip the row to decoding, index the PRE-emit prompt's pages
        for prefix sharing, and finish if the budget is already met.
        ``prompt`` must be the pre-emit prompt: the generated token's KV is
        only written by the next round, so indexing it would publish a page
        with an unwritten slot."""
        first = not req.generated
        req.emit(tok)
        if first:
            self.metrics.on_first_token(req)
        self.metrics.on_token(req)
        req.state = "active"
        if req in self._prefilling:
            self._prefilling.remove(req)
        if self.prefix is not None:
            self.prefix.insert(prompt, req.pages)
        if req.hit_stop():
            self.scheduler.finish(req)
            self.metrics.on_finish(req)

    # ------------------------------------------------------------ stepping
    def step(self):
        """One scheduler round -> decode tokens emitted (0 when idle):
        admission, budgeted prefill chunks and every active row's decode
        token ride ONE flat launch."""
        if self._loop_error is not None:
            raise EngineClosed(
                f"engine unhealthy: serve loop crashed with "
                f"{type(self._loop_error).__name__}: {self._loop_error}"
            ) from self._loop_error
        if self._closed:
            raise EngineClosed("engine is closed")
        with self._step_lock:
            emitted = self._step_ragged()
            occ = self.kv.occupancy_pct()
            self._peak_occupancy = max(self._peak_occupancy, occ)
            alloc = self.kv.allocator
            self.metrics.sample_state(
                len(self.scheduler.active), self.scheduler.queue_depth(),
                occ,
                shared_pages=alloc.shared_pages() if self.prefix else None,
                cached_pages=alloc.cached_pages if self.prefix else None)
            self._steps += 1
            return emitted

    def run_until_idle(self, max_steps=100000):
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"run_until_idle exceeded {max_steps} steps")
        return steps

    # ------------------------------------------------------------- serving
    def submit(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
               temperature=0.0, top_k=None, on_token=None, block=True,
               timeout=10.0):
        """Queue one request (backpressure: blocks up to ``timeout`` for
        queue space, then raises :class:`~.scheduler.QueueFull`)."""
        if self._loop_error is not None or self._closed:
            raise EngineClosed("engine is closed")
        req = GenerationRequest(prompt_ids, max_new_tokens=max_new_tokens,
                                eos_token_id=eos_token_id,
                                temperature=temperature, top_k=top_k,
                                on_token=on_token)
        self.scheduler.submit(req, block=block, timeout=timeout)
        self._wake.set()
        return req

    def generate(self, prompt_ids, timeout=120.0, **kw):
        """Synchronous helper: submit + drive (foreground when no serve
        thread is running) + wait. -> generated token list."""
        req = self.submit(prompt_ids, **kw)
        if self._thread is None:
            self.run_until_idle()
        return req.result(timeout=timeout)

    def start(self):
        """Background serve loop (idempotent)."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="paddle-tpu-torch-serving",
                                        daemon=True)
        self._thread.start()

    def _serve_loop(self):
        while not self._stop_evt.is_set():
            try:
                if self.scheduler.has_work():
                    self.step()
                else:
                    self._wake.wait(0.02)
                    self._wake.clear()
            except Exception as e:
                # a broken round is terminal, not a silent hang: fail every
                # waiter with the actual error and mark the engine
                # unhealthy so later submit()s fail fast
                self._loop_error = e
                self._closed = True
                self.scheduler.close(error=e)
                print(f"[serving] serve loop crashed; engine unhealthy: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
                break

    def stop(self, timeout=10.0):
        self._stop_evt.set()
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    def close(self):
        """Stop the loop and fail everything still queued or in flight."""
        if self._closed:
            return
        self._closed = True
        self.stop()
        self.scheduler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------------- stats
    def stats(self):
        out = {
            "engine_id": self.engine_id,
            "device": str(self.device),
            "steps": self._steps,
            "decode_tokens": self._decode_tokens,
            "evictions": self.scheduler.total_evictions,
            "kv_occupancy_pct": round(self.kv.occupancy_pct(), 2),
            "kv_occupancy_peak_pct": round(self._peak_occupancy, 2),
            "active": len(self.scheduler.active),
            "queued": self.scheduler.queue_depth(),
            "num_kv_heads": self.num_kv_heads,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunk_tokens": self._chunk_tokens,
            "ragged_token_pads": sorted(self._ragged_shapes),
        }
        if self.prefix is not None:
            out.update({
                "prefix_hits": self.prefix.hits,
                "prefix_misses": self.prefix.misses,
                "prefix_hit_rate": round(self.prefix.hit_rate(), 4),
                "prefix_hit_tokens": self.prefix.hit_tokens,
                "prefix_cached_pages": self.kv.allocator.cached_pages,
                "prefix_shared_pages": self.kv.allocator.shared_pages(),
                "prefix_reclaimed_pages": self.prefix.reclaimed_pages,
            })
        return out
