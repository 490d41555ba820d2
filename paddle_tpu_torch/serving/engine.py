"""Continuous-batching serving engine over a paged KV cache.

The port of ``paddle_tpu/serving/engine.py``. A :class:`ServingEngine`
wraps the port's ``GPTForCausalLM`` and runs it as a concurrent serving
loop over a paged KV cache on the model's device:

* **ragged serving (default)** — every scheduler round is ONE flat-token
  forward: single-token decode rows, budgeted prefill chunks
  (``prefill_chunk`` tokens, at most ``prefill_token_budget`` per round)
  and prefix-hit prompt tails flatten into a ``[total_tokens]`` stream
  with per-row metadata (``row_starts``/``row_lens``/``kv_lens``/block
  tables); the model scatters each token's K/V into its page and runs
  ragged paged attention (the hand-written CUDA kernel on the card) in
  the same forward. Only ``total_tokens`` is padded, up the power-of-two
  schedule of :func:`~.ragged_attention.pad_total_tokens`, with the same
  flat layout as the JAX engine token for token.
* **the bucketed fallback** (``ragged=False``, or
  ``PADDLE_TPU_SERVING_RAGGED`` set to ``0``, ``false`` or ``off`` when
  ``ragged`` is left None) keeps the JAX engine's pre-ragged shape: newly
  admitted misses run the dense causal forward at a (batch, seq) bucket
  (:func:`~..inference.pick_bucket`; the flash forward kernel on the
  card), which writes each row's K/V into its pages and takes the head
  on each row's last token only; prefix-hit tails and chunked prefill
  (``prefill_chunk``) run the chunk step (pool scatter, then
  partial-prefix attention over the pages); then ONE fixed-shape decode
  step over all ``max_slots`` slots runs the paged decode kernel.
* **one program per shape** (``jit=True``, the default, as in JAX): the
  ragged round at each token pad, and the bucketed engine's dense prefill
  and chunk step at each (batch, seq) bucket and its decode step, each run
  as a program of their own (:mod:`.compiled`), under the JAX engine's
  keys (``("ragged", T)``, ``("prefill", nb, sb)``, ``("chunk", nb,
  sb)``, ``("decode",)``). On the card that program is a CUDA graph,
  captured at the shape's first round (or by
  :meth:`ServingEngine.warm_ragged`), as ``jax.jit`` compiles at the
  first call, and replayed on every later round of that shape: one copy
  of the round's metadata from pinned memory, one replay of the hand
  kernels, one asynchronous copy of the results back. On the CPU the same
  static-buffer round runs eagerly. ``jit=False`` runs every round eagerly
  from Python. Every program is noted once in
  ``stats()["distinct_programs"]`` and the ``serving_compiles_total`` /
  ``serving_distinct_programs`` metrics.
* **prefix caching** (on by default): full prompt pages are indexed in a
  page-granular trie; a hit takes the shared head by refcounted reference
  and only the tail runs;
* between rounds the :class:`~.scheduler.ContinuousBatchingScheduler`
  finishes / evicts / admits, so a request arriving mid-stream joins the
  next round without stalling in-flight rows.

Each round's results reach the host in one copy: the next tokens, or the
logit rows when a request samples or ``capture_logits`` is set. The A/B
backend gate (the kernels always run on the card), mesh sharding,
graceful SIGTERM shutdown, request tracing, the fleet hooks and the
metrics JSONL writer of the JAX engine are not ported yet.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import torch

from ..inference import pick_bucket
from ..ops.kernels.paged_attention import \
    reserve_scratch as _reserve_paged_scratch
from ..ops.kernels.ragged_attention import \
    reserve_scratch as _reserve_ragged_scratch
from ..ops.kernels.ragged_attention import \
    scratch_sizes as _ragged_scratch_sizes
from .compiled import RoundPrograms
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


def _fetch(nxt, rows, need_rows):
    """A launch's one host copy -> ``(next tokens, logit rows or None)``:
    the f32 logit rows when a request samples or logits are captured (the
    greedy tokens are then their argmax on the host), else only the
    device's argmax tokens."""
    if need_rows:
        logits_np = rows.float().cpu().numpy()
        return logits_np.argmax(axis=-1).tolist(), logits_np
    return nxt.tolist(), None


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

    The engine runs where the model lives (``model.device``);
    ``ragged=False`` selects the bucketed fallback (``ragged=None`` reads
    ``PADDLE_TPU_SERVING_RAGGED``, ragged unless it is ``0``, ``false`` or
    ``off``), ``jit=False`` eager rounds instead of one program (a CUDA
    graph on the card) per shape.
    """

    def __init__(self, model, page_size=16, num_pages=64, max_slots=4,
                 max_queue=256, prefill_seq_buckets=None,
                 prefill_batch_buckets=None, jit=True, registry=None,
                 prefill_chunk=None, prefill_token_budget=None,
                 prefix_cache=True, ragged=None, engine_id=None):
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
        # bucketed fallback: seq buckets cap padding waste at ~2x, batch
        # buckets keep the set of prefill launch shapes small
        if prefill_seq_buckets is None:
            prefill_seq_buckets, b = [], 16
            while b < cfg.max_seq_len:
                prefill_seq_buckets.append(b)
                b *= 2
            prefill_seq_buckets.append(cfg.max_seq_len)
        self.prefill_seq_buckets = sorted(set(prefill_seq_buckets))
        self.prefill_batch_buckets = sorted(set(
            prefill_batch_buckets or [1, 2, 4, self.max_slots]))
        # chunk-step shapes: partial tail chunks bucket to powers of two
        # below the chunk size (or the prefill seq buckets when chunking
        # is off and only prefix-hit tails take the chunk step)
        if self.prefill_chunk:
            cb, b = {self.prefill_chunk}, 8
            while b < self.prefill_chunk:
                cb.add(b)
                b *= 2
            self._chunk_buckets = sorted(cb)
        else:
            self._chunk_buckets = list(self.prefill_seq_buckets)
        if ragged is None:
            ragged = os.environ.get("PADDLE_TPU_SERVING_RAGGED",
                                    "1") not in ("0", "false", "off")
        self.ragged = bool(ragged)
        self._ragged_shapes: set = set()  # token pads this engine has run
        # every shape-specialised program installed (ragged pad,
        # prefill/chunk bucket pair, the decode step), under the JAX
        # engine's keys; the round programs and their graphs
        self._jit = bool(jit)
        self._programs: set = set()
        self._rounds = RoundPrograms(self.device)
        # split scratch the attention kernel's graphs point into: owned
        # here, reserved once at the largest plan of any round this
        # engine can run, never reallocated
        self._split_scratch = None
        if self.device.type == "cuda":
            self._split_scratch = _reserve_ragged_scratch(
                self.ragged_scratch_sizes(), self.device) if self.ragged \
                else _reserve_paged_scratch(self.max_slots, H, KVH, Dh,
                                            self.max_pages, self.page_size,
                                            self.device)
        # (batch, seq) buckets the dense prefill and the chunk step ran at,
        # and the launches of each bucketed forward
        self._prefill_shapes: set = set()
        self._chunk_shapes: set = set()
        self._bucketed_launches = {"prefill": 0, "chunk": 0, "decode": 0}
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

    def _note_program(self, key):
        """Record the installation of a new shape-specialised program
        (ragged pad, prefill/chunk bucket pair, decode step)."""
        if key in self._programs:
            return
        self._programs.add(key)
        self.metrics.on_compile(len(self._programs))

    def _run_round(self, key, fn, parts, need_rows, jit):
        """One round of ``fn`` (flat int32 metadata on the device -> next
        tokens [R], f32 logit rows [R, V]) over the metadata ``parts`` ->
        ``(next tokens, logit rows or None)`` on the host. With ``jit``
        (default: the engine's) ``key``'s program runs it; else it runs
        eagerly, its metadata copied to the device and its results back
        from pageable memory."""
        if self._jit if jit is None else jit:
            return self._rounds.run(key, fn, parts, need_rows)
        t0 = time.perf_counter()
        flat = np.concatenate([np.ravel(p) for p in parts]).astype(np.int32)
        with torch.no_grad():
            nxt, rows = fn(torch.from_numpy(flat).to(self.device))
        t1 = time.perf_counter()
        out = _fetch(nxt, rows, need_rows)
        host_s = self._rounds.host_s
        host_s["call"] += t1 - t0
        host_s["wait"] += time.perf_counter() - t1
        return out

    # -------------------------------------------------------- ragged round
    def _ragged_forward(self, flat, T):
        """ONE forward for the whole round over its flat metadata ``flat``
        ([T tokens | R row_starts | R row_lens | R kv_lens | R x max_pages
        block table] int32 on the device): embed the flat token stream at
        per-token positions, scatter every row's K/V into its pages, run
        ragged paged attention, and -> ``(next tokens [R], f32 logit rows
        [R, V])`` for each row's LAST token (a decode row's next token, a
        completing prefill row's first token; unused rows clip to garbage
        the host ignores). The head runs on those R rows only."""
        R = self.max_slots
        rs, rl, kl = (flat[T + i * R:T + (i + 1) * R] for i in range(3))
        bt = flat[T + 3 * R:].view(R, -1)
        caches = [{"ragged": True, "k_pool": self.kv.k[i],
                   "v_pool": self.kv.v[i], "block_tables": bt,
                   "row_starts": rs, "row_lens": rl, "kv_lens": kl,
                   "split_scratch": self._split_scratch}
                  for i in range(self.cfg.num_layers)]
        hidden = self.model.gpt(flat[None, :T], caches=caches)
        last = (rs + rl - 1).clamp(0, T - 1).long()
        rows = self.model._head(hidden[0, last])
        return rows.argmax(dim=-1), rows.float()

    def _ragged_fn(self, tokens, row_starts, row_lens, kv_lens, bt,
                   need_rows=False, jit=None):
        """One ragged round over host metadata -> ``(next tokens, f32
        logit rows [R, V] when need_rows else None)``: the token pad's
        program (``jit``, default the engine's) or the eager round."""
        T = tokens.shape[0]
        return self._run_round(
            ("ragged", T), lambda flat: self._ragged_forward(flat, T),
            (tokens, row_starts, row_lens, kv_lens, bt), need_rows, jit)

    def _ragged_pads(self, max_tokens):
        """The token pads of rounds up to ``max_tokens`` tokens."""
        pads, t = [], 1
        while True:
            p = _pad_total_tokens(t)
            pads.append(p)
            if p >= max_tokens:
                return pads
            t = p + 1

    def ragged_scratch_sizes(self):
        """The ragged kernel's split scratch that covers every round this
        engine can run: the largest need (f32 partials, f32 max/sum pairs,
        int32 tickets) over every token pad up to ``max_slots`` whole
        ``max_seq_len`` rows, the most :meth:`warm_ragged` can reach."""
        cfg = self.cfg
        H = cfg.num_heads
        sizes = [_ragged_scratch_sizes(p, H, cfg.num_kv_heads,
                                       cfg.hidden_size // H, self.max_slots,
                                       self.max_pages, self.page_size)
                 for p in self._ragged_pads(self.max_slots
                                            * cfg.max_seq_len)]
        return tuple(max(col) for col in zip(*sizes))

    def warm_ragged(self, max_tokens=None):
        """Install the round's program at every token pad up to
        ``max_tokens`` (on the card: capture its graph and replay it once,
        largest pad first), so the first real round of each pad pays no
        first-launch or capture cost. The default covers the engine's
        worst-case round: every slot decoding plus one prefill budget of
        chunk tokens when chunking is on, or every slot carrying a whole
        max-length prompt when it is off. The warm rounds carry zero valid
        rows: every token is padding, so the writes land on the scrap page
        and no request state is touched. -> the list of pads ([] for the
        bucketed fallback)."""
        if not self.ragged:
            return []
        if max_tokens is None:
            if self.prefill_chunk is not None:
                rows = max(1, self._prefill_budget // self.prefill_chunk)
                max_tokens = self.max_slots + rows * self.prefill_chunk
            else:
                max_tokens = self.max_slots * self.cfg.max_seq_len
        max_tokens = min(int(max_tokens),
                         self.max_slots * self.cfg.max_seq_len)
        pads = self._ragged_pads(max_tokens)
        R = self.max_slots
        with self._step_lock:
            for p in reversed(pads):
                if p in self._ragged_shapes:
                    continue
                self._ragged_shapes.add(p)
                self._note_program(("ragged", p))
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
        if T not in self._ragged_shapes:
            self._ragged_shapes.add(T)
            self._note_program(("ragged", T))
        completing = [req for req, take, _ in plan[len(decode_rows):]
                      if req.num_cached + take
                      >= len(prompts[req.request_id])]
        any_sampling = any(r.temperature > 0.0
                           for r in decode_rows + completing)
        nxt, logits_np = self._ragged_fn(
            tokens, row_starts, row_lens, kv_lens, bt,
            need_rows=any_sampling or self.capture_logits is not None)
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

    # ------------------------------------------------- bucketed fallback
    def _prefill_admitted(self, admitted):
        """Route newly admitted requests to a prefill path: chunked mode
        queues everything on ``_prefilling`` (the chunk step advances it
        ``prefill_token_budget`` tokens per round); unchunked, a prefix hit
        or a prompt longer than the largest seq bucket runs the chunk step
        over its whole tail this round, and a miss runs the dense bucketed
        prefill."""
        dense = []
        for req in admitted:
            self.metrics.on_admit(req)
            if (self.prefill_chunk is not None or req.num_cached > 0
                    or len(req.effective_prompt())
                    > self.prefill_seq_buckets[-1]):
                req.state = "prefilling"
                self._prefilling.append(req)
            else:
                dense.append(req)
        groups = {}
        for req in dense:
            sb = pick_bucket(len(req.effective_prompt()),
                             self.prefill_seq_buckets)
            groups.setdefault(sb, []).append(req)
        step_rows = min(self.max_slots, self.prefill_batch_buckets[-1])
        for sb, reqs in sorted(groups.items()):
            for i in range(0, len(reqs), step_rows):
                self._prefill_batch(reqs[i:i + step_rows], sb)
        if self.prefill_chunk is None:
            # prefix-hit tails finish within the admission round
            while self._prefilling:
                self._run_chunk_batch()

    def _prefill_forward(self, flat, nb, sb):
        """The dense causal forward of one (batch, seq) bucket from its flat
        metadata ([nb x sb token ids | nb lens | nb x P block table] int32
        on the device; pad rows have length 0 and an all-zero table): each
        row's K/V goes into its pages (:meth:`~.kv_cache.PagedKVCache.
        write_prefill_rows`), and the head runs on each row's last prompt
        token only -> (next tokens [nb], f32 logit rows [nb, V]; pad rows'
        are garbage the host ignores)."""
        o = nb * sb
        lens = flat[o:o + nb]
        bt = flat[o + nb:].view(nb, -1)
        caches = [{"k": None, "v": None}
                  for _ in range(self.cfg.num_layers)]
        hidden = self.model.gpt(flat[:o].view(nb, sb), caches=caches)
        for layer, c in enumerate(caches):
            self.kv.write_prefill_rows(layer, c["k"], c["v"], bt, lens)
        last = (lens.long() - 1).clamp_min(0)
        rows = self.model._head(hidden[torch.arange(nb, device=flat.device),
                                       last])
        return rows.argmax(dim=-1), rows.float()

    def _prefill_fn(self, ids, lens, bt, need_rows=False, jit=None):
        """One dense prefill over host metadata (``ids`` [nb, sb], ``lens``
        [nb], ``bt`` [nb, P]) -> ``(next tokens, f32 logit rows [nb, V]
        when need_rows else None)``: the bucket's program (``jit``,
        default the engine's) or the eager round."""
        nb, sb = ids.shape
        return self._run_round(
            ("prefill", nb, sb),
            lambda flat: self._prefill_forward(flat, nb, sb),
            (ids, lens, bt), need_rows, jit)

    def _prefill_batch(self, reqs, seq_bucket):
        """Dense causal forward at [batch bucket, seq bucket]; right
        padding is causal-safe (position i never attends j > i), so each
        row's first ``len`` K/V rows are exact and go into its pages. The
        table is as wide as a row of the bucket can need:
        ``pages_for(seq_bucket + 1)``, as admission allocates for a prompt
        and its first token."""
        nb = pick_bucket(len(reqs), self.prefill_batch_buckets, strict=True)
        width = min(pages_for(seq_bucket + 1, self.page_size),
                    self.max_pages)
        ids = np.zeros((nb, seq_bucket), np.int32)
        lens = np.zeros(nb, np.int32)
        bt = np.zeros((nb, width), np.int32)
        prompts = [req.effective_prompt() for req in reqs]
        for i, (req, p) in enumerate(zip(reqs, prompts)):
            if len(req.pages) > width:
                raise ValueError(
                    f"request {req.request_id} holds {len(req.pages)} "
                    f"pages, more than a {seq_bucket}-token prefill "
                    f"writes ({width})")
            ids[i, :len(p)] = p
            lens[i] = len(p)
            bt[i, :len(req.pages)] = req.pages
        self._prefill_shapes.add((nb, seq_bucket))
        self._note_program(("prefill", nb, seq_bucket))
        self._bucketed_launches["prefill"] += 1
        toks, logits_np = self._prefill_fn(
            ids, lens, bt, need_rows=any(r.temperature > 0.0 for r in reqs))
        for i, req in enumerate(reqs):
            req.num_cached = int(lens[i])
            tok = _select_token(logits_np[i], req) \
                if req.temperature > 0.0 else toks[i]
            self._finish_prompt(req, prompts[i], tok)

    def _paged_caches(self, bt, positions, chunk_lens=None):
        caches = []
        for i in range(self.cfg.num_layers):
            c = {"paged": True, "k_pool": self.kv.k[i],
                 "v_pool": self.kv.v[i], "block_tables": bt,
                 "positions": positions,
                 "split_scratch": self._split_scratch}
            if chunk_lens is not None:
                c["chunk_lens"] = chunk_lens
            caches.append(c)
        return caches

    def _chunk_forward(self, flat, nb, sb):
        """The chunk step at one (batch, chunk) bucket from its flat
        metadata ([nb x sb tokens | nb positions | nb lens | nb x max_pages
        block table] int32 on the device): write each row's ``lens[b]``
        tokens into its pages at ``positions[b]`` onward, then
        partial-prefix attention over the pages -> (next tokens [nb], f32
        logit rows [nb, V] at each row's last chunk token; the head runs
        on those rows only)."""
        o = nb * sb
        pos, ln = flat[o:o + nb], flat[o + nb:o + 2 * nb]
        caches = self._paged_caches(flat[o + 2 * nb:].view(nb, -1), pos, ln)
        hidden = self.model.gpt(flat[:o].view(nb, sb), caches=caches,
                                pos_offset=pos)
        last = (ln.long() - 1).clamp_min(0)
        rows = self.model._head(hidden[torch.arange(nb, device=flat.device),
                                       last])
        return rows.argmax(dim=-1), rows.float()

    def _chunk_fn(self, tokens, positions, lens, bt, need_rows=False,
                  jit=None):
        """One chunk step over host metadata -> ``(next tokens, f32 logit
        rows [nb, V] when need_rows else None)``: the bucket's program
        (``jit``, default the engine's) or the eager round."""
        nb, sb = tokens.shape
        return self._run_round(
            ("chunk", nb, sb), lambda flat: self._chunk_forward(flat, nb, sb),
            (tokens, positions, lens, bt), need_rows, jit)

    def _run_chunk_batch(self):
        """Advance pending prefills by ONE batched chunk launch: up to
        ``budget // chunk`` requests (FIFO) each contribute their next
        chunk. Requests whose prompt completes emit their first token and
        decode from this round on."""
        self._prefilling = [r for r in self._prefilling
                            if r.state == "prefilling"]
        pending = self._prefilling
        if not pending:
            return 0
        cap = self.prefill_chunk
        max_rows = min(self.max_slots, self.prefill_batch_buckets[-1])
        if cap is not None:
            rows = max(1, self._prefill_budget // cap)
            batch = pending[:min(rows, max_rows)]
        else:
            batch = pending[:max_rows]
        longest = max(len(r.effective_prompt()) - r.num_cached
                      for r in batch)
        want = min(cap, longest) if cap is not None else longest
        sb = pick_bucket(want, self._chunk_buckets)
        nb = pick_bucket(len(batch), self.prefill_batch_buckets,
                         strict=True)
        tokens = np.zeros((nb, sb), np.int32)
        positions = np.zeros(nb, np.int32)
        lens = np.zeros(nb, np.int32)
        bt = np.zeros((nb, self.max_pages), np.int32)
        prompts = []
        for i, req in enumerate(batch):
            p = req.effective_prompt()
            prompts.append(p)
            take = len(p) - req.num_cached
            if cap is not None:
                take = min(take, cap)
            take = min(take, sb)
            tokens[i, :take] = p[req.num_cached:req.num_cached + take]
            positions[i] = req.num_cached
            lens[i] = take
            bt[i, :len(req.pages)] = req.pages
        self._chunk_shapes.add((nb, sb))
        self._note_program(("chunk", nb, sb))
        self._bucketed_launches["chunk"] += 1
        toks, logits_np = self._chunk_fn(
            tokens, positions, lens, bt,
            need_rows=any(r.temperature > 0.0 for r in batch))
        spent = 0
        for i, req in enumerate(batch):
            take = int(lens[i])
            req.num_cached += take
            spent += take
            if req.num_cached < len(prompts[i]):
                continue
            tok = _select_token(logits_np[i], req) \
                if req.temperature > 0.0 else toks[i]
            self._finish_prompt(req, prompts[i], tok)
        self._chunk_tokens += spent
        self.metrics.on_prefill_chunk(spent)
        return spent

    def _decode_forward(self, flat):
        """ONE fixed-slot decode step over all ``max_slots`` slots from its
        flat metadata ([S tokens | S positions | S x max_pages block table]
        int32 on the device): embed each slot's last token at its
        position, scatter its K/V into its page, paged attention over its
        block table (the paged decode kernel on the card) -> (next tokens
        [S], f32 logits [S, V]). Inactive slots carry position 0 and an
        all-zero table: their write lands on the scrap page and they
        attend one scrap token."""
        S = self.max_slots
        pos = flat[S:2 * S]
        caches = self._paged_caches(flat[2 * S:].view(S, -1), pos)
        last = self.model(flat[:S, None], caches=caches,
                          pos_offset=pos)[:, -1]
        return last.argmax(dim=-1), last.float()

    def _decode_fn(self, tokens, positions, bt, need_rows=False, jit=None):
        """One decode step over host metadata -> ``(next tokens, f32
        logits [S, V] when need_rows else None)``: the decode program
        (``jit``, default the engine's) or the eager step."""
        return self._run_round(("decode",), self._decode_forward,
                               (tokens, positions, bt), need_rows, jit)

    def _decode_once(self, active):
        self._note_program(("decode",))
        S, maxp = self.max_slots, self.max_pages
        tokens = np.zeros(S, np.int32)
        positions = np.zeros(S, np.int32)
        bt = np.zeros((S, maxp), np.int32)
        for slot, req in active.items():
            tokens[slot] = req.generated[-1]
            positions[slot] = req.num_cached
            bt[slot, :len(req.pages)] = req.pages
        any_sampling = any(r.temperature > 0.0 for r in active.values())
        self._bucketed_launches["decode"] += 1
        nxt, logits_np = self._decode_fn(
            tokens, positions, bt,
            need_rows=any_sampling or self.capture_logits is not None)
        if self.capture_logits is not None:
            self.capture_logits.append(
                (dict((s, r.request_id) for s, r in active.items()),
                 logits_np))
        by_slot = {}
        for slot, req in active.items():
            if req.temperature > 0.0:
                by_slot[slot] = _select_token(logits_np[slot], req)
            else:
                by_slot[slot] = int(nxt[slot])
        finished = self.scheduler.complete_step(by_slot)
        for slot, req in active.items():
            tt = req.token_times
            self.metrics.on_token(
                req, tt[-1] - tt[-2] if len(tt) >= 2 else None)
        for req in finished:
            self.metrics.on_finish(req)
        self._decode_tokens += len(by_slot)
        return len(by_slot)

    def _step_bucketed(self):
        """The bucketed fallback round: dense/chunk prefill launches, then
        ONE fixed-slot decode step."""
        admitted = self.scheduler.schedule()
        if admitted:
            self._prefill_admitted(admitted)
        if self.prefill_chunk is not None and self._prefilling:
            # budgeted interleave: one bounded chunk launch per round
            self._run_chunk_batch()
        _, evicted = self.scheduler.ensure_decode_capacity()
        for req in evicted:
            self.metrics.on_evict(req)
        active = {slot: r for slot, r in self.scheduler.active.items()
                  if r.state == "active"}
        return self._decode_once(active) if active else 0

    # ------------------------------------------------------------ stepping
    def step(self):
        """One scheduler round -> decode tokens emitted (0 when idle).
        Ragged (default): admission, budgeted prefill chunks and every
        active row's decode token ride ONE flat launch. Bucketed fallback:
        dense/chunk prefill launches, then the fixed-slot decode step."""
        if self._loop_error is not None:
            raise EngineClosed(
                f"engine unhealthy: serve loop crashed with "
                f"{type(self._loop_error).__name__}: {self._loop_error}"
            ) from self._loop_error
        if self._closed:
            raise EngineClosed("engine is closed")
        with self._step_lock:
            emitted = self._step_ragged() if self.ragged \
                else self._step_bucketed()
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
        """Stop the loop, fail everything still queued or in flight and
        drop the round programs (their graphs free their memory)."""
        if self._closed:
            return
        self._closed = True
        self.stop()
        self.scheduler.close()
        with self._step_lock:
            self._rounds.clear()

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
            "ragged": self.ragged,
            "ragged_token_pads": sorted(self._ragged_shapes),
            "distinct_programs": len(self._programs),
            "jit": self._jit,
            "graphs": self._rounds.graphs,
            "graph_capture_s": self._rounds.capture_s,
            "round_host_s": dict(self._rounds.host_s),
            "prefill_shapes": sorted(self._prefill_shapes),
            "chunk_shapes": sorted(self._chunk_shapes),
            "bucketed_launches": dict(self._bucketed_launches),
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
