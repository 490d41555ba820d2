"""Greedy decoding over a static KV cache, one CUDA graph a step.

The port of ``GPTForCausalLM._generate_compiled``
(``paddle_tpu/models/gpt.py:633-701``), where the whole decode loop is one
``lax.while_loop`` program. Here the loop's state lives in static device
tensors that a :class:`StaticDecoder` owns, one per ``(batch, total,
dtype)`` on the model's device:

* per layer K and V buffers ``[B, total, KVH, Dh]`` that the static cache
  arm of ``GPTAttention`` writes at the device cursor ``len``;
* ``ids`` ``[B, total]`` (prompt, then generated tokens, zeros after),
  ``nxt`` ``[B, 1]`` (the token the next step feeds), ``finished``
  ``[B, 1]``, the cursors ``cur`` (the column the next token goes to) and
  ``len`` (tokens cached), and ``eos`` (-1 when there is none).

The prefill runs eagerly through the static arm. Then one decode step
(:meth:`StaticDecoder.step`) feeds ``nxt`` at ``len``, takes the argmax,
writes it at column ``cur`` and advances both cursors, all on the device.
On CUDA the step is captured once (``serving/compiled.py``'s
:func:`~..serving.compiled.capture`: its eager warm-up is the loop's first
step) and replayed in blocks; the host reads ``cur`` and ``finished.all()``
once a block through a pinned buffer and an event. A graph has no
``cond``, so the step is a no-op on the device once ``cur`` reaches
``total`` or, with an eos, every row has finished: nothing is written and
no cursor moves. Replays past the point where JAX's ``while_loop`` exits
then leave ``ids`` as JAX leaves it, columns never reached still 0. On
the CPU the same step runs eagerly.
"""
from __future__ import annotations

import time

import torch

from ..serving.compiled import capture, capture_stream

__all__ = ["StaticDecoder", "DecodePrograms", "generate_compiled"]

# steps replayed between two reads of the loop's state
BLOCK = 16


class StaticDecoder:
    """The static buffers of one ``(batch, total)`` decode on ``model``'s
    device and dtype, and on CUDA the graph of its step once captured."""

    def __init__(self, model, batch, total):
        cfg = model.config
        dev, dt = model.device, model.dtype
        self.model = model
        self.total = int(total)
        attn = model.gpt.h[0].attn   # this rank's KV heads
        shape = (batch, self.total, attn.num_kv_heads, attn.head_dim)
        self.k = [torch.zeros(shape, dtype=dt, device=dev)
                  for _ in range(cfg.num_layers)]
        self.v = [torch.zeros(shape, dtype=dt, device=dev)
                  for _ in range(cfg.num_layers)]
        long = dict(dtype=torch.long, device=dev)
        self.ids = torch.zeros(batch, self.total, **long)
        self.nxt = torch.zeros(batch, 1, **long)
        self.finished = torch.zeros(batch, 1, dtype=torch.bool, device=dev)
        self.cur = torch.zeros((), **long)
        self.len = torch.zeros((), **long)
        self.eos = torch.full((), -1, **long)
        cuda = dev.type == "cuda"
        self._flags = torch.zeros(2, dtype=torch.long, pin_memory=cuda)
        self._event = torch.cuda.Event() if cuda else None
        self.captured = None

    def _caches(self):
        return [{"static": True, "k": k, "v": v, "len": self.len}
                for k, v in zip(self.k, self.v)]

    def prefill(self, input_ids, eos):
        """The prompt ``input_ids`` [B, P] through the static arm into
        fresh buffers; its greedy token goes to column ``P`` (clamped to
        the last, as ``dynamic_update_slice`` clamps), ``cur`` to
        ``P + 1``."""
        P = input_ids.shape[1]
        for buf in self.k + self.v:
            buf.zero_()
        self.len.zero_()
        logits = self.model(input_ids, caches=self._caches())
        nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
        self.eos.fill_(eos)
        self.nxt.copy_(nxt)
        self.finished.copy_(nxt == self.eos)
        self.ids.zero_()
        self.ids[:, :P] = input_ids
        col = min(P, self.total - 1)
        self.ids[:, col:col + 1] = nxt
        self.cur.fill_(P + 1)
        self.len.fill_(P)

    def step(self):
        """One greedy step over the static buffers (``body_fn``,
        ``gpt.py:680-693``), with no host read; a no-op once ``cur ==
        total`` or every row has finished (``cond_fn``)."""
        logits = self.model(self.nxt, caches=self._caches(),
                            pos_offset=self.len)
        new = logits[:, -1].argmax(dim=-1, keepdim=True)
        new = torch.where(self.finished, self.eos, new)
        active = (self.cur < self.total) & ~self.finished.all()
        col = self.cur.clamp(max=self.total - 1).view(1)
        self.ids.index_copy_(1, col, torch.where(
            active, new, self.ids.index_select(1, col)))
        self.finished.copy_(self.finished | (active & (new == self.eos)))
        self.nxt.copy_(torch.where(active, new, self.nxt))
        self.cur.add_(active.long())
        self.len.add_(active.long())

    def state(self):
        """``(cur, every row finished)`` on the host: one copy, waited on
        by an event on CUDA."""
        flags = torch.stack([self.cur, self.finished.all().long()])
        self._flags.copy_(flags, non_blocking=True)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        cur, done = self._flags.tolist()
        return cur, bool(done)

    def run(self, input_ids, eos, programs=None):
        """Prefill, then steps until ``cur == total`` or every row has
        finished -> ``ids`` (a copy). With ``programs`` (a
        :class:`DecodePrograms` on CUDA) the step is captured at the first
        call that steps and replayed; without, it runs eagerly."""
        self.prefill(input_ids, eos)
        cur, done = self.state()
        if programs is not None and self.captured is None \
                and cur < self.total and not done:
            t0 = time.perf_counter()
            self.captured = capture(self.step, programs.pool,
                                    programs.stream)
            programs.capture_s += time.perf_counter() - t0
            cur, done = self.state()
        while cur < self.total and not done:
            for _ in range(min(BLOCK, self.total - cur)):
                if programs is not None:
                    self.captured.replay()
                else:
                    self.step()
            cur, done = self.state()
        return self.ids.clone()


class DecodePrograms:
    """A model's static decoders keyed by ``(batch, total, dtype, device)``;
    on CUDA their graphs share one memory pool (the decoders run one at a
    time on one stream) and the device's capture stream. ``capture_s``
    sums the seconds spent warming up and capturing."""

    def __init__(self):
        self._decoders: dict = {}
        self.pool = None
        self.stream = None
        self.capture_s = 0.0

    @property
    def graphs(self):
        return sum(d.captured is not None for d in self._decoders.values())

    def decoder(self, model, batch, total):
        dev = model.device
        key = (batch, total, model.dtype, dev)
        dec = self._decoders.get(key)
        if dec is None:
            dec = self._decoders[key] = StaticDecoder(model, batch, total)
        if dev.type == "cuda" and self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = capture_stream(dev)
        return dec

    def clear(self):
        """Drop every decoder: their buffers and graphs free their
        memory."""
        self._decoders.clear()


def generate_compiled(model, input_ids, max_new_tokens, eos_token_id,
                      replay=None):
    """Greedy decode of ``input_ids`` [B, P] over the static cache ->
    ``[B, P + max_new_tokens]`` in ``input_ids``' type, as JAX's
    ``_generate_compiled`` returns it. ``replay`` (default: on CUDA, for
    a model that is not split over ranks) replays the step's graph;
    ``replay=False`` runs the same step eagerly, as a tensor-parallel
    model's steps run (a gloo collective cannot be captured)."""
    B, P = input_ids.shape
    if replay is None:
        replay = input_ids.device.type == "cuda" and model.mp_degree == 1
    eos = -1 if eos_token_id is None else int(eos_token_id)
    progs = model.decode_programs
    dec = progs.decoder(model, B, P + max_new_tokens)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = dec.run(input_ids, eos, progs if replay else None)
    finally:
        if was_training:
            model.train()
    return out.to(input_ids.dtype)
