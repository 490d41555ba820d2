"""Seq2Seq Transformer — the encoder-decoder translation model of
``paddle_tpu/models/seq2seq.py``: token embeddings scaled by
``sqrt(d_model)`` plus learned positions around ``nn.Transformer``, and a
Linear head. Training teacher-forces the whole target in one forward;
:meth:`Seq2SeqTransformer.translate` decodes greedily by a host loop that
encodes once and re-runs the decoder over the growing prefix
(``seq2seq.py:76-96``).

The encoder's self-attention and the decoder's cross-attention take no
mask, so they run the flash kernels on the card (the cross-attention with
``Sq`` != ``Sk``); the decoder's self-attention takes the additive causal
mask and the plain chain, as in the JAX model.
"""
from __future__ import annotations

import math

import torch

from .. import nn as pnn
from ..ops.math import add, multiply
from ._seeding import finish_model, init_generator

__all__ = ["Seq2SeqTransformer"]


class Seq2SeqTransformer(pnn.Layer):
    """``Seq2SeqTransformer(src_vocab, tgt_vocab, d_model=128, nhead=4,
    num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=256,
    dropout=0.0, max_len=256, bos_id=0, eos_id=1, device=None,
    dtype=torch.float32, seed=0)``."""

    def __init__(self, src_vocab, tgt_vocab, d_model=128, nhead=4,
                 num_encoder_layers=2, num_decoder_layers=2,
                 dim_feedforward=256, dropout=0.0, max_len=256, bos_id=0,
                 eos_id=1, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.src_emb = pnn.Embedding(src_vocab, d_model, **kw)
        self.tgt_emb = pnn.Embedding(tgt_vocab, d_model, **kw)
        self.pos_emb = pnn.Embedding(max_len, d_model, **kw)
        self.transformer = pnn.Transformer(
            d_model=d_model, nhead=nhead,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=dim_feedforward, dropout=dropout, **kw)
        self.head = pnn.Linear(d_model, tgt_vocab, **kw)
        self.d_model, self.max_len = d_model, max_len
        self.bos_id, self.eos_id = bos_id, eos_id
        finish_model(self, dev, seed)

    def _embed(self, emb, ids):
        s = ids.shape[1]
        if s > self.max_len:
            raise ValueError(f"sequence length {s} exceeds max_len "
                             f"{self.max_len}; rebuild the model with a "
                             f"larger max_len")
        pos = torch.arange(s, device=ids.device)[None, :]
        return add(multiply(emb(ids), float(math.sqrt(self.d_model))),
                   self.pos_emb(pos))

    def _encode(self, src):
        return self.transformer.encoder(self._embed(self.src_emb, src))

    def _decode(self, memory, tgt):
        mask = self.transformer.generate_square_subsequent_mask(
            tgt.shape[1])
        out = self.transformer.decoder(self._embed(self.tgt_emb, tgt),
                                       memory, tgt_mask=mask)
        return self.head(out)

    def forward(self, src, tgt):
        """Teacher-forced logits ``[B, T, tgt_vocab]`` for the target
        prefix ``tgt`` given ``src`` (int token ids ``[B, S]``, ``[B,
        T]``)."""
        return self._decode(self._encode(src), tgt)

    @torch.no_grad()
    def translate(self, src, max_new_tokens=None):
        """Greedy decode: encode once, then run the decoder over the
        growing target prefix until every row has emitted ``eos_id`` or
        the budget (``max_len - 1`` by default) is spent; a finished row
        keeps emitting ``eos_id``. -> ``[B, <= budget]`` token ids."""
        budget = self.max_len - 1 if max_new_tokens is None \
            else max_new_tokens
        b = src.shape[0]
        memory = self._encode(src)
        tgt = torch.full((b, 1), self.bos_id, dtype=torch.long,
                         device=src.device)
        finished = torch.zeros(b, dtype=torch.bool, device=src.device)
        for _ in range(budget):
            nxt = self._decode(memory, tgt)[:, -1].argmax(-1)
            nxt = torch.where(finished, torch.full_like(nxt, self.eos_id),
                              nxt)
            tgt = torch.cat([tgt, nxt[:, None]], dim=1)
            finished |= nxt == self.eos_id
            if bool(finished.all()):
                break
        return tgt[:, 1:]
