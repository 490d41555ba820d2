"""BERT — the encoder of BASELINE config 5, to ``paddle_tpu/models/bert.py``:
:class:`BertConfig`, :func:`bert_base`, :func:`bert_tiny`,
:class:`BertModel`, :class:`BertForSequenceClassification` and
:class:`BertForMaskedLM`.

The encoder is ``nn.TransformerEncoder`` of post-norm GELU layers, so with
no ``attention_mask`` (and no dropout while training) its attention runs
the flash kernels, non-causal; an ``attention_mask`` ([B, S] of 1/0)
becomes the additive ``-1e30`` ``[B, 1, 1, S]`` mask of
``bert.py:81-89`` and takes the plain chain. The embeddings' LayerNorm
has epsilon ``layer_norm_epsilon`` (1e-12) and the MLM head's too; the
encoder layers' norms keep the layer default 1e-5, as in the JAX model.

Models take ``device``, ``dtype`` and ``seed`` (``seed=None`` leaves the
weights uninitialised for a load).
"""
from __future__ import annotations

import torch

from .. import nn as pnn
from ..amp import amp_cast
from ..nn import functional as F
from ..ops.math import add
from ._seeding import finish_model, init_generator

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForMaskedLM", "bert_base", "bert_tiny"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_seq_len=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_epsilon=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    return BertConfig(**{**dict(vocab_size=1024, hidden_size=64,
                                num_layers=2, num_heads=4,
                                intermediate_size=128, max_seq_len=128,
                                dropout=0.0), **kw})


class BertEmbeddings(pnn.Layer):
    def __init__(self, config, **kw):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = pnn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = pnn.Embedding(config.max_seq_len, h, **kw)
        self.token_type_embeddings = pnn.Embedding(config.type_vocab_size,
                                                   h, **kw)
        self.layer_norm = pnn.LayerNorm(h, config.layer_norm_epsilon, **kw)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = add(self.word_embeddings(input_ids),
                  self.position_embeddings(pos[None, :]))
        if token_type_ids is not None:
            emb = add(emb, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


def _additive_mask(attention_mask):
    """[B, S] of 1 (attend) / 0 (padding) -> the f32 ``[B, 1, 1, S]`` mask
    adding 0 or -1e30 to the scores (the ``bert_mask`` op)."""
    m = attention_mask
    if m.is_floating_point():
        (m,) = amp_cast("bert_mask", m)
    return ((1.0 - m.float()) * -1e30)[:, None, None, :]


class BertModel(pnn.Layer):
    """``BertModel(config, device=None, dtype=torch.float32, seed=0)`` ->
    ``(sequence_output [B, S, h], pooled [B, h])``. The heads pass their
    own init ``generator``, so one stream initialises the whole model."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0,
                 generator=None):
        super().__init__()
        dev, gen = init_generator(device, seed)
        if generator is not None:
            gen = generator
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        layer = pnn.TransformerEncoderLayer(
            config.hidden_size, config.num_heads, config.intermediate_size,
            dropout=config.dropout, activation="gelu", **kw)
        self.encoder = pnn.TransformerEncoder(layer, config.num_layers)
        self.pooler = pnn.Linear(config.hidden_size, config.hidden_size, **kw)
        finish_model(self, dev, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None if attention_mask is None else _additive_mask(
            attention_mask)
        seq = self.encoder(x, src_mask=mask)
        return seq, F.tanh(self.pooler(seq[:, 0]))


class BertForSequenceClassification(pnn.Layer):
    def __init__(self, config, num_classes=2, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.config = config
        self.bert = BertModel(config, dev, dtype, seed, generator=gen)
        self.dropout = pnn.Dropout(config.dropout)
        self.classifier = pnn.Linear(config.hidden_size, num_classes, **kw)
        finish_model(self, dev, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForMaskedLM(pnn.Layer):
    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev, gen = init_generator(device, seed)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        h = config.hidden_size
        self.config = config
        self.bert = BertModel(config, dev, dtype, seed, generator=gen)
        self.transform = pnn.Linear(h, h, **kw)
        self.layer_norm = pnn.LayerNorm(h, config.layer_norm_epsilon, **kw)
        self.decoder = pnn.Linear(h, config.vocab_size, **kw)
        finish_model(self, dev, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        return self.decoder(self.layer_norm(F.gelu(self.transform(seq))))
