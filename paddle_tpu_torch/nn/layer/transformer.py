"""Transformer layers, to ``paddle_tpu/nn/layer/transformer.py:26-238``
(reference: python/paddle/nn/layer/transformer.py).

:class:`MultiHeadAttention` projects to ``[B, S, H, D]`` and calls
:func:`~..functional.scaled_dot_product_attention`, so with no mask and
no dropout while training it runs the flash kernels, non-causal, with
``Sq`` and ``Sk`` free to differ (the decoder's cross-attention); with a
mask it runs the plain chain, as the JAX package does. The encoder and
decoder stacks deep-copy their first layer, as the JAX package does, so
every layer starts from the same weights. Residual adds are the ``add``
op (:func:`~...ops.math.add`), so they cast as ``auto_cast`` says.

Every layer is a :class:`~.layers.Layer` with the JAX package's
arguments; ``weight_attr`` / ``bias_attr`` reach every ``Linear`` of the
layer, as in JAX (``bias_attr=False`` drops their biases), and the
port's ``device``, ``dtype`` and ``generator`` (keyword-only) every
parameter. A deep copy keeps each parameter's attributes
(``core.tensor.Parameter.__deepcopy__``). Attention dropout draws from
``MultiHeadAttention.dropout_generator`` (None: the default generator).
"""
from __future__ import annotations

import copy

import torch

from ...ops.math import add
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer",
           "generate_square_subsequent_mask"]


def _activation_fn(name):
    return {"relu": F.relu, "gelu": F.gelu}[name]


def generate_square_subsequent_mask(length, device=None):
    """The additive causal mask ``[length, length]`` f32: 0 on and below
    the diagonal, -1e9 above (``transformer.py:232-238``)."""
    keep = torch.ones(length, length, dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, -1e9).to(torch.float32)


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not divide into "
                             f"{num_heads} heads")
        if need_weights:
            raise NotImplementedError("need_weights: the attention weights "
                                      "are not returned (nor are they by "
                                      "the JAX package)")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.dropout_generator = None
        kw = dict(device=device, dtype=dtype, generator=generator)
        attrs = (weight_attr, bias_attr)
        self.q_proj = Linear(embed_dim, embed_dim, *attrs, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, *attrs, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, *attrs, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, *attrs, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """-> ``[B, Sq, E]``, or ``(out, (k, v))`` when ``cache`` (the
        previous ``(k, v)`` in ``[B, S, H, D]``) is given: the new keys
        and values are appended along the sequence."""
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(b, sq, *heads)
        k = self.k_proj(key).reshape(b, key.shape[1], *heads)
        v = self.v_proj(value).reshape(b, value.shape[1], *heads)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.dropout_generator)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        return (out, cache) if cache is not None else out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        attn = dict(weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attn)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout = Dropout(act_dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = _activation_fn(activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        return self.norm(out) if self.norm is not None else out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        attn = dict(weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attn)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **attn)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout = Dropout(act_dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = _activation_fn(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        tgt = add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        return self.norm(out) if self.norm is not None else out


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        device = self.parameters()[0].device
        return generate_square_subsequent_mask(length, device)
