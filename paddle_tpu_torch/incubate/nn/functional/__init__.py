"""incubate.nn.functional — the fused-op surface
(``paddle_tpu/incubate/nn/functional/__init__.py``; reference:
python/paddle/incubate/nn/functional/).

The kernel-backed ones reach the hand kernels as the JAX ones reach
Pallas: ``fused_rms_norm`` and the plain case of ``fused_layer_norm``
through :mod:`paddle_tpu_torch.incubate`'s (the RMSNorm and LayerNorm
kernels), ``fused_dot_product_attention`` through
``nn.functional.scaled_dot_product_attention`` (the flash kernels where
eligible), ``block_multihead_attention`` onto ``incubate.paged_attention``
(the paged decode kernel). The others compute the JAX package's
composition with torch ops, layouts included (``qkv_weight`` [3, H, D,
E]; ``fused_multi_transformer`` contracts ``"bsd,thed->bsthe"``); JAX's
``gelu`` there is ``jax.nn.gelu``, the tanh form. Dropout draws from the
default generator (``paddle.seed`` seeds it); where the JAX op applies no
dropout (``fused_multi_head_attention``, ``fused_feedforward``,
``fused_multi_transformer``), neither does this one.
"""
from __future__ import annotations

import math

import torch

from ....nn import functional as F

__all__ = ["fused_dropout_add", "fused_matmul_bias", "fused_linear",
           "fused_feedforward", "fused_multi_head_attention",
           "fused_dot_product_attention", "fused_layer_norm",
           "fused_rms_norm", "fused_rotary_position_embedding",
           "block_multihead_attention", "masked_multihead_attention",
           "fused_linear_activation",
           "fused_bias_dropout_residual_layer_norm", "fused_ec_moe",
           "variable_length_memory_efficient_attention",
           "fused_multi_transformer"]


def _act(name):
    """JAX's activations of these ops: ``jax.nn.gelu`` is the tanh form."""
    return {"gelu": lambda a: torch.nn.functional.gelu(a, approximate="tanh"),
            "relu": torch.relu, "none": lambda a: a}[name]


def _ln(a, scale, bias, eps):
    """The inline LayerNorm of the JAX compositions, in ``a``'s type."""
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    out = (a - mu) / torch.sqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def _dropout(a, p, mode):
    """Keep each element with probability ``1 - p``, scaled by ``1 / (1 -
    p)`` under ``upscale_in_train``."""
    keep = torch.rand(a.shape, device=a.device) < 1.0 - p
    if mode == "upscale_in_train":
        a = a / (1.0 - p)
    return torch.where(keep, a, torch.zeros((), dtype=a.dtype,
                                            device=a.device))


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """``dropout(x) + y``; outside training (or at p 0) ``x + y``."""
    if not training or p == 0:
        return x + y
    return _dropout(x, p, mode) + y


def fused_matmul_bias(x, y, bias=None, transpose_x=False,
                      transpose_y=False, name=None):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    return out + bias if bias is not None else out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     residual=None, bias=None, **kwargs):
    """LayerNorm of ``x (+ bias) (+ residual)``; with ``residual`` ->
    ``(out, the summed input)``. The plain case is
    :func:`paddle_tpu_torch.incubate.fused_layer_norm` (the ``layer_norm``
    kernel; of the other keywords it reads ``begin_norm_axis``); the
    other arms are the JAX composition."""
    if residual is None and bias is None:
        from ... import fused_layer_norm as _top
        return _top(x, norm_weight, norm_bias, epsilon,
                    kwargs.get("begin_norm_axis", -1))
    a = x
    if residual is not None:
        a = a + residual
    if bias is not None:
        a = a + bias
    out = _ln(a, norm_weight, norm_bias, epsilon)
    return (out, a) if residual is not None else out


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6, **kwargs):
    """:func:`paddle_tpu_torch.incubate.fused_rms_norm` (the ``rms_norm``
    kernel). ``norm_bias`` is passed on, as the top-level JAX function
    takes it; the JAX alias here drops it."""
    from ... import fused_rms_norm as _top
    return _top(x, norm_weight, norm_bias, epsilon)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    from ... import fused_rotary_position_embedding as _top
    return _top(q, k=k, v=v, sin=sin, cos=cos, position_ids=position_ids,
                use_neox_rotary_style=use_neox_rotary_style)


def fused_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                is_causal=False, training=True, name=None,
                                **kwargs):
    """``nn.functional.scaled_dot_product_attention`` (the flash kernels
    where eligible)."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                          dropout_p=dropout_p,
                                          is_causal=is_causal,
                                          training=training)


def _attention(q, k, v, mask):
    """softmax(q k^T / sqrt(d) + mask) v over [B, H, S, D]."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + mask.to(s.dtype)
    return torch.softmax(s, dim=-1) @ v


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None,
                               dropout_rate=0.0, attn_dropout_rate=0.0,
                               ln_epsilon=1e-5, training=True,
                               num_heads=None, name=None):
    """[pre-LN] -> QKV (``qkv_weight`` [3, H, D, E]) -> attention -> out
    projection -> residual -> [post-LN], without dropout, as the JAX
    composition."""
    res = x
    a = _ln(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon) \
        if pre_layer_norm else x
    _, nh, hd, _ = qkv_weight.shape
    qkv = torch.einsum("bse,thde->bsthd", a, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias[None, None]
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    ctx = _attention(q, k, v, attn_mask).transpose(1, 2)
    out = ctx.reshape(ctx.shape[0], ctx.shape[1], nh * hd) @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    out = res + out
    if not pre_layer_norm:
        out = _ln(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, name=None):
    """residual + [LN] -> linear1 -> activation -> linear2 -> [LN], without
    dropout, as the JAX composition."""
    res = x
    a = _ln(x, ln1_scale, ln1_bias, ln1_epsilon) if pre_layer_norm else x
    h = a @ linear1_weight
    if linear1_bias is not None:
        h = h + linear1_bias
    h = _act(activation)(h) @ linear2_weight
    if linear2_bias is not None:
        h = h + linear2_bias
    out = res + h
    if not pre_layer_norm:
        out = _ln(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets=None, cum_offsets=None,
                              cu_seqlens_q=None, cu_seqlens_k=None,
                              block_tables=None, **kwargs):
    """One decode step over a paged KV cache: ``incubate.paged_attention``
    (the paged decode kernel) with ``qkv`` as the queries [B, H, D],
    ``seq_lens_decoder`` as each row's context length and the pools [P,
    page, KVH, D]. As in JAX (``:253-265``) it only decodes: the encoder
    lengths, ``seq_lens_this_time`` and the offsets are not read."""
    from ... import paged_attention as _paged
    if block_tables is None:
        raise ValueError("block_multihead_attention needs block_tables")
    return _paged(qkv, key_cache, value_cache, block_tables,
                  seq_lens_decoder, **kwargs)


def masked_multihead_attention(x, cache_kv=None, bias=None,
                               src_mask=None, **kwargs):
    """One decode token ``x`` [B, H * D] against ``cache_kv`` [2, B, H, T,
    D] with an additive ``src_mask`` -> [B, H * D]."""
    k, v = cache_kv[0], cache_kv[1]
    B, H, _, D = k.shape
    o = _attention(x.reshape(B, H, 1, D), k, v, src_mask)
    return o.reshape(B, H * D)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """``activation(x @ y + bias)``."""
    return _act(activation)(fused_matmul_bias(x, y, bias, trans_x, trans_y))


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """``LN(residual + dropout(x + bias))``."""
    h = x + bias if bias is not None else x
    if training and dropout_rate > 0:
        h = _dropout(h, dropout_rate, mode)
    return _ln(h + residual, ln_scale, ln_bias, ln_epsilon)


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """Expert-choice MoE: every token through every expert (``bmm0`` [E,
    D, Dff], ``bmm1`` [E, Dff, D]), mixed by the softmax of ``gate`` [B,
    S, E]."""
    h = _act(act_type)(torch.einsum("bsd,edf->besf", x, bmm0_weight)
                       + bmm0_bias[None, :, None, :])
    o = torch.einsum("besf,efd->besd", h, bmm1_weight) \
        + bmm1_bias[None, :, None, :]
    return torch.einsum("besd,bse->bsd", o, torch.softmax(gate, dim=-1))


def variable_length_memory_efficient_attention(
        query, key, value, seq_lens, kv_seq_lens, mask=None, scale=None,
        causal=False, pre_cache_length=0):
    """Attention over [B, H, S, D] with each row's valid query and key
    lengths: invalid keys filled with -1e30, invalid query rows zero."""
    S, Sk = query.shape[2], key.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    s = query @ key.transpose(-1, -2) * sc
    if mask is not None:
        s = s + mask.to(s.dtype)
    kpos = torch.arange(Sk, device=query.device)
    neg = torch.tensor(-1e30, dtype=s.dtype, device=s.device)
    s = torch.where((kpos[None, :] < kv_seq_lens[:, None])[:, None, None, :],
                    s, neg)
    if causal:
        qpos = torch.arange(S, device=query.device)
        s = torch.where(qpos[:, None] >= (kpos - pre_cache_length)[None],
                        s, neg)
    out = torch.softmax(s, dim=-1) @ value
    q_valid = torch.arange(S, device=query.device)[None, :] < seq_lens[:, None]
    return torch.where(q_valid[:, None, :, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, cache_kvs=None, attn_mask=None, dropout_rate=0.0,
        activation="gelu", training=False, mode="upscale_in_train",
        name=None):
    """A stack of pre-LN transformer layers (``qkv_weights[i]`` [3, H, D,
    hidden]) -> the final hidden states, the JAX composition: no dropout
    inside and no cache update."""
    act = _act(activation)
    h = x
    for i in range(len(qkv_weights)):
        inp = _ln(h, ln_scales[i], ln_biases[i], epsilon) \
            if pre_layer_norm else h
        B, S, _ = inp.shape
        nh, hd = qkv_weights[i].shape[1], qkv_weights[i].shape[2]
        qkv = torch.einsum("bsd,thed->bsthe", inp, qkv_weights[i]) \
            + qkv_biases[i][None, None]
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        o = _attention(q, k, v, attn_mask).transpose(1, 2)
        h = h + (o.reshape(B, S, nh * hd) @ linear_weights[i]
                 + linear_biases[i])
        ff_in = _ln(h, ffn_ln_scales[i], ffn_ln_biases[i], epsilon) \
            if pre_layer_norm else h
        h = h + (act(ff_in @ ffn1_weights[i] + ffn1_biases[i])
                 @ ffn2_weights[i] + ffn2_biases[i])
    return h
