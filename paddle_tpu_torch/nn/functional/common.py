"""Dropout and attention (``paddle_tpu/nn/functional/common.py``); the
losses are in :mod:`.loss`."""
from __future__ import annotations

import math
import sys

import torch

from ...ops.kernels import flash_attention_bshd

__all__ = ["dropout", "scaled_dot_product_attention", "NEG_INF"]

NEG_INF = -1e30


def _pair(v):
    """An int or a 1- or 2-sequence -> an (H, W) pair of ints."""
    if isinstance(v, (list, tuple)):
        v = tuple(int(x) for x in v)
        return v * 2 if len(v) == 1 else v
    return (int(v),) * 2


def _amp_cast(op_name, *tensors):
    """The package's ``amp_cast`` (``paddle_tpu_torch.nn.functional.
    amp_cast``), read when called: every functional casts through it."""
    return sys.modules[__package__].amp_cast(op_name, *tensors)


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout (``nn/functional/common.py:42``): in
    training each element is kept with probability ``1 - p`` and scaled by
    ``1 / (1 - p)``; the identity when ``p == 0`` or not training. The keep
    mask draws from ``generator`` (the default generator when None)."""
    if p == 0.0 or not training:
        return x
    if p == 1.0:
        return x * 0
    keep = torch.rand(x.shape, device=x.device,
                      generator=generator) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _flash_eligible(query, attn_mask, dropout_p, training):
    """The configurations the flash kernels take (``_flash_eligible``,
    ``nn/functional/common.py:204-226``, without its TPU test and A/B
    gate): a CUDA tensor, no mask, no dropout while training, 4-D input
    and a head dim of at most 128 — and, the kernels' own limits, a head
    dim that is a multiple of 16 and f32, bf16 or f16 inputs."""
    return (query.device.type == "cuda" and attn_mask is None
            and not (dropout_p > 0 and training) and query.dim() == 4
            and query.shape[-1] <= 128 and query.shape[-1] % 16 == 0
            and query.dtype in (torch.float32, torch.bfloat16,
                                torch.float16))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention on ``[B, S, H, D]`` tensors (paddle's layout; ``Sq`` and
    ``Sk`` may differ). Eligible configurations run the flash kernels
    (:func:`flash_attention_bshd`); the others the plain chain of
    ``common.py:244-268`` in f32 (causal ``-1e30`` fill, a boolean mask
    filled or an additive mask added, softmax, dropout on the
    probabilities from ``generator``), returned in the query's type. A
    floating mask is cast with q, k and v under ``auto_cast``, as the JAX
    op's fourth input is."""
    query, key, value, attn_mask = _amp_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    if _flash_eligible(query, attn_mask, dropout_p, training):
        return flash_attention_bshd(query, key, value, causal=is_causal)
    qt, kt, vt = (t.float().transpose(1, 2) for t in (query, key, value))
    scores = qt @ kt.transpose(-1, -2) * (1.0 / math.sqrt(query.shape[-1]))
    if is_causal:
        s, t = scores.shape[-2:]
        causal = torch.ones(s, t, dtype=torch.bool,
                            device=scores.device).tril()
        scores = scores.masked_fill(~causal, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, NEG_INF)
        else:
            scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, dropout_p, training, generator)
    return (probs @ vt).transpose(1, 2).to(query.dtype)
