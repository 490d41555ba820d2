"""Functional ops of the serving and training paths."""
from __future__ import annotations

import math

import torch

from ..amp import amp_cast
from ..ops.kernels import RMSNormFunction, flash_attention_bshd

__all__ = ["gelu", "dropout", "scaled_dot_product_attention",
           "cross_entropy", "rms_norm"]

NEG_INF = -1e30


def gelu(x, approximate=True):
    """GELU; ``approximate=True`` is the tanh form the GPT MLP uses
    (``jax.nn.gelu(approximate=True)`` in the JAX package); bf16 under
    ``auto_cast`` O2."""
    (x,) = amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


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
    dim that is a multiple of 16 and f32 or bf16 inputs."""
    return (query.device.type == "cuda" and attn_mask is None
            and not (dropout_p > 0 and training) and query.dim() == 4
            and query.shape[-1] <= 128 and query.shape[-1] % 16 == 0
            and query.dtype in (torch.float32, torch.bfloat16))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention on ``[B, S, H, D]`` tensors (paddle's layout). Eligible
    configurations run the flash kernels (:func:`flash_attention_bshd`);
    the others the plain chain of ``common.py:244-268`` in f32 (causal
    ``-1e30`` fill, a boolean mask filled or an additive mask added,
    softmax, dropout on the probabilities from ``generator``), returned in
    the query's type."""
    query, key, value = amp_cast("scaled_dot_product_attention", query, key,
                                 value)
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


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross-entropy with hard labels over the last axis of
    ``input`` (``nn/functional/loss.py:29``), computed in f32: labels equal
    to ``ignore_index`` contribute 0 and, under ``"mean"``, are left out
    of the count; ``reduction`` is ``"mean"``, ``"sum"`` or ``"none"``."""
    (input,) = amp_cast("cross_entropy", input)
    logp = torch.log_softmax(input.float(), dim=-1)
    if label.dim() == logp.dim():
        label = label.squeeze(-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1e-12)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r}: mean, sum or none")


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis (``nn/functional/norm.py:42``): f32
    statistics, output in x's type, in f32 under ``auto_cast``
    (``rms_norm`` is on the black list). Runs
    :class:`~..ops.kernels.RMSNormFunction`: the ``rms_norm`` kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    x, weight = amp_cast("rms_norm", x, weight)
    return RMSNormFunction.apply(x, weight, None, float(epsilon))
