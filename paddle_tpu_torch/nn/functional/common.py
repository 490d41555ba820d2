"""Linear, embedding, dropout and attention
(``paddle_tpu/nn/functional/common.py``); the losses are in :mod:`.loss`.

* :func:`linear` keeps Paddle's ``[in, out]`` weight layout, ``x @ W +
  b``: a plain ``torch.addmm`` / ``torch.matmul`` (the JAX package leaves
  these products to XLA outside any Pallas kernel); under ``auto_cast``
  O1 it computes in the AMP dtype (``linear`` is on the white list).
* :func:`embedding` is a row gather of the ``[num, dim]`` table (cast as
  ``embedding`` says under ``auto_cast``); ids equal to ``padding_idx``
  give zero rows, so the padding row gets no gradient.
* :func:`dropout` keeps each element (or, with ``axis``, each slice along
  those axes, its mask shared along the others) with probability ``1 -
  p``; its mask draws from ``generator``, a keyword-only extra of the
  port (the default generator when None, which ``paddle.seed`` seeds).
"""
from __future__ import annotations

import math
import sys

import torch

from ...ops.kernels import flash_attention_bshd

__all__ = ["linear", "embedding", "dropout", "scaled_dot_product_attention",
           "NEG_INF"]

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


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``
    (``common.py:27``)."""
    x, w, b = _amp_cast("linear", x, weight, bias)
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.addmm(b, x2, w) if b is not None else torch.matmul(x2, w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """The rows of ``weight`` at the ids ``x`` (``common.py:122-131``);
    where an id equals ``padding_idx`` the row is zero and passes no
    gradient. ``sparse`` is accepted, as in JAX: the gradient is dense."""
    (w,) = _amp_cast("embedding", weight)
    out = w[x.long()]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout as ``common.py:42-63``: in training each element is kept
    with probability ``1 - p``, and scaled by ``1 / (1 - p)`` under
    ``mode="upscale_in_train"``; with ``axis`` (an int or a list) the keep
    mask has the input's size on those axes and 1 on the others, so it is
    shared along them. Outside training ``upscale_in_train`` is the
    identity and ``downscale_in_infer`` scales by ``1 - p``."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}: upscale_in_train or "
                         f"downscale_in_infer")
    if p == 0.0 or (not training and mode == "upscale_in_train"):
        return x
    if not training:
        return x * (1.0 - p)
    if p == 1.0:
        return x * 0
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        if min(axes) < 0 or max(axes) >= x.dim():
            raise ValueError(f"dropout axis {axis} out of range for a "
                             f"{x.dim()}-d input")
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device, generator=generator) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0)


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
                                 training=True, name=None, *,
                                 generator=None):
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
    probs = dropout(probs, dropout_p, training=training,
                    generator=generator)
    return (probs @ vt).transpose(1, 2).to(query.dtype)
