"""Long-tail functionals (``paddle_tpu/nn/functional/long_tail.py``): the
in-place activations, ``thresholded_relu`` without ``value`` (the one
``nn.functional`` exports), ``local_response_norm``, ``sequence_mask``,
``gather_tree``, the dice, log, N-pair, focal and margin losses,
``class_center_sample`` and ``sparse_attention``.

An in-place activation computes its out-of-place form and writes the
result into ``x`` (``ops/inplace.py``'s ``_write``: ``x.copy_``, which
autograd records); a leaf that requires grad raises, as in JAX. Where
``x`` records a gradient, the out-of-place form runs on a copy of it, so
the value its backward saved is not the one overwritten.
``class_center_sample`` is host work in JAX (``np.unique``, the sampling
from numpy's global generator) and stays host work here;
``sparse_attention`` densifies its CSR pattern on the query's device, so
a staged step copies nothing from the host; ``sequence_mask`` without
``maxlen`` reads the longest length on the host, as JAX does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...device import resolve_device
from ...ops.inplace import _write
from .common import _amp_cast

__all__ = [
    "thresholded_relu", "elu_", "hardtanh_", "leaky_relu_", "softmax_",
    "tanh_", "thresholded_relu_", "local_response_norm", "sequence_mask",
    "gather_tree", "dice_loss", "log_loss", "npair_loss",
    "sigmoid_focal_loss", "margin_cross_entropy", "class_center_sample",
    "sparse_attention",
]

_F = torch.nn.functional


def thresholded_relu(x, threshold=1.0, name=None):
    """``x`` where ``x > threshold``, else 0."""
    (x,) = _amp_cast("thresholded_relu", x)
    return torch.where(x > threshold, x, 0.0)


def _inplace(fn, x, *args):
    return _write(x, fn(x.clone() if x.requires_grad else x, *args))


def elu_(x, alpha=1.0, name=None):
    from .activation import elu
    return _inplace(elu, x, alpha)


def hardtanh_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    from .activation import hardtanh
    return _inplace(hardtanh, x, min, max)


def leaky_relu_(x, negative_slope=0.01, name=None):
    from .activation import leaky_relu
    return _inplace(leaky_relu, x, negative_slope)


def softmax_(x, axis=-1, dtype=None, name=None):
    from .activation import softmax
    return _inplace(softmax, x, axis, dtype)


def tanh_(x, name=None):
    from .activation import tanh
    return _inplace(tanh, x)


def thresholded_relu_(x, threshold=1.0, name=None):
    return _inplace(thresholded_relu, x, threshold)


def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha / size * sum of squares over a window of size
    channels)^beta`` (``long_tail.py:60-82``), channels first."""
    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise ValueError(
            f"local_response_norm supports channels-first formats, got "
            f"{data_format}")
    (x,) = _amp_cast("local_response_norm", x)
    half = size // 2
    sq = x * x
    pads = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = _F.pad(sq, pads)
    acc = sum(padded.narrow(1, i, x.shape[1]) for i in range(size))
    return x / torch.pow(k + alpha / size * acc, beta)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` over ``maxlen`` columns (the longest
    length when None)."""
    from ...core.dtype import convert_dtype
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(None))
    if maxlen is None:
        maxlen = int(x.max())
    dt = convert_dtype(dtype) if not isinstance(dtype, torch.dtype) \
        else dtype
    rng = torch.arange(int(maxlen), device=x.device, dtype=x.dtype)
    return (rng < x[..., None]).to(dt)


def gather_tree(ids, parents):
    """Beam search's backtrace (``long_tail.py:106-126``): from the last
    step back, each slot follows its parent pointer, so every beam reads
    one consistent path. ``ids`` / ``parents`` [T, B, beam]."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device,
                         dtype=ids.dtype).expand(ids.shape[1:])
    out = []
    for t in range(T - 1, -1, -1):
        out.append(ids[t].gather(-1, beams.long()))
        beams = parents[t].gather(-1, beams.long())
    return torch.stack(out[::-1])


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |X ∩ Y| + eps) / (|X| + |Y| + eps)``, mean over the batch;
    ``input`` [N, ..., C] probabilities, ``label`` [N, ..., 1] ids."""
    inp, lab = _amp_cast("dice_loss", input, label)
    oh = _F.one_hot(lab[..., 0].long(), inp.shape[-1]).to(inp.dtype)
    axes = tuple(range(1, inp.dim()))
    inter = (inp * oh).sum(axes)
    union = inp.sum(axes) + oh.sum(axes)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4, name=None):
    inp, lab = _amp_cast("log_loss", input, label)
    return -lab * torch.log(inp + epsilon) \
        - (1 - lab) * torch.log(1 - inp + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Softmax cross-entropy over ``anchor @ positive.T`` with targets
    spread over matching labels, plus ``l2_reg / 4`` of the mean squared
    norms (Sohn 2016)."""
    anc, pos, lab = _amp_cast("npair_loss", anchor, positive, labels)
    l2 = (anc * anc).sum() / anc.shape[0] + (pos * pos).sum() / pos.shape[0]
    sim = anc @ pos.T
    same = (lab[:, None] == lab[None, :]).to(sim.dtype)
    targets = same / torch.clamp_min(same.sum(-1, keepdim=True), 1.0)
    ce = -(targets * torch.log_softmax(sim, -1)).sum(-1).mean()
    return ce + l2_reg * l2 * 0.25


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    """RetinaNet's focal loss, in f32 under ``auto_cast`` (black list)."""
    lg, lab, norm = _amp_cast("sigmoid_focal_loss", logit, label,
                              normalizer)
    p = torch.sigmoid(lg)
    ce = torch.clamp_min(lg, 0) - lg * lab + \
        torch.log1p(torch.exp(-lg.abs()))
    p_t = p * lab + (1 - p) * (1 - lab)
    a_t = alpha * lab + (1 - alpha) * (1 - lab)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if norm is not None:
        loss = loss / norm
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace / CosFace: ``cos(m1 θ + m2) - m3`` on the target's logit,
    then softmax cross-entropy of ``scale`` times the logits
    (``long_tail.py:212-240``; one group, the class axis unsplit)."""
    lg, lab = _amp_cast("margin_cross_entropy", logits, label)
    n = lg.shape[-1]
    cos = torch.clamp(lg, -1.0, 1.0)
    modified = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    oh = _F.one_hot(lab.long(), n).to(lg.dtype)
    logp = torch.log_softmax(scale * (oh * modified + (1 - oh) * cos), -1)
    ce = -(oh * logp).sum(-1, keepdim=True)
    if reduction == "mean":
        ce = ce.mean()
    elif reduction == "sum":
        ce = ce.sum()
    return (ce, torch.exp(logp)) if return_softmax else ce


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampling (``long_tail.py:243-261``), on the host: every
    positive class centre plus negatives drawn by numpy's global
    generator up to ``num_samples``, the labels remapped into the sampled
    indices -> (remapped labels, sampled centres), int64 on the label's
    device."""
    dev = label.device if torch.is_tensor(label) else resolve_device(None)
    lab = label.cpu().numpy() if torch.is_tensor(label) else \
        np.asarray(label)
    pos = np.unique(lab)
    if pos.size >= num_samples:
        sampled = pos
    else:
        neg = np.setdiff1d(np.arange(num_classes), pos, assume_unique=True)
        extra = np.random.permutation(neg)[:num_samples - pos.size]
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = np.full((num_classes,), -1, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (torch.as_tensor(remap[lab], device=dev),
            torch.as_tensor(sampled.astype(np.int64), device=dev))


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over ``[B, H, S, D]`` where only the logits the CSR
    pattern (``offset``, ``columns``; its first row serves all) names
    take part (``long_tail.py:264-286`` over ``sparse/nn/functional.py``'s
    ``attention``): the others, and keys a boolean ``key_padding_mask``
    [B, S] drops, are ``-1e30``; ``attn_mask`` is added."""
    S = query.shape[2]
    dev = query.device
    off = torch.as_tensor(sparse_csr_offset, device=dev)
    col = torch.as_tensor(sparse_csr_columns, device=dev)
    off = off.reshape(-1, off.shape[-1])[0].long()
    col = col.reshape(-1, col.shape[-1])[0].long()
    # entry j lies in row r where off[r] <= j < off[r + 1]; entries outside
    # off[0] .. off[S] belong to no row and add 0
    j = torch.arange(col.numel(), device=dev)
    row = torch.searchsorted(off[:S + 1].contiguous(), j, right=True) - 1
    inside = (row >= 0) & (row < S)
    flat = torch.where(inside, row.clamp(0, S - 1) * S + col, 0)
    keep = torch.zeros(S * S, device=dev).index_add_(
        0, flat, inside.float()).reshape(S, S) != 0
    q, k, v, am = _amp_cast("sparse_attention", query, key, value,
                            attn_mask)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    s = torch.where(keep, s, -1e30)
    if key_padding_mask is not None:
        s = torch.where(key_padding_mask[:, None, None, :].bool(), s, -1e30)
    if am is not None:
        s = s + am.to(s.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
