"""The long tail of functionals (``paddle_tpu/nn/functional/extra.py``):
shape ops and activations, the margin and embedding losses, CTC and
RNN-T, the hierarchical sigmoid, bilinear, the 3-D adaptive pools and
max unpooling. Each is the JAX expression written with torch ops and
cast under ``auto_cast`` by its JAX op name.

* :func:`ctc_loss` and :func:`rnnt_loss` run their dynamic programs in
  log space as a Python loop over time of tensor ops, with no host
  synchronisation, so ``jit.to_static`` captures the whole loop in one
  graph. Both log-softmax in f32, as JAX does, and carry their lattices
  in f64 (below), with JAX's ``-1e30`` for an impossible state,
  and freeze a row's state past its ``input_lengths``. CTC's ``mean``
  divides each loss by its label length before the mean
  (``extra.py:293-296``), as torch's does. RNN-T's inner recurrence over
  the label axis, ``a[u] = logaddexp(fb[u], a[u - 1] + e[u - 1])``, is
  computed in one step as ``C[u] + logcumsumexp(fb - C)[u]`` with ``C``
  the running sum of the emissions: the same sum, in another order. The
  lattice runs in f64 (the gathered terms only), so that order, and the
  device's, do not show in the f32 loss and gradient; CTC's does too.
* :func:`max_unpool2d` (and 1-D, 3-D) scatters each value to its flat
  spatial index; without ``output_size`` the output is ``(in - 1) *
  stride + kernel`` a side, padding ignored, as in JAX. Where two values
  share an index (overlapping pool windows) the later one is written and
  takes the gradient, as JAX's scatter does.
* :func:`thresholded_relu` here takes a ``value``; the one that
  ``nn.functional`` exports is :mod:`.long_tail`'s, which does not, as
  in JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import _amp_cast

__all__ = [
    "channel_shuffle", "maxout", "thresholded_relu", "rrelu", "zeropad2d",
    "pairwise_distance", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "multi_margin_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "soft_margin_loss",
    "gaussian_nll_loss", "ctc_loss", "rnnt_loss", "hsigmoid_loss",
    "bilinear", "adaptive_avg_pool3d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_F = torch.nn.functional
NEG = -1e30


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


# ---------------------------------------------- activations and shapes
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """``groups`` interleaved, in ``NCHW`` or ``NHWC`` (``extra.py:42``)."""
    (x,) = _amp_cast("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)
    raise ValueError(f"data_format {data_format!r}: NCHW or NHWC")


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` along ``axis``."""
    (x,) = _amp_cast("maxout", x)
    ax = axis % x.dim()
    shape = x.shape[:ax] + (x.shape[ax] // groups, groups) + \
        x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    """``x`` where ``x > threshold``, else ``value``."""
    (x,) = _amp_cast("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None,
          *, generator=None):
    """``x`` where ``x >= 0``, else ``slope * x``: in training a slope a
    element drawn from ``U[lower, upper)`` (from ``generator``), else
    their mean (``extra.py:76-90``)."""
    (x,) = _amp_cast("rrelu", x)
    if training:
        slope = (torch.rand(x.shape, device=x.device, generator=generator)
                 * (upper - lower) + lower).to(x.dtype)
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros on the (left, right, top, bottom) of the spatial axes."""
    (x,) = _amp_cast("zeropad2d", x)
    l, r, t, b = (padding if isinstance(padding, (list, tuple))
                  else [padding] * 4)
    if data_format == "NCHW":
        return _F.pad(x, (l, r, t, b))
    return _F.pad(x, (0, 0, l, r, t, b))


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last axis."""
    x, y = _amp_cast("pairwise_distance", x, y)
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b, i] W[o, i, j] x2[b, j] (+ bias[o])``."""
    x1, x2, weight, bias = _amp_cast("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out + bias if bias is not None else out


# ------------------------------------------------------------- losses
def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    x, y = _amp_cast("poisson_nll_loss", input, label)
    loss = torch.exp(x) - y * x if log_input else \
        x - y * torch.log(x + epsilon)
    if full:
        stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    x, y, w = _amp_cast("multi_label_soft_margin_loss", input, label, weight)
    term = y * _F.logsigmoid(x) + (1 - y) * _F.logsigmoid(-x)
    if w is not None:
        term = term * w
    return _reduce(-term.mean(-1), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    x, y = _amp_cast("hinge_embedding_loss", input, label)
    loss = torch.where(y == 1.0, x, torch.clamp_min(margin - x, 0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = _amp_cast("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)
    loss = torch.where(y == 1, 1.0 - cos, torch.clamp_min(cos - margin, 0.0))
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    x, y, w = _amp_cast("multi_margin_loss", input, label, weight)
    n, c = x.shape
    y = y.long()
    xy = x.gather(1, y[:, None])
    m = torch.clamp_min(margin - xy + x, 0.0) ** p
    if w is not None:
        m = m * w[y][:, None]
    m = m * (1 - _F.one_hot(y, c).to(m.dtype))
    return _reduce(m.sum(-1) / c, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = _amp_cast("triplet_margin_loss", input, positive,
                            negative)

    def dist(u, v):
        return torch.linalg.vector_norm(u - v + epsilon, ord=p, dim=-1)

    d_ap, d_an = dist(a, pos), dist(a, neg)
    if swap:
        d_an = torch.minimum(d_an, dist(pos, neg))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative,
                                   margin=margin, swap=swap,
                                   reduction=reduction)
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = torch.minimum(d_an, distance_function(positive, negative))
    d_ap, d_an = _amp_cast("triplet_margin_with_distance_loss", d_ap, d_an)
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    x, y = _amp_cast("soft_margin_loss", input, label)
    return _reduce(torch.log1p(torch.exp(-y * x)), reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    x, y, var = _amp_cast("gaussian_nll_loss", input, label, variance)
    var = torch.clamp_min(var, epsilon)
    loss = 0.5 * (torch.log(var) + (x - y) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def _lengths(t, device):
    return (t if torch.is_tensor(t) else torch.as_tensor(t)).to(device)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC (``extra.py:245-307``): ``log_probs`` [T, B, C] (log-softmaxed
    here, in f32), ``labels`` [B, L]; the alpha recursion over the
    extended labels ``blank, l1, blank, l2, ..., blank`` runs as a loop
    over time."""
    (lp,) = _amp_cast("ctc_loss", log_probs)
    T, B, _ = lp.shape
    dev = lp.device
    lp = torch.log_softmax(lp.float(), -1)
    lab = labels.to(dev).long()
    in_len = _lengths(input_lengths, dev)
    lab_len = _lengths(label_lengths, dev).long()
    S = 2 * lab.shape[1] + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    prev2 = _F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != prev2)
    # the lattice in f64, as rnnt_loss's: the gathered [T, B, S] terms only
    emit = lp.gather(2, ext.unsqueeze(0).expand(T, B, S)).double()
    neg = torch.full((B, S), NEG, dtype=torch.float64, device=dev)
    first = torch.arange(S, device=dev) < 2
    alpha = torch.where(first & ((torch.arange(S, device=dev) == 0)
                                 | (lab_len > 0)[:, None]), emit[0], neg)
    for t in range(1, T):
        a1 = _F.pad(alpha, (1, 0), value=NEG)[:, :S]
        a2 = torch.where(can_skip, _F.pad(alpha, (2, 0), value=NEG)[:, :S],
                         neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + emit[t]
        alpha = torch.where((in_len > t)[:, None], new, alpha)
    last = 2 * lab_len
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    loss = -torch.logaddexp(a_last, torch.where(lab_len > 0, a_prev,
                                                NEG)).float()
    if norm_by_times:
        loss = loss / torch.clamp_min(in_len.float(), 1.0)
    if reduction == "mean":
        return (loss / torch.clamp_min(lab_len.float(), 1.0)).mean()
    return _reduce(loss, reduction)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T (``extra.py:310-376``): ``input`` [B, T, U + 1, V] logits
    (log-softmaxed here, in f32), ``label`` [B, U]; alpha over the (T, U)
    lattice by a loop over time, each step's recurrence over U in one
    ``logcumsumexp`` (the module's doc). ``fastemit_lambda`` is accepted
    and unused, as in JAX."""
    (logits,) = _amp_cast("rnnt_loss", input)
    B, T, U1, _ = logits.shape
    U = U1 - 1
    dev = logits.device
    lp = torch.log_softmax(logits.float(), -1)
    lab = label.to(dev).long()
    in_len = _lengths(input_lengths, dev)
    lab_len = _lengths(label_lengths, dev).long()
    # the lattice sums up to |ll| ~ 900 (T 255) in steps of a few units:
    # in f32 that rounds at ~6e-5, in an order each device picks. It runs
    # in f64 over the gathered [B, T, U + 1] terms, a small fraction of
    # the logits, and the loss returns in f32.
    emit = lp[:, :, :U, :].gather(
        3, lab[:, None, :, None].expand(B, T, U, 1))[..., 0].double()
    blk = lp[..., blank].double()                              # [B, T, U1]
    csum = torch.cat([emit.new_zeros(B, T, 1), emit.cumsum(-1)], -1)
    alpha = torch.where(torch.arange(U1, device=dev)[None, :]
                        <= lab_len[:, None], csum[:, 0], NEG)
    for t in range(1, T):
        fb = alpha + blk[:, t - 1]
        c = csum[:, t]
        new = c + torch.logcumsumexp(fb - c, -1)
        alpha = torch.where((in_len > t)[:, None], new, alpha)
    t_last = torch.clamp_min(in_len - 1, 0).long()
    a_fin = alpha.gather(1, lab_len[:, None])[:, 0]
    blk_fin = blk[torch.arange(B, device=dev), t_last, lab_len]
    return _reduce(-(a_fin + blk_fin), reduction).float()


def _bce_over_path(x, w, b, nodes, bits, valid):
    nodes_c = torch.clamp_min(nodes, 0)
    logits = torch.einsum("bdi,bi->bd", w[nodes_c], x)
    if b is not None:
        logits = logits + b.reshape(-1)[nodes_c]
    bce = torch.clamp_min(logits, 0) - logits * bits.float() + \
        torch.log1p(torch.exp(-logits.abs()))
    return torch.where(valid, bce, 0.0).sum(1, keepdim=True)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid (``extra.py:379-425``): the binary
    cross-entropy of each node on a sample's path, summed -> [B, 1]. The
    default path is the complete binary tree's (node ``(label + C) >> (j
    + 1)) - 1``, bit ``((label + C) >> j) & 1``); ``path_table`` and
    ``path_code`` give custom paths, entries < 0 padding."""
    if (path_table is None) != (path_code is None):
        raise ValueError(
            "hsigmoid_loss: path_table and path_code must be given "
            "together (reference CustomCode needs both)")
    x, weight, bias = _amp_cast("hsigmoid_loss", input, weight, bias)
    if path_table is not None:
        nodes, bits = path_table.long(), path_code.long()
        return _bce_over_path(x, weight, bias, nodes, bits, nodes >= 0)
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    code = label.reshape(-1).long() + num_classes
    js = torch.arange(depth, device=x.device)
    nodes = (code[:, None] >> (js + 1)[None, :]) - 1
    bits = (code[:, None] >> js[None, :]) & 1
    return _bce_over_path(x, weight, bias, nodes, bits, nodes >= 0)


# ------------------------------------------------------------ pooling
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    from .pooling import _adaptive
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    from .pooling import _adaptive
    return _adaptive(x, output_size, 3, "max", "NCDHW", return_mask)


def _max_unpool(x, indices, nd, kernel_size, stride, output_size):
    ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
        else [kernel_size] * nd
    st = stride if stride is not None else ks
    st = list(st) if isinstance(st, (list, tuple)) else [st] * nd
    (x,) = _amp_cast(f"max_unpool{nd}d", x)
    n, c = x.shape[:2]
    if output_size is not None:
        out_sp = tuple(int(v) for v in list(output_size)[-nd:])
    else:
        out_sp = tuple((x.shape[2 + d] - 1) * st[d] + ks[d]
                       for d in range(nd))
    idx = indices.reshape(n, c, -1).long()
    pos = torch.arange(idx.shape[-1], device=x.device).expand_as(idx)
    last = torch.full((n, c, math.prod(out_sp)), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(2, idx, pos, "amax")
    winner = last.gather(2, idx) == pos
    out = x.new_zeros(n, c, math.prod(out_sp)).scatter_add(
        2, idx, torch.where(winner, x.reshape(n, c, -1), 0.0))
    return out.reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, output_size)
