"""Tensor-parallel (Megatron-style) layers, after
``paddle_tpu/distributed/fleet/mp_layers.py``.

Reference: python/paddle/distributed/fleet/layers/mpu/mp_layers.py
(VocabParallelEmbedding:47, ColumnParallelLinear:333,
RowParallelLinear:540, ParallelCrossEntropy:741) and mp_ops.py (the
``_c_identity`` / ``_c_concat`` / ``_c_split`` / ``_mp_allreduce``
autograd ops).

JAX's layers own the whole logical weight and let GSPMD partition it.
Here a rank is a process (``collective.py``), so each rank **holds its
shard**: the rows or columns of the weight that the model-parallel group
(``mp_group``, default ``fleet.init``'s) gives its rank, and the layers
write the collectives by hand, as Paddle's do, each an autograd function
with its backward:

===================  ======================  ===========================
op                   forward                 backward
===================  ======================  ===========================
``_Identity``        identity                all-reduce of the gradient
``_AllReduce``       all-reduce              identity
``_Concat``          all-gather, last dim    this rank's slice
``_Split``           this rank's slice       all-gather, last dim
===================  ======================  ===========================

A layer built with a generator draws the whole logical weight, with JAX's
initializer, and keeps its slice, so every rank's slices come from one
weight; built uninitialised (a load follows) it makes its slice only.
Each sharded parameter is marked ``is_distributed`` and carries its cut
as ``tp_split = (dim, index)``, which ``convert.params_from_paddle_tpu``
reads to hand a rank its slices of a whole weight. ``state_dict`` holds
the local shapes.

At a group of one rank every layer is its plain counterpart and makes no
collective. ``tp_overlap=True`` (the chunked matmul/collective overlap of
JAX's ``overlap.py``) raises until that module is ported; ``None`` (JAX's
auto, which never serves off the TPU) and ``False`` take the plain path.
"""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import _INIT_GENERATORS, UNINITIALIZED
from .. import collective as _c
from ..topology import get_hybrid_communicate_group

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]

_OVERLAP = ("tp_overlap=True (the chunked matmul/collective overlap) needs "
            "distributed/overlap.py, which is not ported yet (ROADMAP "
            "Queue 1 item 8)")


def _mp_group(mp_group):
    if mp_group is not None:
        return mp_group
    return get_hybrid_communicate_group().get_model_parallel_group()


def _chunk(n_total, group):
    """The contiguous indices of ``group``'s rank among ``n_total`` split
    evenly over the group."""
    n = group.nranks
    if n_total % n:
        raise ValueError(f"{n_total} is not divisible by the "
                         f"model-parallel degree {n}")
    per = n_total // n
    return torch.arange(group.rank * per, (group.rank + 1) * per)


def _shard_parameter(layer, shape, dim, index, attr=None, is_bias=False,
                     default_initializer=None):
    """The slice ``index`` along ``dim`` of the logical parameter ``shape``
    (None when ``attr`` is False): drawn whole and cut, or made at the
    slice's size when the layer is uninitialised."""
    if _INIT_GENERATORS.get(layer) is UNINITIALIZED:
        local = list(shape)
        local[dim] = len(index)
        p = layer.create_parameter(local, attr=attr, is_bias=is_bias,
                                   default_initializer=default_initializer)
    else:
        p = layer.create_parameter(shape, attr=attr, is_bias=is_bias,
                                   default_initializer=default_initializer)
        if p is not None:
            p.data = p.data.index_select(
                dim, index.to(p.device)).contiguous()
    if p is not None:
        p.is_distributed = True
        p.tp_split = (dim, index)
    return p


class _Identity(torch.autograd.Function):
    """``_c_identity``: the input of a column-parallel matmul."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _c.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _AllReduce(torch.autograd.Function):
    """``_mp_allreduce``: the partial sums of a row-parallel matmul."""

    @staticmethod
    def forward(ctx, x, group):
        return _c.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    parts = []
    _c.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _slice_last(x, group):
    per = x.shape[-1] // group.nranks
    return x[..., group.rank * per:(group.rank + 1) * per].contiguous()


class _Concat(torch.autograd.Function):
    """``_c_concat``: every rank's last-dim slice gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.group), None


class _Split(torch.autograd.Function):
    """``_c_split``: this rank's last-dim slice of a replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def copy_in(x, group):
    """``x`` entering a column-parallel matmul: itself forward, its
    gradient all-reduced over ``group`` (``x`` at a group of one)."""
    return x if group.nranks == 1 else _Identity.apply(x, group)


def concat_last(x, group):
    """Every rank's last-dim slice of ``x`` gathered (differentiable; ``x``
    itself at a group of one)."""
    return x if group.nranks == 1 else _Concat.apply(x, group)


class VocabParallelEmbedding(nn.Layer):
    """Reference: mp_layers.py:47 — the vocabulary's rows split over the
    model-parallel group: this rank holds rows ``[r * V / mp, (r + 1) * V
    / mp)``, looks up the ids that fall in them, zeroes the others and
    all-reduces."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._group = _mp_group(mp_group)
        rows = _chunk(num_embeddings, self._group)
        self._vocab_start = int(rows[0]) if len(rows) else 0
        self.weight = _shard_parameter(
            self, [num_embeddings, embedding_dim], 0, rows, weight_attr,
            default_initializer=I.XavierNormal())

    def forward(self, x):
        if self._group.nranks == 1:
            return F.embedding(x, self.weight)
        lo, per = self._vocab_start, self.weight.shape[0]
        outside = (x < lo) | (x >= lo + per)
        local = torch.where(outside, torch.zeros_like(x), x - lo)
        out = F.embedding(local, self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return _AllReduce.apply(out, self._group)


class ColumnParallelLinear(nn.Layer):
    """Reference: mp_layers.py:333 — weight ``[in, out]`` with its output
    columns split over the group (this rank holds ``out / mp`` of them,
    and their bias); ``gather_output`` all-gathers the output, else it
    stays this rank's slice (the input of a :class:`RowParallelLinear`)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, tp_overlap=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if tp_overlap:
            raise NotImplementedError(_OVERLAP)
        self._group = _mp_group(mp_group)
        self._gather_output = gather_output
        cols = self._columns(out_features)
        self.weight = _shard_parameter(
            self, [in_features, out_features], 1, cols, weight_attr)
        has_bias = True if has_bias is None else has_bias
        self.bias = _shard_parameter(self, [out_features], 0, cols,
                                     is_bias=True) if has_bias else None

    def _columns(self, out_features):
        """The output columns this rank holds (a contiguous chunk)."""
        return _chunk(out_features, self._group)

    def forward(self, x):
        g = self._group
        if g.nranks == 1:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(_Identity.apply(x, g), self.weight, self.bias)
        return _Concat.apply(y, g) if self._gather_output else y


class RowParallelLinear(nn.Layer):
    """Reference: mp_layers.py:540 — weight ``[in, out]`` with its input
    rows split over the group; the matmul's partial sums are all-reduced
    and the (whole, replicated) bias is added once, after. An input that
    is not yet parallel (``input_is_parallel=False``) is cut to this
    rank's slice first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 tp_overlap=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if tp_overlap:
            raise NotImplementedError(_OVERLAP)
        self._group = _mp_group(mp_group)
        self._input_is_parallel = input_is_parallel
        rows = _chunk(in_features, self._group)
        self.weight = _shard_parameter(
            self, [in_features, out_features], 0, rows, weight_attr)
        self.bias = self.create_parameter(
            shape=[out_features], attr=None, is_bias=True) \
            if has_bias else None

    def forward(self, x):
        g = self._group
        if g.nranks == 1:
            return F.linear(x, self.weight, self.bias)
        if not self._input_is_parallel:
            x = _Split.apply(x, g)
        y = _AllReduce.apply(F.linear(x, self.weight), g)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class _ParallelCE(torch.autograd.Function):
    """Softmax cross-entropy over class-split logits: the max, the sum of
    exponentials and the label's logit are all-reduced over the group;
    the gradient (softmax minus the one-hot) stays local."""

    @staticmethod
    def forward(ctx, logits, label, group, start, ignore_index):
        x = logits.float()
        m = x.max(dim=-1).values
        _c.all_reduce(m, op=_c.ReduceOp.MAX, group=group)
        z = x - m.unsqueeze(-1)
        e = z.exp()
        s = e.sum(dim=-1)
        _c.all_reduce(s, group=group)
        inside = (label >= start) & (label < start + x.shape[-1])
        idx = torch.where(inside, label - start,
                          torch.zeros_like(label)).long()
        picked = z.gather(-1, idx.unsqueeze(-1)).squeeze(-1) * inside
        _c.all_reduce(picked, group=group)
        valid = label != ignore_index
        loss = torch.where(valid, s.log() - picked, torch.zeros_like(s))
        ctx.save_for_backward(e, s, idx, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside, valid = ctx.saved_tensors
        grad = e / s.unsqueeze(-1)
        grad.scatter_add_(-1, idx.unsqueeze(-1),
                          -inside.to(grad.dtype).unsqueeze(-1))
        grad = grad * (g * valid).unsqueeze(-1)
        return grad.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(nn.Layer):
    """Reference: mp_layers.py:741 — unreduced softmax cross-entropy of
    logits whose class dim is split over the group: ``input`` is this
    rank's slice ``[..., V / mp]`` (classes ``[r * V / mp, (r + 1) * V /
    mp)``), ``label`` the global class ids. Labels equal to
    ``ignore_index`` give 0. f32, as ``F.cross_entropy``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._group = _mp_group(mp_group)
        self._ignore_index = ignore_index

    def forward(self, input, label):
        g = self._group
        if g.nranks == 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self._ignore_index)
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        start = g.rank * input.shape[-1]
        return _ParallelCE.apply(input, label, g, start, self._ignore_index)
