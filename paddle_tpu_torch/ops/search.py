"""Sorting and searching (``paddle_tpu/ops/search.py``): ``sort`` returns
values, ``topk`` and ``kthvalue`` (values, int64 indices), ``argsort``
int64 indices, a descending one with ties in reverse order (JAX sorts
ascending, stably, and flips). ``nonzero`` reads the count on the host,
so ``jit.to_static`` graph-breaks at it."""
from __future__ import annotations

import torch

from ._common import amp, tensor_of

__all__ = ["sort", "argsort", "topk", "kthvalue", "mode", "nonzero",
           "searchsorted", "bucketize", "index_fill"]


def sort(x, axis=-1, descending=False, stable=False, name=None):
    (x,) = amp("sort", x)
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    out = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(out, (axis,)) if descending else out


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    kk = int(k.item()) if torch.is_tensor(k) else int(k)
    (x,) = amp("topk", x)
    vals, idx = torch.topk(x, kk, dim=-1 if axis is None else axis,
                           largest=largest, sorted=True)
    return vals, idx.to(torch.int64)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index (in the
    stable ascending order)."""
    (x,) = amp("kthvalue", x)
    s, i = torch.sort(x, dim=axis, stable=True)
    vals = s.select(axis, k - 1)
    idx = i.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx.to(torch.int64)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its last occurrence, computed on the device."""
    moved = torch.movedim(x, axis, -1)
    n = moved.shape[-1]
    flat = moved.reshape(-1, n)
    s = torch.sort(flat, dim=-1).values
    new_run = torch.ones_like(s, dtype=torch.bool)
    new_run[:, 1:] = s[:, 1:] != s[:, :-1]
    run = torch.cumsum(new_run.long(), -1) - 1
    counts = torch.zeros_like(run).scatter_add_(1, run, torch.ones_like(run))
    best = counts.argmax(-1, keepdim=True)
    first = torch.where(run == best, torch.arange(n, device=x.device),
                        n).amin(-1, keepdim=True)
    val = s.gather(1, first)
    pos = torch.where(flat == val, torch.arange(n, device=x.device),
                      -1).amax(-1)
    vals = val.reshape(moved.shape[:-1])
    idxs = pos.reshape(moved.shape[:-1])
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs.to(torch.int64)


def nonzero(x, as_tuple=False, name=None):
    """``[N, ndim]`` int64 indices of the nonzero entries, or a tuple of
    ``ndim`` 1-D index tensors."""
    if as_tuple:
        return tuple(t.to(torch.int64) for t in torch.nonzero(
            x, as_tuple=True))
    return torch.nonzero(x).to(torch.int64)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    out = torch.searchsorted(sorted_sequence, values, right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def index_fill(x, index, axis, value, name=None):
    idx = tensor_of(index, x).to(device=x.device, dtype=torch.long)
    (x,) = amp("index_fill", x)
    return torch.index_fill(x, axis, idx, value)
