"""Shape and layout manipulation (``paddle_tpu/ops/manipulation.py``).

``reshape``, ``transpose``, ``squeeze``, slicing and the other ops that
torch computes as views return views here, where JAX returns new arrays:
the values are the same, and an in-place op on such a result writes
through to the tensor it views (the port's rule, ROADMAP Queue 3).
``split`` takes a number of equal sections (not torch's section size) or
a list of sizes that may hold one -1; ``scatter(overwrite=False)`` zeroes
the target rows, then accumulates; ``take_along_axis`` broadcasts the
index; ``nonzero``-like ops whose output shape depends on the data
(``masked_select``, ``unique``) read it on the host, so ``jit.to_static``
graph-breaks at them. The vision zoo's DenseNet, Inception, ShuffleNet and
SqueezeNet blocks join their branches with :func:`concat`.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import convert_dtype, float64
from ._common import (amp, binary_operands, device_scalar, ints,
                      scalar_operand, tensor_of)
from .inplace import _write

__all__ = [
    "cast", "reshape", "reshape_", "transpose", "t", "flatten", "squeeze",
    "unsqueeze", "squeeze_", "unsqueeze_", "concat", "stack", "split",
    "chunk", "unbind", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "broadcast_shape", "flip", "rot90", "roll",
    "moveaxis", "swapaxes", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
    "index_add", "index_put", "masked_select", "masked_fill", "where",
    "take_along_axis", "put_along_axis", "repeat_interleave", "unique",
    "unique_consecutive", "slice", "strided_slice", "crop", "as_complex",
    "as_real", "view", "view_as", "atleast_1d", "atleast_2d", "atleast_3d",
    "tensordot", "tolist", "unstack", "as_strided", "histogramdd",
]


def _axis(axis):
    return int(axis.item()) if torch.is_tensor(axis) else int(axis)


def _idx(index, like):
    """An index (tensor or list) as an int64 tensor on ``like``'s device."""
    return tensor_of(index, like).to(device=like.device, dtype=torch.long)


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def reshape(x, shape, name=None):
    shape = ints(shape)
    (x,) = amp("reshape", x)
    return torch.reshape(x, (shape,) if isinstance(shape, int) else shape)


def reshape_(x, shape, name=None):
    return _write(x, reshape(x, shape))


def transpose(x, perm, name=None):
    (x,) = amp("transpose", x)
    return x.permute(ints(perm))


def t(x, name=None):
    if x.ndim < 2:
        return x.clone()
    return transpose(x, [1, 0])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = amp("flatten", x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def squeeze(x, axis=None, name=None):
    (x,) = amp("squeeze", x)
    if axis is None:
        return torch.squeeze(x)
    ax = ints(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    return torch.squeeze(x, tuple(a for a in ax if x.shape[a] == 1))


def unsqueeze(x, axis, name=None):
    (x,) = amp("unsqueeze", x)
    ax = ints(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    nd = x.ndim + len(ax)
    for a in sorted(a % nd for a in ax):
        x = torch.unsqueeze(x, a)
    return x


def squeeze_(x, axis=None, name=None):
    return _write(x, squeeze(x, axis))


def unsqueeze_(x, axis, name=None):
    return _write(x, unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    """Join the tensors of ``x`` along ``axis`` (an int or a one-element
    tensor)."""
    tensors = amp("concat", *x)
    return torch.cat(tensors, dim=_axis(axis))


def stack(x, axis=0, name=None):
    tensors = amp("stack", *x)
    return torch.stack(tensors, dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """An int is a number of equal sections (the size must divide); a
    list gives each section's size and may hold one -1 (or None)."""
    ax = _axis(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, (int, np.integer)):
        n = int(num_or_sections)
        if dim % n:
            raise ValueError(f"split: dim {ax} (size {dim}) is not "
                             f"divisible into {n} equal sections")
        sizes = [dim // n] * n
    else:
        sizes = [-1 if s in (-1, None) else int(ints(s))
                 for s in num_or_sections]
        known = builtins.sum(s for s in sizes if s >= 0)
        sizes = [s if s >= 0 else dim - known for s in sizes]
    (x,) = amp("split", x)
    return list(torch.split(x, sizes, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    (x,) = amp("unbind", x)
    return list(torch.unbind(x, int(axis)))


def tile(x, repeat_times, name=None):
    reps = ints(repeat_times)
    (x,) = amp("tile", x)
    return torch.tile(x, (reps,) if isinstance(reps, int) else reps)


def expand(x, shape, name=None):
    shape = ints(shape)
    shape = (shape,) if isinstance(shape, int) else shape
    lead = len(shape) - x.ndim
    tgt = tuple(x.shape[i - lead] if s in (-1, None) and i >= lead else s
                for i, s in enumerate(shape))
    (x,) = amp("expand", x)
    return x.expand(tgt)


def expand_as(x, y, name=None):
    (x,) = amp("expand_as", x)
    return x.expand(tuple(y.shape))


def broadcast_to(x, shape, name=None):
    shape = ints(shape)
    (x,) = amp("broadcast_to", x)
    return torch.broadcast_to(x, (shape,) if isinstance(shape, int)
                              else shape)


def broadcast_tensors(inputs, name=None):
    tgt = torch.broadcast_shapes(*(tuple(t.shape) for t in inputs))
    return [broadcast_to(t, tgt) for t in inputs]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def flip(x, axis, name=None):
    ax = ints(axis)
    (x,) = amp("flip", x)
    return torch.flip(x, (ax,) if isinstance(ax, int) else ax)


def rot90(x, k=1, axes=(0, 1), name=None):
    (x,) = amp("rot90", x)
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    sh = ints(shifts)
    (x,) = amp("roll", x)
    if axis is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, ints(axis))


def moveaxis(x, source, destination, name=None):
    (x,) = amp("moveaxis", x)
    return torch.movedim(x, ints(source), ints(destination))


def swapaxes(x, axis0, axis1, name=None):
    (x,) = amp("swapaxes", x)
    return torch.swapaxes(x, axis0, axis1)


def gather(x, index, axis=0, name=None):
    """Rows ``index`` (flattened when it has more than one axis) of ``x``
    along ``axis``."""
    idx = _idx(index, x).reshape(-1)
    (x,) = amp("gather", x)
    return torch.index_select(x, _axis(axis), idx)


def gather_nd(x, index, name=None):
    idx = _idx(index, x)
    (x,) = amp("gather_nd", x)
    return x[tuple(torch.movedim(idx, -1, 0))]


def _rows(index, like):
    idx = _idx(index, like)
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    return idx


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (``overwrite``), or
    zeroed and then accumulated from every update that targets them.
    With ``overwrite`` and duplicate indices, which update wins depends
    on the backend, as in JAX."""
    idx = _rows(index, x)
    x, updates = amp("scatter", x, updates)
    if overwrite:
        return x.index_put((idx,), updates)
    zeroed = x.index_fill(0, idx, 0)
    return zeroed.index_put((idx,), updates, accumulate=True)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _write(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    idx = _idx(index, x)
    x, updates = amp("scatter_nd_add", x, updates)
    return x.index_put(tuple(torch.movedim(idx, -1, 0)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    base = torch.zeros(ints(shape), dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(base, index, updates)


def index_select(x, index, axis=0, name=None):
    idx = _idx(index, x)
    (x,) = amp("index_select", x)
    return torch.index_select(x, int(axis), idx)


def index_sample(x, index, name=None):
    idx = _idx(index, x)
    (x,) = amp("index_sample", x)
    return torch.gather(x, 1, idx)


def index_add(x, index, axis, value, name=None):
    idx = _idx(index, x)
    x, value = amp("index_add", x, value)
    return torch.index_add(x, int(axis), idx, value)


def index_put(x, indices, value, accumulate=False, name=None):
    ix = tuple(_idx(i, x) if not (torch.is_tensor(i) and i.dtype ==
                                  torch.bool) else i for i in indices)
    if torch.is_tensor(value):
        x, value = amp("index_put", x, value)
    else:
        (x,) = amp("index_put", x)
        value = scalar_operand(value, x).to(x.dtype)
    return x.index_put(ix, value.to(x.dtype), accumulate=accumulate)


def masked_select(x, mask, name=None):
    """The elements of ``x`` where ``mask`` (broadcast) holds, flattened:
    the count is read on the host."""
    (x,) = amp("masked_select", x)
    return torch.masked_select(x, mask)


def masked_fill(x, mask, value, name=None):
    if torch.is_tensor(value) and value.ndim:
        x, value = amp("masked_fill", x, value)
        return torch.where(mask, value, x)
    (x,) = amp("masked_fill", x)
    return torch.where(mask, scalar_operand(value, x), x)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with neither, the
    indices of ``condition``'s nonzero entries (a tuple)."""
    if x is None and y is None:
        from .search import nonzero
        return nonzero(condition, as_tuple=True)
    cond = tensor_of(condition)
    if not torch.is_tensor(x) and not torch.is_tensor(y):
        floats = isinstance(x, float) or isinstance(y, float)
        dt = float64 if floats else torch.int64
        return torch.where(cond, device_scalar(x, dt, cond.device),
                           device_scalar(y, dt, cond.device))
    x, y = binary_operands(x, y)
    x, y = amp("where", x, y)
    return torch.where(cond, x, y)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    """Values of ``arr`` at ``indices`` along ``axis``; the other axes of
    the two broadcast against each other (negative indices count from the
    end)."""
    idx = _idx(indices, arr)
    (arr,) = amp("take_along_axis", arr)
    ax = axis % arr.ndim
    n = arr.shape[ax]
    idx = torch.where(idx < 0, idx + n, idx)
    a_shape = list(arr.shape)
    i_shape = list(idx.shape)
    a_shape[ax] = i_shape[ax] = 1
    common = list(torch.broadcast_shapes(tuple(a_shape), tuple(i_shape)))
    a_tgt, i_tgt = list(common), list(common)
    a_tgt[ax], i_tgt[ax] = n, idx.shape[ax]
    return torch.gather(arr.expand(a_tgt), ax, idx.expand(i_tgt))


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   name=None):  # noqa: A002
    """``arr`` with ``values`` (broadcast to ``indices``' shape) put at
    ``indices`` along ``axis``: ``reduce`` is ``"assign"``, ``"add"`` or
    ``"mul"``/``"multiply"``."""
    idx = _idx(indices, arr)
    if torch.is_tensor(values):
        arr, values = amp("put_along_axis", arr, values)
    else:
        (arr,) = amp("put_along_axis", arr)
        values = torch.as_tensor(np.asarray(values), device=arr.device)
    values = torch.broadcast_to(values.to(arr.dtype), idx.shape)
    ax = axis % arr.ndim
    if reduce == "assign":
        return torch.scatter(arr, ax, idx, values)
    if reduce == "add":
        return torch.scatter_add(arr, ax, idx, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(arr, ax, idx, values, "prod")
    raise ValueError(f"unknown reduce {reduce}")


def repeat_interleave(x, repeats, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    (x,) = amp("repeat_interleave", x)
    if torch.is_tensor(repeats):
        return torch.repeat_interleave(x, repeats.to(x.device), dim=axis)
    return torch.repeat_interleave(x, int(repeats), dim=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``'s outputs, sorted: the values, then (as asked) the
    first index of each, the inverse and the counts (int64)."""
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    out = [vals]
    if return_index:
        n = src.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=x.device)
        out.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        out.append((inv.reshape(x.shape) if axis is None else inv)
                   .to(torch.int64))
    if return_counts:
        out.append(counts.to(torch.int64))
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inv.reshape(-1).to(torch.int64))
    if return_counts:
        outs.append(counts.to(torch.int64))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _as_list(v):
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    r = ints(v)
    return [r] if isinstance(r, int) else list(r)


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e in zip(_as_list(axes), _as_list(starts), _as_list(ends)):
        idx[ax] = builtins.slice(s, e)
    (x,) = amp("slice", x)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Slices with steps; a negative step walks backwards, as numpy's."""
    (x,) = amp("strided_slice", x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        if st > 0:
            idx = [builtins.slice(None)] * x.ndim
            idx[ax] = builtins.slice(s, e, st)
            x = x[tuple(idx)]
        else:
            r = np.ascontiguousarray(
                np.arange(x.shape[ax])[builtins.slice(s, e, st)])
            x = torch.index_select(x, ax, torch.as_tensor(
                r, dtype=torch.long, device=x.device))
    return x


def crop(x, shape=None, offsets=None, name=None):
    shape = _as_list(shape)
    offsets = _as_list(offsets) if offsets is not None else [0] * x.ndim
    idx = tuple(builtins.slice(o, o + s if s != -1 else None)
                for o, s in zip(offsets, shape))
    (x,) = amp("crop", x)
    return x[idx]


def as_complex(x, name=None):
    (x,) = amp("as_complex", x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    (x,) = amp("as_real", x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def view(x, shape_or_dtype, name=None):
    """A reshape (a list) or a bitcast to another dtype."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.view(convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, list(other.shape))


def atleast_1d(*inputs, name=None):
    outs = [reshape(x, [1]) if x.ndim == 0 else x for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = []
    for x in inputs:
        while x.ndim < 2:
            x = unsqueeze(x, 0)
        outs.append(x)
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    """Axes appended at the end (a leading one for a 0-d tensor), as the
    JAX package does: a ``[n]`` tensor becomes ``[n, 1, 1]``."""
    outs = []
    for x in inputs:
        while x.ndim < 3:
            x = unsqueeze(x, -1) if x.ndim >= 1 else unsqueeze(x, 0)
        outs.append(x)
    return outs[0] if len(outs) == 1 else outs


def tensordot(x, y, axes=2, name=None):
    ax = axes.tolist() if torch.is_tensor(axes) else axes
    x, y = amp("tensordot", x, y)
    return torch.tensordot(x, y, dims=ax)


def tolist(x):
    return x.tolist()


def unstack(x, axis=0, num=None, name=None):
    (x,) = amp("unstack", x)
    return list(torch.unbind(x, axis % x.ndim))


def as_strided(x, shape, stride, offset=0, name=None):
    """Elements ``offset + sum(i_k * stride_k)`` of ``x``'s row-major
    flattening (a gather: a new tensor, as in JAX)."""
    shape = tuple(int(s) for s in shape)
    grids = np.indices(shape)
    flat = offset + builtins.sum(g * int(st) for g, st in zip(grids, stride))
    idx = torch.as_tensor(flat.reshape(-1), dtype=torch.long,
                          device=x.device)
    (x,) = amp("as_strided", x)
    return torch.take(x, idx).reshape(shape)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``np.histogramdd`` on the device: ``x`` is ``[N, D]``; -> (float64
    histogram, a list of edges per dimension: float64 from ``ranges``,
    else in ``x``'s dtype from each dimension's min and max, read on the
    host), as numpy gives them."""
    n, d = x.shape
    nb = [int(bins)] * d if isinstance(bins, (int, np.integer)) \
        else [int(b) for b in bins]
    xs = x.to(float64)
    if ranges is None:
        lo = xs.amin(0).tolist()
        hi = xs.amax(0).tolist()
        rng = list(zip(lo, hi))
    else:
        rng = [tuple(ranges[2 * i:2 * i + 2]) if not isinstance(
            ranges[0], (list, tuple)) else tuple(ranges[i])
            for i in range(d)]
    edges, flat, inside = [], torch.zeros(n, dtype=torch.long,
                                          device=x.device), None
    for k in range(d):
        lo, hi = rng[k]
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        e = torch.linspace(lo, hi, nb[k] + 1, dtype=float64,
                           device=x.device)
        edges.append(e)
        col = xs[:, k].contiguous()
        b = torch.searchsorted(e, col, right=True) - 1
        b = torch.where(col == e[-1], torch.full_like(b, nb[k] - 1), b)
        ok = (b >= 0) & (b < nb[k])
        inside = ok if inside is None else inside & ok
        flat = flat * nb[k] + b.clamp(0, nb[k] - 1)
    w = torch.ones(n, dtype=float64, device=x.device) if weights is None \
        else weights.to(float64)
    total = int(np.prod(nb))
    hist = torch.zeros(total, dtype=float64, device=x.device).index_add(
        0, flat, torch.where(inside, w, torch.zeros_like(w)))
    hist = hist.reshape(nb)
    if density:
        widths = [torch.diff(e) for e in edges]
        vol = widths[0]
        for wk in widths[1:]:
            vol = vol[..., None] * wk
        hist = hist / hist.sum() / vol
    if ranges is None and x.is_floating_point():
        edges = [e.to(x.dtype) for e in edges]
    return hist, edges
