"""A per-rank function split over mesh axes: the port's form of JAX's
``shard_map`` for head-local attention (``serving/decode.py``'s and
``serving/ragged_attention.py``'s sharded wrappers,
``ops/kernels/flash_attention.py``'s ``sharded_flash_attention``).

JAX's wrappers take the global arrays and run the kernel on every
device's slice at once. Here a rank is a process, so a :class:`MeshSharded`
has two calls:

* ``f(*args)`` — JAX's signature, whole tensors on every rank: each rank
  cuts its **contiguous** slice of every split argument (its heads along
  the model axis, its batch rows along a data axis), runs the function on
  it, and the ranks all-gather their outputs (host transport,
  ``collective.py``), so every rank returns the whole output. A head
  slice of a pool is a strided view; it is copied dense before the
  kernel sees it, because the hand kernels index a pool assuming a dense
  head stride and would read the wrong heads from a view without any
  error.
* ``f.local(*args)`` — the rank's own slices (a tensor-parallel engine's
  pools hold ``KVH / mp`` heads): the function alone, no collective. An
  argument listed ``dense`` that is a strided view is refused, never read
  as it lies.

At degree 1 on every axis both calls are the function itself.
"""
from __future__ import annotations

import torch

from .collective import Group, all_gather
from .topology import mesh_degree


class MeshSharded:
    """``fn`` over this rank's slices. ``splits``: ``(axis, {argument
    index: dim}, output dim)`` for each mesh axis the arguments are cut
    along; ``dense``: the argument indices ``local`` takes only as dense
    tensors."""

    def __init__(self, fn, mesh, splits, dense=()):
        self.fn = fn
        self._splits = [(Group(mesh, axis), dims, out)
                        for axis, dims, out in splits
                        if mesh_degree(mesh, axis) > 1]
        self._dense = tuple(dense)

    def local(self, *args, **kw):
        for i in self._dense:
            if not args[i].is_contiguous():
                raise ValueError(
                    f"argument {i} {tuple(args[i].shape)} is a strided "
                    "view: the kernels index a pool assuming a dense head "
                    "stride, so this rank's heads must be a tensor of "
                    "their own (.contiguous(), or the rank's own pool)")
        return self.fn(*args, **kw)

    def __call__(self, *args, **kw):
        if not self._splits:
            return self.fn(*args, **kw)
        args = list(args)
        for g, dims, _ in self._splits:
            for i, d in dims.items():
                n = args[i].shape[d]
                if n % g.nranks:
                    raise ValueError(
                        f"argument {i}: {n} along dim {d} not divisible by "
                        f"mesh axis {g.axis}={g.nranks}")
                per = n // g.nranks
                args[i] = args[i].narrow(d, g.rank * per, per).contiguous()
        out = self.fn(*args, **kw)
        for g, _, out_dim in reversed(self._splits):
            parts = []
            all_gather(parts, out.contiguous(), group=g)
            out = torch.cat(parts, dim=out_dim)
        return out
