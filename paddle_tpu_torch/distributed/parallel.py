"""DataParallel and shard_batch: the port's ``paddle_tpu/distributed/
parallel.py:39-186`` (reference: python/paddle/distributed/parallel.py:202),
over ``torch.distributed`` with gloo (``env.py``).

The reference semantics, which the JAX docstring states and JAX's mesh
gets by sharding one global batch:

- each rank's input is its local shard of the global batch
  (:func:`shard_batch` leaves it where it is);
- parameters and buffers are broadcast from rank 0 when the network is
  wrapped;
- after a backward, each parameter's gradient is averaged over the group
  (a sum all-reduce, then a division by the world size), so the
  optimizer's update is the one for the global batch, and every rank
  applies the same one.

The gradients sync once a backward has finished, through a callback
that the first parameter's gradient hook queues on the autograd engine.
They travel in buckets built as JAX's ``overlap.build_buckets`` builds
them (reverse registration order, ``comm_buffer_size`` MB each, the last
one re-packed at ``last_comm_buffer_size`` MB): one all-reduce a bucket,
of the bucket's gradients flattened into one buffer. Gloo takes the
card's tensors as they are (it stages them through host memory
itself). ``no_sync`` skips
the sync, so gradients accumulate locally; the first backward outside it
syncs the accumulated sums, which by linearity is the reference's
skip-then-sync. The set of parameters with a gradient must be the same
on every rank (``find_unused_parameters`` is accepted and does nothing,
as in JAX).

**No collective runs inside a captured graph.** A gloo all-reduce is
host work. When a wrapped forward runs under ``jit.to_static``'s staging
detector (the CPU staging call, the card's capture), it raises
:class:`~..jit.api.GraphBreak` before anything launches, so the staged
step falls back to eager (``to_static``'s fallback, as JAX's does at a
concretization): ``Model.fit``'s first step on the card is its eager
warm-up, its second breaks at the capture and runs eagerly, and so does
every later step. The sync itself raises the same break should it ever
be reached under the detector.

Not ported (ROADMAP Queue 1 item 8, ``overlap.py``): the bucketed
overlap engine (``comm_overlap=True``, ``strategy.dp_comm_overlap``,
``PADDLE_TPU_DP_OVERLAP=1``) and the quantized transports
(``comm_quant``, ``PADDLE_TPU_DP_QUANT``); each raises.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from ..nn.layer.layers import Layer
from .env import get_world_size, init_parallel_env

__all__ = ["DataParallel", "shard_batch"]

_ITEM8 = ("is not ported yet (ROADMAP Queue 1 item 8, "
          "paddle_tpu/distributed/overlap.py)")


def shard_batch(tensor, group=None):
    """This rank's shard of the batch (dim 0). The input is this process's
    local data, as in the reference (each rank loads its own shard, e.g.
    through ``DistributedBatchSampler``), so it stays where it is; an
    array becomes a tensor."""
    return tensor if torch.is_tensor(tensor) else torch.as_tensor(tensor)


def _check_cap(name, value):
    try:
        v = float(value)
    except (TypeError, ValueError):
        v = -1.0
    if v <= 0:
        raise ValueError(
            f"DataParallel {name}={value!r}: the gradient comm buffer size "
            "is in MB and must be > 0 (it caps how many gradients one "
            "bucketed all-reduce carries)")
    return v


def _buckets(params, comm_buffer_size, last_comm_buffer_size):
    """JAX's ``overlap.build_buckets``: lists of parameters."""
    cap = _check_cap("comm_buffer_size", comm_buffer_size) * 2**20
    last_cap = _check_cap("last_comm_buffer_size",
                          last_comm_buffer_size) * 2**20

    def pack(items, cap_bytes):
        groups, cur, cur_bytes = [], [], 0
        for p in items:
            nb = p.numel() * p.element_size()
            if cur and cur_bytes + nb > cap_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += nb
        if cur:
            groups.append(cur)
        return groups

    groups = pack(list(reversed(params)), cap)
    if groups and len(groups[-1]) > 1:
        groups.extend(pack(groups.pop(), last_cap))
    return groups


class DataParallel(Layer):
    """Reference: paddle.DataParallel (distributed/parallel.py:202)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, comm_overlap=None, comm_quant=None):
        super().__init__()
        if comm_overlap is None:
            comm_overlap = bool(getattr(strategy, "dp_comm_overlap",
                                        False)) or \
                os.environ.get("PADDLE_TPU_DP_OVERLAP", "") in (
                    "1", "true", "True")
        if comm_overlap:
            raise NotImplementedError(
                f"DataParallel's communication overlap {_ITEM8}")
        if comm_quant is None:
            comm_quant = getattr(strategy, "dp_comm_quant", None) or \
                os.environ.get("PADDLE_TPU_DP_QUANT")
        if comm_quant is not None and str(comm_quant).lower() not in (
                "", "0", "none", "false", "off"):
            raise NotImplementedError(
                f"DataParallel's quantized gradient transport "
                f"(comm_quant={comm_quant!r}) {_ITEM8}")
        init_parallel_env()
        self._layers = layers
        self._group = group
        self._world = get_world_size(group)
        params = [p for p in layers.parameters() if p.requires_grad]
        self._buckets = _buckets(params, comm_buffer_size,
                                 last_comm_buffer_size)
        self._in_no_sync = False
        self._queued = False
        if self._world > 1:
            self._sync_params_buffers()
            for p in params:
                p.register_post_accumulate_grad_hook(self._grad_ready)

    def _src(self):
        """The global rank of the group's rank 0."""
        if self._group is None:
            return 0
        return dist.get_global_rank(self._group, 0)

    @torch.no_grad()
    def _sync_params_buffers(self):
        """Broadcast every parameter and buffer from the group's rank 0
        (reference: ``sync_params_buffers``)."""
        src = self._src()
        for t in list(self._layers.parameters()) + \
                list(self._layers.buffers()):
            if t is not None:
                dist.broadcast(t, src=src, group=self._group)

    # ---- gradient sync ----
    def _grad_ready(self, _param):
        if self._in_no_sync or self._queued:
            return
        self._queued = True
        torch.autograd.Variable._execution_engine.queue_callback(
            self._sync_grads)

    @torch.no_grad()
    def _sync_grads(self):
        """Average every gradient over the group, a bucket at a time."""
        self._queued = False
        from ..jit.api import GraphBreak, host_reads_break
        if host_reads_break():
            raise GraphBreak("DataParallel's gradient all-reduce runs on "
                             "the host over gloo and cannot be staged")
        for bucket in self._buckets:
            grads = [p.grad for p in bucket if p.grad is not None]
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads]) \
                if len(grads) > 1 else grads[0].reshape(-1).clone()
            dist.all_reduce(flat, group=self._group)
            flat.div_(self._world)
            off = 0
            for g in grads:
                n = g.numel()
                g.copy_(flat[off:off + n].view_as(g))
                off += n

    def forward(self, *inputs, **kwargs):
        # a new step: a sync queued by a backward that raised before its
        # callbacks ran must not block this step's
        self._queued = False
        if self._world > 1 and torch.is_grad_enabled():
            from ..jit.api import GraphBreak, host_reads_break
            if host_reads_break():
                # before anything launches: the gradient sync after this
                # forward's backward is a host collective
                raise GraphBreak(
                    "a DataParallel step syncs its gradients with a gloo "
                    "all-reduce on the host, which cannot be captured")
        # each rank's input is its shard already (shard_batch)
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Reference semantics (DataParallel.no_sync): skip the gradient
        sync during micro-batch accumulation; the first backward after
        the context syncs the accumulated gradients once."""
        prev = self._in_no_sync
        self._in_no_sync = True
        try:
            yield
        finally:
            self._in_no_sync = prev

    def scale_loss(self, loss):
        return loss

    # ---- the wrapped layer's state and traversal ----
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers, recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             remove_duplicate, recurse)

    def sublayers(self, include_self=False):
        return self._layers.sublayers(include_self)
