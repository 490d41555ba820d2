"""Eager collective communication API, after
``paddle_tpu/distributed/collective.py``.

Reference: paddle/fluid/distributed/collective/process_group.h:47
(AllGather / AllReduce / AllToAll / Broadcast / Reduce / ReduceScatter /
Scatter) and python/paddle/distributed/communication/group.py.

**A per-rank tensor.** JAX's collectives take one global array whose
leading axis is the rank axis, because one controller holds every rank.
Here a rank is a process (``env.py``) and every op takes this rank's own
tensor, as Paddle's do: rank ``i``'s tensor is the slice ``i`` of JAX's
global array, and its result is JAX's result ``[i]``. List forms follow
Paddle too: ``reduce_scatter``'s list is this rank's chunks, one for each
rank, and ``all_to_all``'s input list is what this rank sends, one tensor
to each rank.

A :class:`Group` is a mesh axis: a ``DeviceMesh`` (``topology.py``) and
the name of one of its dims, whose process group the ops run over.

**Transport: gloo, by a fixed rule per op** (``TRANSPORT``). Torch's gloo
backend takes CUDA tensors for ``all_reduce`` and ``broadcast`` only, so
those two run on the tensor where it lies; every other op copies a CUDA
tensor to host memory, runs there and copies the result back:

===================  =========================================
op                   transport
===================  =========================================
``all_reduce``       the tensor's device
``broadcast``        the tensor's device
``reduce_scatter``   an ``all_reduce`` on the tensor's device,
                     then this rank's chunk
``reduce``           host
``all_gather``       host
``scatter``          host
``all_to_all``       host
``barrier``          host (no payload)
===================  =========================================

The rule is chosen by the op, before the call: an op never tries one
transport and retries another. ``ReduceOp.AVG`` is a sum divided by the
group's size (gloo has no average). Each op runs under ``no_grad`` and
writes its result in place where JAX rebinds (``all_reduce``, ``reduce``,
``broadcast``, ``scatter``, ``reduce_scatter``); the tensor-parallel
layers (``fleet/mp_layers.py``) wrap them in autograd functions.

Every op goes through :func:`_collective_begin` (fault injection at its
site, the flight recorder's issue entry), :func:`_collective_ready` (the
opt-in desync check on what is issued) and ``record_complete``, whose
entry feeds the collective latency metrics and trace events.
"""
from __future__ import annotations

import torch

from . import fault as _fault
from . import flight_recorder as _fr

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "reduce", "broadcast", "scatter", "reduce_scatter",
           "all_to_all", "barrier", "destroy_process_group",
           "quantize_int8_block", "all_reduce_quantized", "TRANSPORT"]

TRANSPORT = {"all_reduce": "device", "broadcast": "device",
             "reduce_scatter": "device (all_reduce)", "reduce": "host",
             "all_gather": "host", "scatter": "host", "all_to_all": "host",
             "barrier": "host"}


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    import torch.distributed as dist
    table = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
             "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
             "prod": dist.ReduceOp.PRODUCT}
    if op not in table:
        raise ValueError(f"unsupported reduce op {op}")
    return table[op]


class Group:
    """Reference: communication/group.py Group — here a (mesh, axis) pair:
    the process group of the mesh dim ``axis`` that holds this rank.
    ``ranks`` are the group's global ranks (default: the dim's ranks that
    share this rank's other coordinates); ``rank`` is this process's index
    in them."""

    _next_id = [0]

    def __init__(self, mesh, axis, ranks=None):
        import torch.distributed as dist
        from .topology import mesh_degree
        self.mesh = mesh
        self.axis = axis
        self.process_group = mesh.get_group(axis) if mesh is not None \
            else None
        if ranks is None:
            ranks = dist.get_process_group_ranks(self.process_group) \
                if self.process_group is not None else [0]
        self.ranks = list(ranks)
        self.nranks = mesh_degree(mesh, axis) if mesh is not None \
            else len(self.ranks)
        Group._next_id[0] += 1
        self.id = Group._next_id[0]

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        """This process's index in the group (-1 outside it)."""
        import torch.distributed as dist
        return self.get_group_rank(dist.get_rank()) \
            if dist.is_initialized() else 0

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def _global(self, group_rank):
        """The global rank of the group's ``group_rank``-th member."""
        return self.ranks[int(group_rank)]

    def __repr__(self):
        return f"Group(axis={self.axis}, nranks={self.nranks})"


_default_group: Group | None = None
_groups: dict = {}


def _get_default_group() -> Group:
    global _default_group
    if _default_group is None:
        from .env import world_mesh
        _default_group = Group(world_mesh(), "world")
        _groups[0] = _default_group
    return _default_group


def get_group(gid=0) -> Group:
    return _groups.get(gid, _get_default_group())


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over the global ``ranks`` (the world when None): a process
    group of its own and a one-dim mesh named ``sub`` over it on its
    members. Every rank of the world calls it, members or not, in the
    same order (``torch.distributed.new_group``'s rule)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from .topology import MESH_DEVICE, ensure_world_group
    if not ranks:
        return _get_default_group()
    ensure_world_group()
    ranks = [int(r) for r in ranks]
    pg = dist.new_group(ranks)
    mesh = DeviceMesh.from_group(pg, MESH_DEVICE, mesh=ranks,
                                 mesh_dim_names=("sub",)) \
        if dist.get_rank() in ranks else None
    g = Group(mesh, "sub", ranks)
    g.process_group = pg if mesh is not None else None
    _groups[g.id] = g
    return g


def destroy_process_group(group=None):
    """``group`` None: every group and the default process group go (the
    world mesh, the hybrid topology and the per-group sequence counters
    with them), so a later ``init_parallel_env`` starts a new world; else
    that group's process group."""
    global _default_group
    import torch.distributed as dist
    if group is not None:
        if group.process_group is not None and dist.is_initialized():
            dist.destroy_process_group(group.process_group)
        _groups.pop(group.id, None)
        return
    from . import env, topology
    _default_group = None
    _groups.clear()
    env._world_mesh = None
    topology._set_hcg(None)
    # group identities die with the groups: per-group seq counters must
    # not leak into the next process group
    _fr.reset_seqs()
    if dist.is_initialized():
        dist.destroy_process_group()
    env._initialized = False


def _collective_begin(site, kind, g, arr=None):
    """Per-collective bookkeeping, phase 1: fault injection and the flight
    recorder's issue entry. -> ``(entry, injected)``; the caller runs
    :func:`_collective_ready` on what it issues and completes the entry
    when the op returns."""
    injected = _fault.maybe_inject(site)
    extra = None
    if arr is not None:
        nbytes = arr.numel() * arr.element_size()
        if nbytes:
            # wire-volume accounting: observability's per-kind
            # collective_bytes_total counter reads this off the entry
            extra = {"nbytes": int(nbytes)}
    e = _fr.record_issue(kind, group=f"{g.axis}:{g.id}",
                         shape=tuple(arr.shape) if arr is not None else None,
                         dtype=arr.dtype if arr is not None else None,
                         extra=extra)
    return e, injected


def _collective_ready(e, injected, arr=None):
    """Phase 2: fold the issued payload into the ring entry, then run the
    opt-in pre-issue desync cross-check on it."""
    if e is not None and arr is not None:
        e["shape"] = list(arr.shape)
        e["dtype"] = str(arr.dtype)
    _fr.check_desync(e, injected=(injected == "desync"))
    return e


def _as_group(group):
    return group if isinstance(group, Group) else _get_default_group()


def _host(t):
    """A contiguous host copy of ``t`` (``t`` itself when it already is
    one)."""
    return t.detach().contiguous() if t.device.type == "cpu" \
        else t.detach().to("cpu").contiguous()


def _dense(tensor):
    """``tensor`` when the backend can write it in place, else a contiguous
    copy (the caller copies the result back)."""
    return tensor if tensor.is_contiguous() else tensor.contiguous()


def _run_all_reduce(buf, op, g):
    """Reduce ``buf`` (contiguous) in place over ``g`` on its device."""
    import torch.distributed as dist
    if g.nranks > 1:
        dist.all_reduce(buf, op=_torch_op(op), group=g.process_group)
    if op in (ReduceOp.AVG, "avg"):
        if buf.is_floating_point():
            buf.div_(g.nranks)
        else:
            buf.copy_(torch.div(buf, g.nranks, rounding_mode="trunc"))
    return buf


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce of this rank's ``tensor`` over the group, on the
    tensor's device. Reference: communication/all_reduce.py."""
    g = _as_group(group)
    rec, inj = _collective_begin("allreduce", "all_reduce", g, tensor)
    _collective_ready(rec, inj, tensor)
    with torch.no_grad():
        buf = _dense(tensor)
        _run_all_reduce(buf, op, g)
        if buf is not tensor:
            tensor.copy_(buf)
    _fr.record_complete(rec)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's tensor, in rank order: fills ``tensor_list`` (on
    ``tensor``'s device) and returns them stacked ``[nranks, ...]``.
    Host transport. Reference: communication/all_gather.py."""
    import torch.distributed as dist
    g = _as_group(group)
    rec, inj = _collective_begin("allgather", "all_gather", g, tensor)
    _collective_ready(rec, inj, tensor)
    with torch.no_grad():
        h = _host(tensor)
        if g.nranks > 1:
            parts = [torch.empty_like(h) for _ in range(g.nranks)]
            dist.all_gather(parts, h, group=g.process_group)
        else:
            parts = [h]
        out = torch.stack(parts).to(tensor.device)
    _fr.record_complete(rec)
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(out.unbind(0))
    return out


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to the group's rank ``dst``; the other ranks keep their
    tensor (Paddle leaves it undefined; JAX keeps it). Host transport."""
    import torch.distributed as dist
    g = _as_group(group)
    rec, inj = _collective_begin("reduce", "reduce", g, tensor)
    _collective_ready(rec, inj, tensor)
    with torch.no_grad():
        h = _host(tensor).clone()
        if g.nranks > 1:
            dist.reduce(h, dst=g._global(dst), op=_torch_op(op),
                        group=g.process_group)
        if g.rank == int(dst):
            if op in (ReduceOp.AVG, "avg"):
                h = h / g.nranks if h.is_floating_point() \
                    else torch.div(h, g.nranks, rounding_mode="trunc")
            tensor.copy_(h)
    _fr.record_complete(rec)
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank's tensor becomes the group's rank ``src``'s, on the
    tensor's device. Reference: communication/broadcast.py."""
    import torch.distributed as dist
    g = _as_group(group)
    rec, inj = _collective_begin("broadcast", "broadcast", g, tensor)
    _collective_ready(rec, inj, tensor)
    with torch.no_grad():
        buf = _dense(tensor)
        if g.nranks > 1:
            dist.broadcast(buf, src=g._global(src), group=g.process_group)
        if buf is not tensor:
            tensor.copy_(buf)
    _fr.record_complete(rec)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``i`` of the group receives ``tensor_list[i]`` of the rank
    ``src`` (only ``src``'s list is read). Host transport."""
    import torch.distributed as dist
    g = _as_group(group)
    rec, inj = _collective_begin("scatter", "scatter", g, tensor)
    _collective_ready(rec, inj, tensor)
    with torch.no_grad():
        out = torch.empty(tensor.shape, dtype=tensor.dtype)
        mine = g.rank == int(src)
        parts = [_host(t) for t in tensor_list] if mine else None
        if g.nranks > 1:
            dist.scatter(out, parts, src=g._global(src),
                         group=g.process_group)
        else:
            out = parts[0]
        tensor.copy_(out)
    _fr.record_complete(rec)
    return tensor


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Each rank gets one reduced chunk: this rank's payload ``[N*c, ...]``
    (a tensor, or a list of the ``N`` chunks, chunk ``j`` for rank ``j``)
    -> ``tensor`` ``[c, ...]`` = the sum over ranks of their chunk for
    this rank. Transport: an all-reduce on the payload's device, then this
    rank's chunk. Reference: communication/reduce_scatter.py."""
    g = _as_group(group)
    src = tensor_or_tensor_list
    with torch.no_grad():
        payload = torch.cat([t.detach() for t in src]) \
            if isinstance(src, (list, tuple)) else src.detach().clone()
        rec, inj = _collective_begin("reducescatter", "reduce_scatter", g,
                                     payload)
        _collective_ready(rec, inj, payload)
        payload = _run_all_reduce(payload.contiguous(), op, g)
        c = payload.shape[0] // g.nranks
        tensor.copy_(payload[g.rank * c:(g.rank + 1) * c])
    _fr.record_complete(rec)
    return tensor


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank ``i`` sends its ``j``-th tensor (or chunk of the leading axis)
    to rank ``j``: fills ``out_tensor_list`` with what each rank sent
    this one, in rank order, and returns them stacked. Host transport.
    Reference: communication/all_to_all.py."""
    import torch.distributed as dist
    g = _as_group(group)
    with torch.no_grad():
        arr = torch.stack(list(in_tensor_list)) \
            if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list
        rec, inj = _collective_begin("alltoall", "all_to_all", g, arr)
        _collective_ready(rec, inj, arr)
        h = _host(arr)
        out = torch.empty_like(h)
        if g.nranks > 1:
            dist.all_to_all_single(out, h, group=g.process_group)
        else:
            out = h
        out = out.to(arr.device)
    _fr.record_complete(rec)
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(out.unbind(0))
    return out


def barrier(group=None):
    """Every rank of the group reaches this point before any leaves it."""
    import torch.distributed as dist
    g = _as_group(group)
    rec, inj = _collective_begin("barrier", "barrier", g)
    _collective_ready(rec, inj)  # no payload: the signature stays bare
    if g.nranks > 1:
        dist.barrier(group=g.process_group)
    _fr.record_complete(rec)


def quantize_int8_block(x):
    """Symmetric per-block int8 quantization, the wire format of
    :func:`all_reduce_quantized` -> ``(q, safe)``: the int8 payload and
    the zero-safe scale, ``q * safe`` the local dequantization (round half
    to even, as ``jnp.round``)."""
    qmax = 127.0
    scale = x.abs().max() / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -qmax, qmax).to(torch.int8)
    return q, safe


def all_reduce_quantized(tensor, group=None, bits=8, qtype=None,
                         sync_op=True):
    """Quantized all-reduce (EQuARX, arxiv 2506.17615): approximately the
    sum over ranks of ``tensor``, in place, with less on the wire.

    * ``qtype="int8"`` (default, ``bits=8``): each rank quantizes its
      tensor with one symmetric scale (:func:`quantize_int8_block`); the
      int8 payloads and the scales are gathered, dequantized and summed.
    * ``qtype="bf16"`` (``bits=16``): the payloads travel as bfloat16 and
      are summed in float32.

    The gathers use the host transport. The ring entry carries the
    compressed payload's bytes. Other bit widths are refused."""
    if qtype is None:
        qtype = {8: "int8", 16: "bf16"}.get(bits)
    if qtype not in ("int8", "bf16"):
        raise ValueError(
            f"all_reduce_quantized supports qtype='int8' (bits=8) or "
            f"'bf16' (bits=16), got bits={bits} qtype={qtype!r}")
    g = _as_group(group)
    rec, inj = _collective_begin("allreduce",
                                 f"all_reduce_quantized.{qtype}", g, tensor)
    _collective_ready(rec, inj, tensor)
    if rec is not None and rec.get("nbytes"):
        # the wire payload is the quantized block, not the f32 input
        rec["nbytes"] = tensor.numel() * (1 if qtype == "int8" else 2)
    with torch.no_grad():
        x = tensor.detach()
        if qtype == "int8":
            q, safe = quantize_int8_block(x)
            qs = _gather(q, g)                           # [N, ...] int8
            ss = _gather(safe.reshape(1).float(), g)     # [N, 1]
            deq = qs.float() * ss.reshape((-1,) + (1,) * x.dim())
        else:
            deq = _gather(x.to(torch.bfloat16), g).float()
        tensor.copy_(deq.sum(dim=0).to(tensor.dtype))
    _fr.record_complete(rec)
    return tensor


def _gather(x, g):
    """Every rank's ``x`` stacked, over the host, without a ring entry of
    its own (the caller's entry covers it)."""
    import torch.distributed as dist
    h = _host(x)
    if g.nranks == 1:
        return h[None].to(x.device)
    parts = [torch.empty_like(h) for _ in range(g.nranks)]
    dist.all_gather(parts, h, group=g.process_group)
    return torch.stack(parts).to(x.device)
