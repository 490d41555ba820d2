"""The communication long tail of ``paddle.distributed``, after
``paddle_tpu/distributed/comm_extra.py:35-365``: point-to-point
``send`` / ``recv`` and their async forms, ``gather``, ``alltoall``,
``alltoall_single``, the object collectives, ``spawn``,
``ParallelEnv`` / ``ParallelMode``, ``split`` (which builds a
tensor-parallel layer) and the gloo bootstrap trio.

Each op takes this rank's own tensor (``collective.py``'s rule) and moves
it over the group's process group by the host transport: gloo takes CUDA
tensors only for ``all_reduce`` and ``broadcast``, so a CUDA tensor is
copied to host memory, sent and copied back. In a one-process job (no
process group) ``send`` / ``recv`` go through an in-process mailbox and
the object collectives see this rank alone, as JAX's single-controller
paths do. The auto-parallel and parameter-server names of the JAX module
(``:367-561``) are not ported (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import os
import pickle

import torch

from . import flight_recorder as _fr
from .collective import ReduceOp, _as_group, _host, all_gather  # noqa: F401

__all__ = ["gather", "alltoall", "alltoall_single", "send", "recv",
           "isend", "irecv", "wait", "all_gather_object",
           "broadcast_object_list", "scatter_object_list", "is_available",
           "get_backend", "ParallelMode", "ParallelEnv", "spawn", "split",
           "gloo_init_parallel_env", "gloo_barrier", "gloo_release"]


def is_available():
    """Reference: dist.is_available — collectives exist on this build."""
    import torch.distributed as dist
    return dist.is_available()


def get_backend(group=None):
    """Reference: dist.get_backend — the process group's backend
    (``gloo``: the port's groups are gloo groups)."""
    import torch.distributed as dist
    if dist.is_initialized():
        pg = getattr(group, "process_group", group)
        return dist.get_backend(pg)
    return "gloo"


class ParallelMode:
    """Reference: parallel.ParallelMode constants."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class ParallelEnv:
    """Reference: parallel.ParallelEnv — env-derived rank/world info."""

    @property
    def rank(self):
        from .env import get_rank
        return get_rank()

    @property
    def world_size(self):
        from .env import get_world_size
        return get_world_size()

    @property
    def device_id(self):
        return int(os.environ.get("FLAGS_selected_devices", "0"))

    @property
    def device_type(self):
        from ..device import resolve_device
        return "gpu" if resolve_device(None).type == "cuda" else "cpu"

    nranks = world_size
    local_rank = rank


def _multi():
    """Whether a process group of more than one rank is up."""
    from .env import get_world_size
    return get_world_size() > 1


# -- collectives ----------------------------------------------------------

def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Reference: communication/gather.py — every rank's tensor to the
    group's rank ``dst``, whose ``gather_list`` receives them in rank
    order (the other ranks' lists stay as given). Host transport."""
    import torch.distributed as dist
    if gather_list is None:
        gather_list = []
    g = _as_group(group)
    rec = _fr.record_issue("gather", group=f"{g.axis}:{g.id}",
                           shape=tuple(tensor.shape), dtype=tensor.dtype,
                           extra={"dst": dst, "nbytes": tensor.numel()
                                  * tensor.element_size()})
    with torch.no_grad():
        h = _host(tensor)
        mine = g.rank == int(dst)
        parts = [torch.empty_like(h) for _ in range(g.nranks)] \
            if mine else None
        if g.nranks > 1:
            dist.gather(h, parts, dst=g._global(dst), group=g.process_group)
        elif mine:
            parts = [h]
        if mine:
            gather_list.clear()
            gather_list.extend(p.to(tensor.device) for p in parts)
    _fr.record_complete(rec)
    return gather_list


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Reference: communication/all_to_all.py alltoall."""
    from .collective import all_to_all
    return all_to_all(out_tensor_list, in_tensor_list, group=group,
                      sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Reference: alltoall_single — this rank's buffer is cut into nranks
    equal chunks along its leading axis; chunk ``j`` goes to rank ``j``,
    and ``out_tensor`` receives every rank's chunk for this one, in rank
    order. Host transport."""
    import torch.distributed as dist
    g = _as_group(group)
    n = g.nranks
    if in_split_sizes is not None and len(set(in_split_sizes)) > 1:
        raise NotImplementedError(
            "alltoall_single with uneven split sizes is not supported")
    if in_tensor.shape[0] % n:
        raise ValueError(
            f"alltoall_single cuts the leading axis into nranks={n} equal "
            f"chunks, got shape {tuple(in_tensor.shape)}")
    rec = _fr.record_issue("alltoall_single", group=f"{g.axis}:{g.id}",
                           shape=tuple(in_tensor.shape),
                           dtype=in_tensor.dtype,
                           extra={"nbytes": in_tensor.numel()
                                  * in_tensor.element_size()})
    with torch.no_grad():
        h = _host(in_tensor)
        out = torch.empty_like(h)
        if n > 1:
            dist.all_to_all_single(out, h, group=g.process_group)
        else:
            out = h
        out_tensor.copy_(out)
    _fr.record_complete(rec)
    return out_tensor


# -- p2p: the ranks' process group; an in-process mailbox at world 1 ------

_mailbox: dict = {}


class _Task:
    """Reference: the async task handle returned by isend/irecv: ``wait()``
    waits for the transfer and, for a receive, copies it into the
    destination tensor."""

    def __init__(self, work=None, finish=None):
        self._work = work
        self._finish = finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._finish is not None:
                self._finish()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _p2p_entry(kind, tensor, peer_key, peer):
    return _fr.record_issue(kind, group="p2p", shape=tuple(tensor.shape),
                            dtype=tensor.dtype,
                            extra={peer_key: peer, "nbytes": tensor.numel()
                                   * tensor.element_size()})


def _global_peer(peer, group):
    return group._global(peer) if group is not None else int(peer)


def _send(tensor, dst, group, block):
    import torch.distributed as dist
    rec = _p2p_entry("send", tensor, "dst", dst)
    if _multi():
        h = _host(tensor)
        pg = getattr(group, "process_group", None)
        work = dist.isend(h, _global_peer(dst, group), group=pg)
        task = _Task(work)
        if block:
            task.wait()
    else:
        _mailbox.setdefault(int(dst), []).append(_host(tensor).clone())
        task = _Task()
    _fr.record_complete(rec)
    return task


def _recv(tensor, src, group, block):
    import torch.distributed as dist
    rec = _p2p_entry("recv", tensor, "src", src)
    if _multi():
        h = torch.empty(tensor.shape, dtype=tensor.dtype)
        pg = getattr(group, "process_group", None)
        work = dist.irecv(h, _global_peer(src, group), group=pg)

        def finish():
            with torch.no_grad():
                tensor.copy_(h)
        task = _Task(work, finish)
        if block:
            task.wait()
    else:
        box = _mailbox.get(0) or []
        if not box:
            raise RuntimeError(f"recv: no message pending from rank {src}")
        with torch.no_grad():
            tensor.copy_(box.pop(0))
        task = _Task()
    _fr.record_complete(rec)
    return task


def send(tensor, dst=0, group=None, sync_op=True):
    """Reference: communication/send.py — ``tensor`` to the rank ``dst``
    (of ``group`` when given, else of the world); returns when it is
    sent. Host transport."""
    return _send(tensor, dst, group, True)


def recv(tensor, src=0, group=None, sync_op=True):
    """Reference: communication/recv.py — receives into ``tensor`` from
    the rank ``src``."""
    return _recv(tensor, src, group, True)


def isend(tensor, dst=0, group=None):
    """``send`` that returns at once; the task's ``wait()`` ends it."""
    return _send(tensor, dst, group, False)


def irecv(tensor, src=0, group=None):
    """``recv`` that returns at once; the task's ``wait()`` fills
    ``tensor``."""
    return _recv(tensor, src, group, False)


def wait(tensor, group=None, use_calc_stream=True):
    """Reference: communication/wait.py — the work queued on ``tensor``'s
    device is done."""
    if tensor.device.type == "cuda":
        torch.cuda.synchronize(tensor.device)
    return tensor


# -- object collectives ---------------------------------------------------

def all_gather_object(object_list, obj, group=None):
    """Reference: all_gather_object — every rank's ``obj`` appended to
    ``object_list`` in rank order (pickled over the process group; this
    rank's alone in a one-process job)."""
    import torch.distributed as dist
    rec = _fr.record_issue("all_gather_object", group="object")
    if _multi():
        g = _as_group(group)
        got = [None] * g.nranks
        dist.all_gather_object(got, obj, group=g.process_group)
        object_list.extend(got)
    else:
        object_list.append(obj)
    _fr.record_complete(rec)
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    """Reference: broadcast_object_list — every rank's list becomes the
    rank ``src``'s."""
    import torch.distributed as dist
    rec = _fr.record_issue("broadcast_object_list", group="object",
                           extra={"src": src})
    if _multi():
        g = _as_group(group)
        dist.broadcast_object_list(object_list, src=g._global(src),
                                   group=g.process_group)
    _fr.record_complete(rec)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Reference: scatter_object_list — rank ``i`` appends the rank
    ``src``'s ``in_object_list[i]`` to ``out_object_list``."""
    import torch.distributed as dist
    rec = _fr.record_issue("scatter_object_list", group="object",
                           extra={"src": src})
    if _multi():
        g = _as_group(group)
        got = [None]
        dist.scatter_object_list(
            got, in_object_list if g.rank == int(src) else None,
            src=g._global(src), group=g.process_group)
        out_object_list.append(got[0])
    else:
        out_object_list.append((in_object_list or [None])[0])
    _fr.record_complete(rec)
    return out_object_list


# -- launch helpers -------------------------------------------------------

def _spawn_entry(rank, nprocs, coordinator, func, args):
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ.setdefault(
        "PADDLE_TRAINER_ENDPOINTS",
        ",".join(f"127.0.0.1:{6170 + i}" for i in range(nprocs)))
    # the port launcher's contract, which init_parallel_env reads
    os.environ["PADDLE_TPU_PROCESS_ID"] = str(rank)
    os.environ["PADDLE_TPU_NUM_PROCESSES"] = str(nprocs)
    if nprocs > 1:
        os.environ["PADDLE_TPU_COORDINATOR"] = coordinator
    func(*args)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Reference: spawn.py — start ``nprocs`` Python processes running
    ``func(*args)`` with the distributed env wired as the launcher wires
    it (``PADDLE_TPU_COORDINATOR`` on a free local port,
    ``PADDLE_TPU_NUM_PROCESSES``, ``PADDLE_TPU_PROCESS_ID`` and Paddle's
    ``PADDLE_TRAINER_*``), so ``init_parallel_env`` forms their group.
    ``nprocs`` <= 0 takes one a card (one at least)."""
    import multiprocessing as mp
    if nprocs <= 0:
        nprocs = max(1, torch.cuda.device_count())
    coordinator = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_entry,
                        args=(rank, nprocs, coordinator, func, args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"spawn: worker exit codes {bad}")
    return procs


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """Reference: parallel_with_gloo.py — CPU bootstrap membership over
    the port's TCP store (the reference uses a Gloo HTTP store)."""
    from .tcp_store import TCPStore
    from . import env as _env
    host, port = server_endpoint.rsplit(":", 1)
    _env._global_store = TCPStore(host, int(port),
                                  is_master=(rank_id == 0),
                                  world_size=rank_num)
    _env._gloo_world = rank_num
    _env._gloo_rank = rank_id


def gloo_barrier():
    """Store-backed CPU barrier; its key comes from the flight recorder's
    per-group sequence, scoped by incarnation
    (``flight_recorder.store_scope()``), so a relaunched incarnation never
    meets the previous one's keys."""
    from . import env as _env
    st = getattr(_env, "_global_store", None)
    if st is None:
        raise RuntimeError("call gloo_init_parallel_env first")
    n = getattr(_env, "_gloo_world", 1)
    seq = _fr.next_group_seq("gloo_barrier")
    rec = _fr.record_issue("gloo_barrier", group="gloo",
                           extra={"gloo_seq": seq})
    st.barrier(f"{_fr.store_scope()}/gloo_barrier/{seq}", n)
    _fr.record_complete(rec)


def gloo_release():
    from . import env as _env
    _env._global_store = None
    _fr.reset_seqs("gloo_barrier")  # the next gloo env starts afresh


# -- TP split helper ------------------------------------------------------

def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Reference: collective.split — build a model-parallel linear or
    embedding whose weight is partitioned over the model-parallel group
    (``fleet.init``'s), and return its output for ``x``: ``axis=1`` a
    column-parallel linear (gathered when ``gather_out``), ``axis=0`` a
    row-parallel one over the whole input, or a vocab-parallel
    embedding."""
    from . import fleet
    if operation == "linear":
        in_f, out_f = size
        if axis == 1:
            layer = fleet.ColumnParallelLinear(in_f, out_f,
                                               gather_output=gather_out)
        else:
            layer = fleet.RowParallelLinear(in_f, out_f,
                                            input_is_parallel=False)
        return layer(x)
    if operation == "embedding":
        n_emb, dim = size
        layer = fleet.VocabParallelEmbedding(n_emb, dim)
        return layer(x)
    raise ValueError(f"split supports 'linear'/'embedding', got "
                     f"{operation!r}")
