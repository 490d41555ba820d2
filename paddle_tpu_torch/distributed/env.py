"""Distributed environment bootstrap: the port's
``paddle_tpu/distributed/env.py:22-117`` over ``torch.distributed``.

Reference: python/paddle/distributed/parallel.py:943 (init_parallel_env)
— launcher env vars -> store -> process group. The launcher exports
``PADDLE_TPU_COORDINATOR`` (the rendezvous ``host:port``, set when the
world has more than one process), ``PADDLE_TPU_NUM_PROCESSES`` and
``PADDLE_TPU_PROCESS_ID``; :func:`init_parallel_env` turns them into
torch's default process group with the **gloo** backend, on the CPU and
on the card alike: NCCL cannot put two ranks of one communicator on one
GPU, and the port's multi-rank jobs share the one card.

As in JAX, an elastic worker registers with the launcher's membership
registry and starts its heartbeat *before* the group init (and not under
a node agent, whose record is node-scoped), and the group init is retried
with backoff (``fault.retry``): a relaunch can meet a rendezvous port
that is still draining from the previous incarnation. The group has a
finite ``timeout`` (``_PG_TIMEOUT_S``, 120 s): a
peer SIGKILLed mid-all-reduce turns into an error, and so into an exit
the launcher sees, not into a half-hour hang.

The world is the processes, one rank each: :func:`get_world_size` is
the process group's size (1 before or without one), where JAX's counts
the devices of its mesh. :func:`world_mesh` is torch's ``DeviceMesh``
over those processes, its one dim named ``world``
(``topology.build_mesh`` gives the 5-dim one). ``get_rank`` and
``get_world_size`` take a ``group``: a :class:`~.collective.Group` or a
torch process group.
"""
from __future__ import annotations

import os
import sys
from datetime import timedelta

__all__ = ["init_parallel_env", "is_initialized", "get_world_size",
           "get_rank", "world_mesh"]

_initialized = False
_world_mesh = None
# the process group's timeout: a collective whose peer died raises after
# this long instead of gloo's default half hour
_PG_TIMEOUT_S = 120


def init_parallel_env():
    """Reference: paddle.distributed.init_parallel_env (parallel.py:943).
    Returns the default process group (None in a one-process job)."""
    global _initialized
    if _initialized:
        return _default_group()
    if os.environ.get("PADDLE_TPU_ELASTIC_JOB_ID") \
            and not os.environ.get("PADDLE_TPU_NODE_AGENT"):
        from .elastic import worker_from_env
        try:
            worker_from_env()
        except Exception as e:
            print(f"[elastic] worker registration failed: {e}",
                  file=sys.stderr, flush=True)
    coord = os.environ.get("PADDLE_TPU_COORDINATOR")
    if coord:
        import torch.distributed as dist
        from . import fault as _fault
        world = int(os.environ.get("PADDLE_TPU_NUM_PROCESSES", 1))
        rank = int(os.environ.get("PADDLE_TPU_PROCESS_ID", 0))
        timeout = timedelta(seconds=_PG_TIMEOUT_S)

        def _init_once():
            try:
                dist.init_process_group(
                    "gloo", init_method=f"tcp://{coord}",
                    world_size=world, rank=rank, timeout=timeout)
            except Exception:
                # a failed rendezvous may leave a half-built group: tear
                # it down so the retry really reconnects
                if dist.is_initialized():
                    dist.destroy_process_group()
                raise

        if not dist.is_initialized():
            _fault.retry(
                _init_once,
                retry_on=(RuntimeError, OSError, ConnectionError),
                attempts=int(os.environ.get("PADDLE_TPU_INIT_RETRIES",
                                            "4")),
                base=0.5, cap=8.0,
                deadline=float(os.environ.get(
                    "PADDLE_TPU_INIT_DEADLINE", "120")))
    _initialized = True
    return _default_group()


def is_initialized() -> bool:
    return _initialized


def _group_ready():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def world_mesh():
    """The world's ``DeviceMesh``: one dim named ``world`` over every rank
    (a one-rank group in a one-process job, ``topology.py``)."""
    global _world_mesh
    if _world_mesh is None:
        from torch.distributed.device_mesh import init_device_mesh
        from .topology import MESH_DEVICE, ensure_world_group
        world = ensure_world_group()
        _world_mesh = init_device_mesh(MESH_DEVICE, (world,),
                                       mesh_dim_names=("world",))
    return _world_mesh


def _torch_group(group):
    """A port :class:`~.collective.Group`'s process group, or ``group``
    itself (a torch process group)."""
    return getattr(group, "process_group", group)


def get_world_size(group=None) -> int:
    if group is not None and hasattr(group, "nranks"):
        return group.nranks
    if group is not None:
        import torch.distributed as dist
        return dist.get_world_size(group)
    if _group_ready():
        import torch.distributed as dist
        return dist.get_world_size()
    return 1


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (the world by default); 0 without
    a process group, as JAX's ``process_index`` is in one process."""
    if _group_ready():
        import torch.distributed as dist
        return dist.get_rank(_torch_group(group)) if group is not None \
            else dist.get_rank()
    return 0


def _default_group():
    if _group_ready():
        import torch.distributed as dist
        return dist.group.WORLD
    return None
