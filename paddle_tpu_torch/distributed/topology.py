"""Hybrid-parallel topology over the job's ranks, after
``paddle_tpu/distributed/topology.py``.

A rank is a process (``env.py``): the port's mesh is torch's own
``DeviceMesh`` over the processes of the default process group, its dims
named as JAX's ``_AXES`` (data, pipe, sharding, sep, model; model
innermost, so the ranks of one model-parallel group are neighbours). Each
dim carries a process group of the default group's backend (gloo), which
moves CPU and CUDA tensors alike, so the mesh is built with device type
``cpu``: a ``cuda`` mesh would pick a card per rank, where the port's
ranks share one. :func:`mesh_degree` and :func:`mesh_rank` answer what
JAX's code reads off its ``Mesh`` (``mesh.shape.get(axis, 1)``, a
device's coordinate).

A one-process job has no process group (``init_parallel_env`` makes none
without a coordinator); building a mesh then starts a one-rank gloo group
over an in-process store, so the same code runs at world 1.

:class:`FailureDomainMap` is the node <-> failure-domain metadata the
elastic coordinator logs with.
"""
from __future__ import annotations

from datetime import timedelta

import numpy as np

from .collective import Group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "build_mesh",
           "FailureDomainMap", "get_hybrid_communicate_group",
           "mesh_degree", "mesh_rank"]

_AXES = ["data", "pipe", "sharding", "sep", "model"]
# the device type the port's meshes are built with (see the docstring)
MESH_DEVICE = "cpu"


def ensure_world_group():
    """The default process group: the launcher's (``init_parallel_env``),
    else a one-rank gloo group over an in-process store -> world size."""
    import torch.distributed as dist
    from . import env
    env.init_parallel_env()
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.HashStore(), rank=0, world_size=1,
            timeout=timedelta(seconds=env._PG_TIMEOUT_S))
    return dist.get_world_size()


def mesh_degree(mesh, axis) -> int:
    """JAX's ``mesh.shape.get(axis, 1)`` for a ``DeviceMesh``: the size of
    the dim named ``axis``, 1 when the mesh has no such dim (or is
    None)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))


def mesh_rank(mesh, axis) -> int:
    """This rank's coordinate on ``axis`` of ``mesh`` (0 when the mesh has
    no such dim)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        return 0
    return int(mesh.get_local_rank(axis))


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, devices=None):
    """The 5-dim ``DeviceMesh`` over the ranks ``devices`` (default: every
    rank of the world). The product of the degrees must equal their
    count. Every rank of the world builds it, in the same order: each dim
    is a process group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    world = ensure_world_group()
    ranks = list(range(world)) if devices is None \
        else [int(r) for r in devices]
    total = dp * pp * sharding * sep * mp
    assert total == len(ranks), (
        f"product of parallel degrees {total} != rank count {len(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        dp, pp, sharding, sep, mp)
    return DeviceMesh(MESH_DEVICE, grid, mesh_dim_names=tuple(_AXES))


class CommunicateTopology:
    """Reference: fleet/base/topology.py:61 — rank <-> coordinate tables
    (pure Python, no process group)."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = hybrid_group_names or list(_AXES)
        self._dims = dims or [1] * len(self._parallel_names)
        shape = tuple(self._dims)
        self._world_size = int(np.prod(shape))
        self._coords = {}
        for rank, coord in enumerate(np.ndindex(shape)):
            self._coords[rank] = coord

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._parallel_names)
        for rank, c in self._coords.items():
            if c == coord:
                return rank
        raise ValueError(f"no rank at coordinate {kwargs}")

    def get_coord(self, rank):
        return self._coords[rank]

    def get_axis_list(self, axis_name, index):
        """Ranks whose coordinate on axis_name equals index."""
        ax = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._coords.items() if c[ax] == index)

    def get_comm_list(self, axis_name):
        """List of rank-groups along axis_name (reference semantics)."""
        ax = self._parallel_names.index(axis_name)
        groups = {}
        for rank, coord in self._coords.items():
            key = coord[:ax] + coord[ax + 1:]
            groups.setdefault(key, []).append(rank)
        return [sorted(v) for _, v in sorted(groups.items())]


class HybridCommunicateGroup:
    """Reference: fleet/base/topology.py:174. Holds the 5-dim mesh over the
    job's ranks and hands out a :class:`~.collective.Group` per axis; the
    ranks and degrees are this process's coordinates on the mesh. The
    data-parallel degree fills what the others leave of the world, as in
    JAX."""

    def __init__(self, strategy=None, dp=1, pp=1, sharding=1, sep=1, mp=1):
        import torch.distributed as dist
        if strategy is not None:
            cfg = strategy.hybrid_configs
            dp = cfg.get("dp_degree", 1)
            pp = cfg.get("pp_degree", 1)
            sharding = cfg.get("sharding_degree", 1)
            sep = cfg.get("sep_degree", 1)
            mp = cfg.get("mp_degree", 1)
        n = ensure_world_group()
        known = pp * sharding * sep * mp
        if dp * known != n and n % known == 0:
            dp = n // known  # reference behavior: dp fills the remainder
        self._dp_degree, self._pp_degree = dp, pp
        self._sharding_degree, self._sep_degree, self._mp_degree = \
            sharding, sep, mp
        self.mesh = build_mesh(dp, pp, sharding, sep, mp)
        self.topology = CommunicateTopology(list(_AXES),
                                            [dp, pp, sharding, sep, mp])
        self.global_rank = dist.get_rank()
        self._groups = {}

    # -- degrees --
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # -- ranks: this process's coordinates on the mesh --
    def get_data_parallel_rank(self):
        return mesh_rank(self.mesh, "data")

    def get_model_parallel_rank(self):
        return mesh_rank(self.mesh, "model")

    def get_sharding_parallel_rank(self):
        return mesh_rank(self.mesh, "sharding")

    def get_sep_parallel_rank(self):
        return mesh_rank(self.mesh, "sep")

    def get_stage_id(self):
        return mesh_rank(self.mesh, "pipe")

    # -- groups: one per axis, kept (a Group wraps the mesh dim's process
    # group; it makes no new one) --
    def _group(self, axis):
        if axis not in self._groups:
            self._groups[axis] = Group(self.mesh, axis)
        return self._groups[axis]

    def get_data_parallel_group(self):
        return self._group("data")

    def get_model_parallel_group(self):
        return self._group("model")

    def get_pipe_parallel_group(self):
        return self._group("pipe")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_check_parallel_group(self, *a, **k):
        return self._group("model")

    def get_data_parallel_group_src_rank(self):
        return 0

    def get_model_parallel_group_src_rank(self):
        return 0

    def topology_description(self):
        return (f"HybridCommunicateGroup(dp={self._dp_degree}, "
                f"pp={self._pp_degree}, sharding={self._sharding_degree}, "
                f"sep={self._sep_degree}, mp={self._mp_degree})")

    __repr__ = topology_description


class FailureDomainMap:
    """Node <-> failure-domain metadata for multi-node jobs.

    Each node is one island of cards (losing the node loses them all at
    once) and nodes are grouped ``dcn_group`` at a time into network
    domains: the hosts behind one data-center link or switch, the blast
    radius of a link flap. The elastic coordinator logs the lost node's
    domains and its correlated peers on every node-loss event. Pure
    metadata, so the launcher can build it before any worker exists."""

    def __init__(self, nodes, dcn_group=2):
        self._nodes = list(nodes)
        self._dcn_group = max(1, int(dcn_group))

    @property
    def nodes(self):
        return list(self._nodes)

    def ici_domain(self, node) -> int:
        return self._nodes.index(node)

    def dcn_domain(self, node) -> int:
        return self._nodes.index(node) // self._dcn_group

    def nodes_in_dcn(self, domain) -> list:
        lo = int(domain) * self._dcn_group
        return self._nodes[lo:lo + self._dcn_group]

    def correlated(self, node) -> list:
        """Peers expected to fail together with ``node`` (same link)."""
        return [n for n in self.nodes_in_dcn(self.dcn_domain(node))
                if n != node]

    def describe(self, node) -> str:
        peers = self.correlated(node)
        tail = (f"; shares a DCN link with {', '.join(peers)}"
                if peers else "")
        return (f"{node}: ici_domain={self.ici_domain(node)} "
                f"dcn_domain={self.dcn_domain(node)}{tail}")


_hcg: HybridCommunicateGroup | None = None


def _set_hcg(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    """The topology ``fleet.init`` built, else a default one (every rank
    data-parallel, model-parallel degree 1)."""
    global _hcg
    if _hcg is None:
        _hcg = HybridCommunicateGroup()
    return _hcg
