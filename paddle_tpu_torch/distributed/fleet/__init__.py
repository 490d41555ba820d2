"""``fleet`` of the port, after ``paddle_tpu/distributed/fleet/__init__.py``:
the hybrid topology's front door (``DistributedStrategy``, ``init``,
``get_hybrid_communicate_group``, ``distributed_model``), the
tensor-parallel layers (``mp_layers``) and activation recomputation.

Reference: python/paddle/distributed/fleet/__init__.py (fleet.init:167,
distributed_model fleet/model.py:32, DistributedStrategy
fleet/base/distributed_strategy.py). The hybrid optimizers
(``HybridParallelOptimizer``, ``HybridParallelClipGrad``,
``distributed_optimizer``), sharding, pipeline and sequence parallelism
are not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from ..topology import HybridCommunicateGroup, _set_hcg, \
    get_hybrid_communicate_group
from . import mp_layers  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from .recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["DistributedStrategy", "init", "is_initialized",
           "distributed_model", "get_hybrid_communicate_group",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "recompute",
           "recompute_sequential"]


class DistributedStrategy:
    """Reference: fleet/base/distributed_strategy.py (proto-backed knobs).
    Holds the hybrid degrees + common toggles as plain attributes."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False
        # the data-parallel communication knobs (DataParallel raises for
        # the overlap and quantized transport until overlap.py is ported)
        self.dp_comm_overlap = False
        self.dp_comm_quant = None          # None/"off" | "int8" | "bf16"
        self.comm_buffer_size = 25         # MB per grad bucket
        self.last_comm_buffer_size = 1     # MB cap on the final bucket


_fleet_initialized = False
_strategy: DistributedStrategy | None = None


def init(role_maker=None, is_collective=True, strategy=None, log_level="INFO"):
    """Reference: fleet/fleet.py:167 — the process group
    (``init_parallel_env``) and the hybrid topology's mesh over it. Every
    rank calls it."""
    global _fleet_initialized, _strategy
    from ..env import init_parallel_env
    init_parallel_env()
    _strategy = strategy or DistributedStrategy()
    hcg = HybridCommunicateGroup(strategy=_strategy)
    _set_hcg(hcg)
    _fleet_initialized = True
    return hcg


def is_initialized():
    return _fleet_initialized


def distributed_model(model):
    """Reference: fleet/model.py:32. With model (or pipeline) parallelism
    the layers already hold their shards and make their collectives, so
    the model is returned as it is; pure data parallelism wraps it in
    ``DataParallel`` over the data-parallel group with the strategy's
    bucket sizes."""
    hcg = get_hybrid_communicate_group()
    if hcg.get_model_parallel_world_size() == 1 and \
            hcg.get_pipe_parallel_world_size() == 1:
        from ..parallel import DataParallel
        s = _strategy
        kw = {}
        if s is not None:
            kw = dict(comm_buffer_size=s.comm_buffer_size,
                      last_comm_buffer_size=s.last_comm_buffer_size)
        return DataParallel(
            model, strategy=s,
            group=hcg.get_data_parallel_group().process_group, **kw)
    return model
