"""paddle_tpu_torch.distributed — the parts ported so far, after
``paddle_tpu/distributed/__init__.py``: the process group
(``init_parallel_env`` over gloo, ``world_mesh``), the eager collectives
(``collective``, ``comm_extra``, ``stream``: each rank's own tensor), the
hybrid topology (``topology``: ``build_mesh``, ``CommunicateTopology``,
``HybridCommunicateGroup``, ``FailureDomainMap``), ``fleet`` (its
tensor-parallel layers and activation recomputation), ``DataParallel``,
the resilient-training control plane (fault injection, checkpoint lineage
and the sharded checkpoint, the resumable loop, the integrity guard, the
TCP store, the flight recorder, the step watchdog), the elastic control
plane (the membership registry, the launcher's ``--np`` and ``--nnodes``
paths, the node agents) and the fault-tolerant distributed linear algebra
(``dlinalg``).
"""
from . import fault, fleet  # noqa: F401
from .fault import (  # noqa: F401
    Backoff, CheckpointLineage, EXIT_DESYNC, EXIT_FAULT, EXIT_HANG,
    EXIT_ORACLE, EXIT_PREEMPT, EXIT_WATCHDOG, describe_exit,
    exit_preempted, install_preemption_handler, maybe_inject, preempted,
    preemption_scope, retry, set_fault_spec,
)
from . import checkpoint  # noqa: F401
from .checkpoint import (  # noqa: F401
    AsyncSaveHandle, CheckpointCorruptError, load_state_dict,
    save_state_dict, verify_checkpoint,
)
from . import keyspace  # noqa: F401
from . import flight_recorder  # noqa: F401
from .flight_recorder import (  # noqa: F401
    CollectiveDesyncError, FlightRecorder,
)
from .tcp_store import (  # noqa: F401
    FailoverStore, LogShipper, StoreCandidatesExhausted,
    StoreConnectionRefused, StoreFencedError,
    StoreTimeoutError, TCPStore, Watchdog,
)
from .watchdog import (  # noqa: F401
    start_step_watchdog, stop_step_watchdog, get_step_watchdog,
)
from . import integrity  # noqa: F401
from .resumable import ResumableTraining  # noqa: F401
from .env import (  # noqa: F401
    get_rank, get_world_size, init_parallel_env, is_initialized, world_mesh,
)
from . import collective, comm_extra, stream  # noqa: F401
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_reduce, all_to_all, barrier, broadcast,
    destroy_process_group, get_group, new_group, reduce, reduce_scatter,
    scatter,
)
from .comm_extra import (  # noqa: F401
    ParallelEnv, ParallelMode, all_gather_object, alltoall, alltoall_single,
    broadcast_object_list, gather, get_backend, gloo_barrier,
    gloo_init_parallel_env, gloo_release, irecv, is_available, isend, recv,
    scatter_object_list, send, spawn, split, wait,
)
from .parallel import DataParallel, shard_batch  # noqa: F401
from .elastic import (  # noqa: F401
    ElasticManager, ElasticStatus, NodeRegistry, QuarantineList,
    render_node_round, worker_from_env,
)
from .topology import (  # noqa: F401
    CommunicateTopology, FailureDomainMap, HybridCommunicateGroup,
    build_mesh, get_hybrid_communicate_group,
)
from . import dlinalg  # noqa: F401
from . import launch  # noqa: F401
