"""paddle_tpu_torch.distributed — the parts ported so far: ``fleet``'s
activation recomputation, the resilient-training control plane (fault
injection, checkpoint lineage and the sharded checkpoint, the resumable
loop, the integrity guard, the TCP store, the flight recorder, the step
watchdog), the elastic control plane (the membership registry, the
launcher's ``--np`` and ``--nnodes`` paths, the node agents), the
process group (``init_parallel_env`` over gloo), ``DataParallel``,
``topology.FailureDomainMap`` and the
fault-tolerant distributed linear algebra (``dlinalg``), after
``paddle_tpu/distributed/__init__.py``.
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
    get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .parallel import DataParallel, shard_batch  # noqa: F401
from .elastic import (  # noqa: F401
    ElasticManager, ElasticStatus, NodeRegistry, QuarantineList,
    render_node_round, worker_from_env,
)
from .topology import FailureDomainMap  # noqa: F401
from . import dlinalg  # noqa: F401
from . import launch  # noqa: F401
