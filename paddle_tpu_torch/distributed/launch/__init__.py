"""paddle_tpu_torch.distributed.launch — the training launcher, after
``paddle_tpu/distributed/launch`` (reference:
python/paddle/distributed/launch, launch/main.py:20). Failed workers are
relaunched up to ``--max_restarts``; a graceful preemption (exit 75) is
resumed without consuming it; ``--np MIN:MAX`` turns a lost worker into
a scale event, and ``--nnodes MIN:MAX`` makes this process the
coordinator of per-node agents (:mod:`.node_agent`). See :mod:`.main`.
"""
from .main import launch, main  # noqa: F401
