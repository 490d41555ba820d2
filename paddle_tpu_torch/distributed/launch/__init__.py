"""paddle_tpu_torch.distributed.launch — the single-host training
launcher, after ``paddle_tpu/distributed/launch`` (reference:
python/paddle/distributed/launch, launch/main.py:20). Failed workers are
relaunched up to ``--max_restarts``; a graceful preemption (exit 75) is
resumed without consuming it. See :mod:`.main`.
"""
from .main import launch, main  # noqa: F401
